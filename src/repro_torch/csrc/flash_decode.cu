// Flash-decode partial over one dense KV shard, for Hopper (sm_90a): K5.
//
// Replaces the Pallas TPU kernel src/repro/kernels/flash_decode.py::
// flash_decode_partial (LoongServe's Flash-Decoding with the extra ESP
// parameters: the shard's global offset and each request's valid length).
// In the port it computes the history partial of every serial decode step
// (`DefaultAttnImpl.decode_attn`, the path of the moe and hybrid families):
// one launch per attention layer per request, B = 1.
//
// What it computes: for request b and q head hh, over the shard's keys j
// (global position kpos = k_pos_offset + j) with
//     kpos < lengths[b]   (&  kpos > lengths[b] - window,  windowed configs),
// the scores q . k[b, j] * scale (tanh softcap), folded into an online
// softmax with the reference's conventions (m_safe = max(m, -1e29); an empty
// row gives m = -inf, l = 0, o = 0).  The output is the UNNORMALIZED partial
// (o, m, l) in f32, merged with the new token's own partial by the caller.
//
// Design.  This is K2's loop (csrc/paged_decode.cu) with identity addressing:
// slot (b, j) lives at row b * S + j of the dense shard, so no block table is
// read.  One CTA per (request, KV head); the q_per_kv q heads of that KV head
// are its rows, so each K/V row is read once for the whole GQA group.  The
// valid keys form one contiguous range, [max(0, len - window + 1 - offset),
// min(S, len - offset)), so the CTA walks exactly that range, 64 keys per
// tile, with coalesced loads along D: it never reads past lengths[b] - offset
// or past S (a shard of a longer cache), and under a window it reads only the
// window.  Scores are one thread per (row, key); the output accumulator lives
// in shared memory, so any q_per_kv <= 64 and head size <= 256 (80 for
// zamba2) fit one body.  q and KV may each be f32 or bf16.
//
// Bound on this card: bytes.  Each valid KV row is read once (2 * len * KVH
// * D * sizeof(kv)), against 4 * q_per_kv * D FLOPs per key and KV head —
// far below the ~295 FLOP/byte ridge.  On the serial path B = 1, so a launch
// has only KVH CTAs (8 for mixtral, 32 for zamba2) on 132 SMs, each walking
// the whole context alone: the kernel cannot come near the bandwidth bound
// that way.  Splitting the context across CTAs (split-K) with a merge of the
// per-split partials is the later step that attacks it.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;

constexpr int kBK = 64;  // keys per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) flash_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ k,
    const TKV* __restrict__ v, const int* __restrict__ lengths,
    float* __restrict__ o, float* __restrict__ m_out,
    float* __restrict__ l_out, int s, int h, int kvh, int d, int offset,
    int window, float softcap, float scale) {
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int qpk = h / kvh;
  const int ks = d + 1;  // padded K row stride: conflict-free score loop
  extern __shared__ float smem[];
  float* s_q = smem;                 // [qpk][d]
  float* s_k = s_q + qpk * d;        // [kBK][ks]
  float* s_v = s_k + kBK * ks;       // [kBK][d]
  float* s_p = s_v + kBK * d;        // [qpk][kBK]
  float* acc = s_p + qpk * kBK;      // [qpk][d]
  float* s_m = acc + qpk * d;        // [qpk]
  float* s_l = s_m + qpk;            // [qpk]
  float* s_alpha = s_l + qpk;        // [qpk]

  // the valid keys of this request in shard coordinates: [j_lo, j_hi)
  const long long len = lengths[b];
  const int j_hi = (int)max(0LL, min((long long)s, len - offset));
  const int j_lo =
      window > 0 ? (int)min((long long)j_hi, max(0LL, len - window + 1 - offset)) : 0;
  const TKV* kb = k + (size_t)b * s * kvh * d;
  const TKV* vb = v + (size_t)b * s * kvh * d;

  for (int idx = tid; idx < qpk * d; idx += kThreads) {
    const int r = idx / d, dd = idx % d;
    s_q[idx] = to_f32(q[((size_t)b * h + g * qpk + r) * d + dd]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < qpk; r += kThreads) {
    s_m[r] = repro::neg_inf();
    s_l[r] = 0.f;
  }

  for (int j0 = j_lo; j0 < j_hi; j0 += kBK) {
    const int nv = min(kBK, j_hi - j0);
    __syncthreads();  // previous tile fully consumed
#pragma unroll 4
    for (int idx = tid; idx < nv * d; idx += kThreads) {
      const int c = idx / d, dd = idx % d;
      const size_t off = ((size_t)(j0 + c) * kvh + g) * d + dd;
      s_k[c * ks + dd] = to_f32(kb[off]);
      s_v[c * d + dd] = to_f32(vb[off]);
    }
    __syncthreads();
    for (int p = tid; p < qpk * kBK; p += kThreads) {
      const int r = p / kBK, c = p % kBK;
      float sc = kNegInf;
      if (c < nv) {
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd)
          dot = fmaf(s_q[r * d + dd], s_k[c * ks + dd], dot);
        sc = dot * scale;
        if (softcap > 0.f) sc = softcap * tanhf(sc / softcap);
      }
      s_p[r * kBK + c] = sc;
    }
    __syncthreads();
    for (int r = warp; r < qpk; r += kWarps) {  // one warp per row
      float m_blk = kNegInf;
      for (int c = lane; c < kBK; c += 32) m_blk = fmaxf(m_blk, s_p[r * kBK + c]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, w));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, m_blk);
      const float m_safe = fmaxf(m_new, -1e29f);
      float rsum = 0.f;
      for (int c = lane; c < kBK; c += 32) {
        const float p = c < nv ? expf(s_p[r * kBK + c] - m_safe) : 0.f;
        s_p[r * kBK + c] = p;
        rsum += p;
      }
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      if (lane == 0) {
        const float alpha = m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
        s_alpha[r] = alpha;
        s_l[r] = alpha * s_l[r] + rsum;
        s_m[r] = m_blk <= kNegInf / 2 ? m_prev : m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < qpk * d; idx += kThreads) {
      const int r = idx / d, dd = idx % d;
      float a = acc[idx] * s_alpha[r];
      for (int c = 0; c < nv; ++c) a = fmaf(s_p[r * kBK + c], s_v[c * d + dd], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < qpk * d; idx += kThreads) {
    const int r = idx / d, dd = idx % d;
    o[((size_t)b * h + g * qpk + r) * d + dd] = acc[idx];
  }
  for (int r = tid; r < qpk; r += kThreads) {
    const float mm = s_m[r];
    m_out[(size_t)b * h + g * qpk + r] = mm <= kNegInf / 2 ? repro::neg_inf() : mm;
    l_out[(size_t)b * h + g * qpk + r] = s_l[r];
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* k, const void* v, const int* lengths,
           float* o, float* m, float* l, int b, int s, int h, int kvh, int d,
           int offset, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int qpk = h / kvh;
  const size_t floats = (size_t)qpk * d * 2 + (size_t)kBK * (d + 1) +
                        (size_t)kBK * d + (size_t)qpk * kBK + 3 * (size_t)qpk;
  const size_t smem = floats * sizeof(float);
  auto kern = flash_decode_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(k),
      static_cast<const TKV*>(v), lengths, o, m, l, s, h, kvh, d, offset,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, h, d] (one query token per request), k / v [b, s, kvh, d]
// contiguous, lengths [b] int32 (global valid cache length per request),
// offset = the global position of the shard's first key.  q_dtype /
// kv_dtype: 0 = float32, 1 = bfloat16.  Writes o [b, h, d], m and l [b, h]
// (float32).  window <= 0 and softcap <= 0 disable those masks.  Requires
// h % kvh == 0, h / kvh <= 64, d % 8 == 0, d <= 256 and b, s >= 1.  Returns
// the launch's cudaError_t.
int repro_flash_decode(const void* q, const void* k, const void* v,
                       const int* lengths, float* o, float* m, float* l, int b,
                       int s, int h, int kvh, int d, int offset, int q_dtype,
                       int kv_dtype, int window, float softcap, float scale,
                       void* stream) {
  if (kvh < 1 || h % kvh != 0 || h / kvh > 64 || d % 8 != 0 || d < 8 ||
      d > 256 || b < 1 || s < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                                 \
  return launch<TQ, TKV>(q, k, v, lengths, o, m, l, b, s, h, kvh, d, offset, \
                         window, softcap, scale, st)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 0 && kv_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* repro_flash_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
