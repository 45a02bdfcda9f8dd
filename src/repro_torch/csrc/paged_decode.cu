// Batched ragged flash-decode over the paged KV pool, for Hopper (sm_90a): K2.
//
// Replaces the Pallas TPU kernel src/repro/kernels/paged_flash_decode.py::
// paged_flash_decode_partial: one launch per instance per layer per decode
// iteration attends the instance's pool storage in place through
// per-request block tables and emits the UNNORMALIZED partial (o, m, l) that
// the multi-master combine LSE-merges across instances.
//
// What it computes: for request b and q head hh, over local tokens
// j < lengths[b] (slot = block_table[b, j / P] * P + j % P), the scores
// q . k[slot] * scale (tanh softcap), masked by
//     query_pos[b] - page_pos[slot] < window   (windowed configs only),
// folded into an online softmax with the reference's conventions (masked
// scores -1e30, m_safe = max(m, -1e29), m = -inf and l = 0 for an empty
// row: a zero-length request gives exactly the empty partial).
//
// Design.  One CTA per (request, KV head); the q_per_kv q heads of that KV
// head are its rows, so each K/V slot is read once for the whole GQA group.
// The CTA walks only the request's valid tokens, 64 slots per iteration: the
// block-table lookups for a tile are done once into shared memory (entries
// past lengths[b] are never read), and the tile's K and V rows are gathered
// from their scattered slots with coalesced loads along D.  That matters at
// the engine's default page_size = 1, where every "page" is one slot and a
// page-at-a-time walk (the TPU grid's shape) would issue one tiny transfer
// per token.  Scores are warp-reduced per row; the output accumulator lives
// in shared memory, so any q_per_kv <= 64 and head size <= 256 fit one body.
// q and the pool may each be f32 or bf16 (the engine's pool mirror is f32,
// the model's q bf16); everything accumulates in f32.
//
// Bound on this card: bytes.  Each valid KV slot is read once (2 * len * KVH
// * D * sizeof(kv) over the batch) against 4 * q_per_kv * D FLOPs per slot
// and KV head — far below the ~295 FLOP/byte ridge.  The kernel keeps every
// slot's bytes to one read; splitting long contexts across several CTAs
// (split-K) so that a small batch still fills all 132 SMs is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBK = 64;  // slots per tile
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename TQ, typename TKV>
__global__ void __launch_bounds__(kThreads) paged_decode_kernel(
    const TQ* __restrict__ q, const TKV* __restrict__ kp,
    const TKV* __restrict__ vp, const int* __restrict__ table,
    const int* __restrict__ lengths, const int* __restrict__ page_pos,
    const int* __restrict__ query_pos, float* __restrict__ o,
    float* __restrict__ m_out, float* __restrict__ l_out, int h, int kvh,
    int d, int page_size, int max_pages, int window, float softcap,
    float scale) {
  const int b = blockIdx.x, g = blockIdx.y, tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int qpk = h / kvh;
  const int ks = d + 1;  // padded K row stride: conflict-free score loop
  extern __shared__ float smem[];
  float* sq = smem;                  // [qpk][d]
  float* sk = sq + qpk * d;          // [kBK][ks]
  float* sv = sk + kBK * ks;         // [kBK][d]
  float* sp = sv + kBK * d;          // [qpk][kBK]
  float* acc = sp + qpk * kBK;       // [qpk][d]
  float* s_m = acc + qpk * d;        // [qpk]
  float* s_l = s_m + qpk;            // [qpk]
  float* s_alpha = s_l + qpk;        // [qpk]
  int* s_slot = reinterpret_cast<int*>(s_alpha + qpk);  // [kBK]
  int* s_ok = s_slot + kBK;                             // [kBK]

  const int len = lengths[b];
  const int qp = query_pos != nullptr ? query_pos[b] : 0;
  for (int idx = tid; idx < qpk * d; idx += kThreads) {
    const int r = idx / d, dd = idx % d;
    sq[idx] = to_f32(q[((size_t)b * h + g * qpk + r) * d + dd]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < qpk; r += kThreads) {
    s_m[r] = __int_as_float(0xff800000);  // -inf
    s_l[r] = 0.f;
  }

  for (int j0 = 0; j0 < len; j0 += kBK) {
    const int nv = min(kBK, len - j0);
    __syncthreads();  // previous tile fully consumed
    for (int c = tid; c < kBK; c += kThreads) {
      int slot = 0, ok = 0;
      if (c < nv) {
        const int j = j0 + c;
        slot = table[(size_t)b * max_pages + j / page_size] * page_size +
               j % page_size;
        ok = 1;
        if (window > 0) ok = (qp - page_pos[slot]) < window;
      }
      s_slot[c] = slot;
      s_ok[c] = ok;
    }
    __syncthreads();
#pragma unroll 4
    for (int idx = tid; idx < nv * d; idx += kThreads) {
      const int c = idx / d, dd = idx % d;
      const size_t off = ((size_t)s_slot[c] * kvh + g) * d + dd;
      sk[c * ks + dd] = to_f32(kp[off]);
      sv[c * d + dd] = to_f32(vp[off]);
    }
    __syncthreads();
    for (int p = tid; p < qpk * kBK; p += kThreads) {
      const int r = p / kBK, c = p % kBK;
      float s = kNegInf;
      if (c < nv && s_ok[c]) {
        float dot = 0.f;
        for (int dd = 0; dd < d; ++dd)
          dot = fmaf(sq[r * d + dd], sk[c * ks + dd], dot);
        s = dot * scale;
        if (softcap > 0.f) s = softcap * tanhf(s / softcap);
      }
      sp[r * kBK + c] = s;
    }
    __syncthreads();
    for (int r = warp; r < qpk; r += kWarps) {  // one warp per row
      float m_blk = kNegInf;
      for (int c = lane; c < kBK; c += 32) m_blk = fmaxf(m_blk, sp[r * kBK + c]);
#pragma unroll
      for (int w = 16; w > 0; w >>= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, w));
      const float m_prev = s_m[r];
      const float m_new = fmaxf(m_prev, m_blk);
      const float m_safe = fmaxf(m_new, -1e29f);
      float rsum = 0.f;
      for (int c = lane; c < kBK; c += 32) {
        const bool ok = c < nv && s_ok[c];
        const float p = ok ? expf(sp[r * kBK + c] - m_safe) : 0.f;
        sp[r * kBK + c] = p;
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
      for (int c = 0; c < nv; ++c) a = fmaf(sp[r * kBK + c], sv[c * d + dd], a);
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
    m_out[(size_t)b * h + g * qpk + r] =
        mm <= kNegInf / 2 ? __int_as_float(0xff800000) : mm;
    l_out[(size_t)b * h + g * qpk + r] = s_l[r];
  }
}

template <typename TQ, typename TKV>
int launch(const void* q, const void* kp, const void* vp, const int* table,
           const int* lengths, const int* page_pos, const int* query_pos,
           float* o, float* m, float* l, int b, int h, int kvh, int d,
           int page_size, int max_pages, int window, float softcap,
           float scale, cudaStream_t stream) {
  const int qpk = h / kvh;
  const size_t floats = (size_t)qpk * d * 2 + (size_t)kBK * (d + 1) +
                        (size_t)kBK * d + (size_t)qpk * kBK + 3 * (size_t)qpk;
  const size_t smem = floats * sizeof(float) + 2 * kBK * sizeof(int);
  auto kern = paged_decode_kernel<TQ, TKV>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid(b, kvh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const TQ*>(q), static_cast<const TKV*>(kp),
      static_cast<const TKV*>(vp), table, lengths, page_pos, query_pos, o, m,
      l, h, kvh, d, page_size, max_pages, window, softcap, scale);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// q [b, h, d] (one query token per request), k_pages/v_pages
// [n_pages, page_size, kvh, d] contiguous, block_table [b, max_pages],
// lengths [b], page_pos [n_pages * page_size] and query_pos [b] (int32; both
// may be null when window <= 0).  q_dtype / kv_dtype: 0 = float32,
// 1 = bfloat16.  Writes o [b, h, d], m and l [b, h] (float32).  Requires
// h % kvh == 0, h / kvh <= 64, d <= 256 and max_pages >= 1.  Returns the
// launch's cudaError_t.
int repro_paged_decode(const void* q, const void* k_pages, const void* v_pages,
                       const int* block_table, const int* lengths,
                       const int* page_pos, const int* query_pos, float* o,
                       float* m, float* l, int b, int h, int kvh, int d,
                       int page_size, int max_pages, int q_dtype, int kv_dtype,
                       int window, float softcap, float scale, void* stream) {
  if (h % kvh != 0 || h / kvh > 64 || d > 256 || max_pages < 1 || b < 1)
    return (int)cudaErrorInvalidValue;
  if (window > 0 && (page_pos == nullptr || query_pos == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
#define REPRO_LAUNCH(TQ, TKV)                                               \
  return launch<TQ, TKV>(q, k_pages, v_pages, block_table, lengths,        \
                         page_pos, query_pos, o, m, l, b, h, kvh, d,        \
                         page_size, max_pages, window, softcap, scale, s)
  if (q_dtype == 0 && kv_dtype == 0) REPRO_LAUNCH(float, float);
  if (q_dtype == 1 && kv_dtype == 0) REPRO_LAUNCH(__nv_bfloat16, float);
  if (q_dtype == 0 && kv_dtype == 1) REPRO_LAUNCH(float, __nv_bfloat16);
  if (q_dtype == 1 && kv_dtype == 1) REPRO_LAUNCH(__nv_bfloat16, __nv_bfloat16);
#undef REPRO_LAUNCH
  return (int)cudaErrorInvalidValue;
}

const char* repro_paged_decode_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
