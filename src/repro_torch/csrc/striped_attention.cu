// Position-masked flash attention for Hopper (sm_90a): K4.
//
// Replaces the Pallas TPU kernel src/repro/kernels/striped_attention.py::
// striped_flash_attention.  In the port it is the attention of every serial
// prefill (`DefaultAttnImpl.prefill_attn`, the path of the moe and hybrid
// families): one launch per attention layer per request.
//
// What it computes: for batch row b, q head hh and query row i, the
// normalized softmax attention over the keys j of the same batch row that
// pass the position mask
//     (causal:  q_pos[i] >= k_pos[j])  &  (window:  q_pos[i] - k_pos[j] < window),
// with the tanh softcap on the scaled scores and GQA by kv head hh / q_per_kv.
// Positions may come in any order (striped layouts), Sq and Sk may differ and
// need not be multiples of any tile.  The online softmax keeps the
// reference's conventions: masked scores are -1e30, exp() is taken against
// m_safe = max(m, -1e29), and a row with no key (l == 0) outputs zeros.
//
// Design.  One CTA per (q tile, KV head, batch row); its rows (192 on the
// bf16 route at head size 128, 128 at other sizes, 64 on the f32 route) are
// the q_per_kv q heads of that KV head for consecutive query tokens, so GQA
// shares every K/V tile across the group (mixtral's q_per_kv = 4 gives 48
// tokens x 4 heads on the bf16 route).  Because positions can be in any
// order, tile skipping works from ranges: the CTA knows the min / max
// position of its queries; a key tile is skipped when every key lies after
// every query (causal) or outside every query's window.  For contiguous
// positions that skips the upper triangle and everything beyond the window.
// The operand type picks the body:
//   * bf16 (what serving runs): the tensor-core core of attn_tc.cuh (wgmma,
//     64-key tiles in a cp.async ring).  Before it runs, each warp of the CTA
//     marks 64-key tiles in two bitmaps: live (some key can meet some query
//     of the CTA) and inner (every key exists and meets every query, so no
//     per-element mask).  The CTAs start with the longest q tiles of every
//     KV head.  The output is rounded to bf16 once, in the epilogue, or
//     written in f32 (the output-type template OT) for the ESP ring step,
//     whose partials are merged in f32 as the reference merges them.
//   * f32 (the parity route of the f32 token checks; tensor cores would round
//     f32 operands to TF32): plain fp32 FMAs on 32-key shared-memory tiles
//     (4 x 4 score and 4 x D/8 output register blocks per thread), head-size
//     templates DP in {32, 64, 96, 128, 256}, masked per element; warp 0
//     reduces each tile's min / max key position for the skip test.
//
// Bound on this card: 4 * H * D * (attended pairs) FLOPs against one read of
// q, k, v and one write of o.  A serial prompt of a few thousand tokens is
// far above the H100's ~295 FLOP/byte ridge, so operations bind (989
// TFLOP/s bf16 on the tensor cores; the f32 route's FMAs reach a few
// percent of it).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit: at mixtral width (S 6144, window 4096, GQA 4, D 128) the bf16
// route takes 1.18 ms (233 TFLOP/s, 24 % of its 0.278 ms bound; SDPA with a
// boolean window mask 1.92 ms), the f32 route 15.7 ms; at zamba2 width (S
// 4096, causal, D 80) 0.43 ms (SDPA is_causal 0.29 ms).  Copying each K/V
// tile from L2 into every CTA of its KV head, not the products or the
// softmax, sets the bf16 route's time.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tc.cuh"
#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;
namespace tc = repro::tc;

constexpr int kRows = 64;  // (q token, q head) rows per CTA
constexpr int kBK = 32;    // keys per tile
constexpr int kThreads = 128;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) striped_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    T* __restrict__ o, float* __restrict__ lse, int sq, int sk, int h, int kvh,
    int d, int qpk, int bq, int causal, int window, float softcap, float scale) {
  constexpr int QS = DP + 1;  // padded row stride: conflict-free columns
  constexpr int PS = kBK + 1;
  constexpr int NC = DP / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* s_q = smem;                 // [kRows][QS]
  float* s_k = s_q + kRows * QS;     // [kBK][QS]
  float* s_v = s_k + kBK * QS;       // [kBK][DP]
  float* s_p = s_v + kBK * DP;       // [kRows][PS]
  int* s_qpos = reinterpret_cast<int*>(s_p + kRows * PS);  // [kRows]
  int* s_kpos = s_qpos + kRows;                            // [kBK]
  int* s_range = s_kpos + kBK;  // q min, q max, tile k min, tile k max

  const int tid = threadIdx.x;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int t0 = blockIdx.x * bq;
  const int nq = min(bq, sq - t0);  // query tokens of this tile
  const T* qb = q + (size_t)b * sq * h * d;
  const T* kb = k + (size_t)b * sk * kvh * d;
  const T* vb = v + (size_t)b * sk * kvh * d;
  T* ob = o + (size_t)b * sq * h * d;

  for (int r = tid; r < kRows; r += kThreads) {
    const int i = r / qpk;
    s_qpos[r] = i < nq ? q_pos[t0 + i] : 0;
  }
  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, dd = idx % DP;
    const int i = r / qpk;
    float val = 0.f;
    if (i < nq && dd < d)
      val = to_f32(qb[((size_t)(t0 + i) * h + g * qpk + r % qpk) * d + dd]);
    s_q[r * QS + dd] = val;
  }
  if (tid < 32) {  // position range of this tile's queries
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = tid; i < nq; i += 32) {
      const int p = q_pos[t0 + i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
    if (tid == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  __syncthreads();
  const long long q_lo = s_range[0], q_hi = s_range[1];

  // thread tile: rows rg*4 + i (i < 4); score columns cg + 8*j (j < 4);
  // output columns cg + 8*jj (jj < NC).  The 8 threads of a row group are
  // 8 consecutive lanes, so row reductions are xor-shuffles over 1, 2, 4.
  const int rg = tid / 8, cg = tid % 8;
  float o_acc[4][NC];
  float m_row[4], l_row[4];
  bool row_on[4];
  int row_pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    row_on[i] = r / qpk < nq;
    row_pos[i] = s_qpos[r];
    m_row[i] = repro::neg_inf();
    l_row[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) o_acc[i][jj] = 0.f;
  }

  for (int kt = 0; kt < sk; kt += kBK) {
    const int nk = min(kBK, sk - kt);
    __syncthreads();  // the previous tile is fully consumed
    if (tid < 32) {
      const int p = tid < nk ? k_pos[kt + tid] : 0;
      s_kpos[tid] = p;
      const int lo = repro::warp_min(tid < nk ? p : INT_MAX);
      const int hi = repro::warp_max(tid < nk ? p : INT_MIN);
      if (tid == 0) {
        s_range[2] = lo;
        s_range[3] = hi;
      }
    }
    __syncthreads();
    const long long k_lo = s_range[2], k_hi = s_range[3];
    if (causal && q_hi < k_lo) continue;  // every key after every query
    if (window > 0 && q_lo - k_hi >= window) continue;  // outside every window

    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, dd = idx % DP;
      float kv = 0.f, vv = 0.f;
      if (c < nk && dd < d) {
        const size_t off = ((size_t)(kt + c) * kvh + g) * d + dd;
        kv = to_f32(kb[off]);
        vv = to_f32(vb[off]);
      }
      s_k[c * QS + dd] = kv;
      s_v[c * DP + dd] = vv;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
    for (int dd = 0; dd < d; ++dd) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = s_q[(rg * 4 + i) * QS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = s_k[(cg + 8 * j) * QS + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool msk[4];
      float m_blk = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = cg + 8 * j;
        const int kp = s_kpos[c];
        bool ok = row_on[i] && c < nk;
        if (causal) ok = ok && row_pos[i] >= kp;
        if (window > 0) ok = ok && (long long)row_pos[i] - kp < window;
        msk[j] = ok;
        float x = s[i][j] * scale;
        if (softcap > 0.f) x = softcap * tanhf(x / softcap);
        s[i][j] = ok ? x : kNegInf;
        m_blk = fmaxf(m_blk, s[i][j]);
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        m_blk = fmaxf(m_blk, __shfl_xor_sync(0xffffffffu, m_blk, w));
      const float m_prev = m_row[i];
      const float m_new = fmaxf(m_prev, m_blk);
      const float m_safe = fmaxf(m_new, -1e29f);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = msk[j] ? expf(s[i][j] - m_safe) : 0.f;
        rsum += p;
        s_p[(rg * 4 + i) * PS + cg + 8 * j] = p;
      }
#pragma unroll
      for (int w = 1; w < 8; w <<= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, w);
      const float alpha = m_prev <= kNegInf / 2 ? 0.f : expf(m_prev - m_safe);
      l_row[i] = alpha * l_row[i] + rsum;
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) o_acc[i][jj] *= alpha;
      m_row[i] = m_blk <= kNegInf / 2 ? m_prev : m_new;
    }
    __syncthreads();

    for (int c = 0; c < nk; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = s_p[(rg * 4 + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float vv = s_v[c * DP + cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o_acc[i][jj] = fmaf(pv[i], vv, o_acc[i][jj]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (!row_on[i]) continue;
    const int r = rg * 4 + i;
    const size_t row = (size_t)(t0 + r / qpk) * h + g * qpk + r % qpk;
    const float denom = l_row[i] != 0.f ? l_row[i] : 1.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 8 * jj;
      if (col < d) repro::store(&ob[row * d + col], o_acc[i][jj] / denom);
    }
    if (lse != nullptr && cg == 0)  // every lane of the row group holds m, l
      lse[((size_t)b * h + g * qpk + r % qpk) * sq + t0 + r / qpk] =
          repro::row_lse(m_row[i], l_row[i]);
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* o, float* lse, int b, int sq, int sk, int h, int kvh,
           int d, int causal, int window, float softcap, float scale,
           cudaStream_t stream) {
  const int qpk = h / kvh;
  const int bq = kRows / qpk;
  const size_t floats = (size_t)kRows * (DP + 1) + (size_t)kBK * (DP + 1) +
                        (size_t)kBK * DP + (size_t)kRows * (kBK + 1);
  const size_t ints = (size_t)kRows + kBK + 4;
  const size_t smem = floats * sizeof(float) + ints * sizeof(int);
  auto kern = striped_attention_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + bq - 1) / bq, kvh, b);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(o), lse, sq, sk,
      h, kvh, d, qpk, bq, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16: the tensor-core core

// The position mask for tc::attend: tiles are visited from the CTA's
// bitmaps, word w of both in bits[w] (x, live: some key may meet some query;
// y, inner: every key exists and meets every query).
struct PositionMask {
  const int* k_pos;
  const uint2* bits;
  int sk, n_tiles, causal, window;
  int qpos[2];
  bool on[2];

  struct Key {
    int pos;
    bool valid;
  };

  __device__ int next(int kt) const {
    for (int t = kt / tc::kBK + 1; t < n_tiles;) {
      const uint32_t w = bits[t >> 5].x >> (t & 31);
      if (w) return (t + __ffs(w) - 1) * tc::kBK;
      t = (t | 31) + 1;
    }
    return -1;
  }
  __device__ bool interior(int kt) const {
    const int t = kt / tc::kBK;
    return (bits[t >> 5].y >> (t & 31)) & 1u;
  }
  __device__ Key key(int j) const {
    return j < sk ? Key{__ldg(k_pos + j), true} : Key{0, false};
  }
  __device__ bool ok(int slot, Key kk) const {
    bool ok = on[slot] && kk.valid;
    if (causal) ok = ok && qpos[slot] >= kk.pos;
    if (window > 0) ok = ok && (long long)qpos[slot] - kk.pos < window;
    return ok;
  }
};

template <int DP, typename OT>
__global__ void __launch_bounds__(tc::Cta<DP>::kThreads, tc::Cta<DP>::kMinBlocks)
    striped_attention_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, OT* __restrict__ o,
    float* __restrict__ lse, int sq, int sk, int h, int kvh, int d, int qpk,
    int bq, int causal, int window, float softcap, float scale) {
  constexpr int kThreads = tc::Cta<DP>::kThreads;
  // dynamic shared memory: the core's tiles, then the visit bitmaps, one
  // bit per 64-key tile of each, interleaved by 32-bit word
  extern __shared__ __align__(128) char tc_smem[];
  const int n_tiles = (sk + tc::kBK - 1) / tc::kBK;
  uint2* s_bits = reinterpret_cast<uint2*>(tc_smem + tc::Smem<DP>::kBytes);
  __shared__ int s_range[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // launch order: every KV head's q tile before the next q tile, the
  // longest rows first under a causal mask, so long tiles do not form the tail
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int g = lin % kvh;
  const int tile = causal ? gridDim.x - 1 - lin / kvh : lin / kvh;
  const int b = blockIdx.z;
  const int t0 = tile * bq;
  const int nq = min(bq, sq - t0);
  const __nv_bfloat16* qb = q + (size_t)b * sq * h * d;
  const __nv_bfloat16* kb = k + (size_t)b * sk * kvh * d + (size_t)g * d;
  const __nv_bfloat16* vb = v + (size_t)b * sk * kvh * d + (size_t)g * d;
  OT* ob = o + (size_t)b * sq * h * d;

  if (warp == 0) {  // position range of this tile's queries
    int lo = INT_MAX, hi = INT_MIN;
    for (int i = lane; i < nq; i += 32) {
      const int p = q_pos[t0 + i];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
    if (lane == 0) {
      s_range[0] = lo;
      s_range[1] = hi;
    }
  }
  for (int i = tid; i < (n_tiles + 31) / 32; i += kThreads) s_bits[i] = make_uint2(0u, 0u);
  __syncthreads();
  const long long q_lo = s_range[0], q_hi = s_range[1];
  // visit bitmaps: one warp per tile, two keys per lane (unrolled so that
  // the position loads of four tiles are in flight together)
#pragma unroll 4
  for (int t = warp; t < n_tiles; t += kThreads / 32) {
    bool live = false;
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int e = 0; e < tc::kBK; e += 32) {
      const int j = t * tc::kBK + e + lane;
      if (j < sk) {
        const int p = k_pos[j];
        lo = min(lo, p);
        hi = max(hi, p);
        live |= (!causal || p <= q_hi) && (window <= 0 || q_lo - p < window);
      }
    }
    live = __any_sync(0xffffffffu, live);
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
    if (lane == 0 && live) {
      const uint32_t bit = 1u << (t & 31);
      atomicOr(&s_bits[t >> 5].x, bit);
      const bool inner = (t + 1) * tc::kBK <= sk && (!causal || q_lo >= hi) &&
                         (window <= 0 || q_hi - lo < window);
      if (inner) atomicOr(&s_bits[t >> 5].y, bit);
    }
  }
  __syncthreads();

  PositionMask mask{k_pos, s_bits, sk, n_tiles, causal, window,
                    {0, 0}, {false, false}};
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int r = tc::frag_row(sl);
    mask.on[sl] = r < bq * qpk && r / qpk < nq;
    mask.qpos[sl] = mask.on[sl] ? q_pos[t0 + r / qpk] : 0;
  }
  auto q_src = [&](int r) -> const __nv_bfloat16* {
    return r < bq * qpk && r / qpk < nq
               ? qb + ((size_t)(t0 + r / qpk) * h + g * qpk + r % qpk) * d
               : nullptr;
  };
  tc::Acc<DP> acc;
  acc.clear();
  tc::attend<DP>(tc_smem, q_src, kb, vb, (long long)kvh * d, sk, d, scale,
                 softcap, mask, acc);

  float inv[2];  // 1 / l, or 1 for a row without keys (o = 0)
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) inv[sl] = acc.l[sl] != 0.f ? 1.f / acc.l[sl] : 1.f;
  if (lse != nullptr && (tid & 3) == 0) {  // the four lanes of a quad share m, l
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int r = tc::frag_row(sl);
      if (mask.on[sl])
        lse[((size_t)b * h + g * qpk + r % qpk) * sq + t0 + r / qpk] =
            repro::row_lse(acc.m[sl], acc.l[sl]);
    }
  }
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc.o[i] *= inv[(i >> 1) & 1];
  tc::store_rows<DP>(acc.o, [&](int r, int col, float4 x) {
    if (r >= bq * qpk || r / qpk >= nq || col >= d) return;
    const size_t row = (size_t)(t0 + r / qpk) * h + g * qpk + r % qpk;
    if constexpr (std::is_same_v<OT, float>) {  // the f32 accumulator as it is
      *reinterpret_cast<float4*>(ob + row * d + col) = x;
    } else {
      uint2 w;
      w.x = tc::pack_bf16(x.x, x.y);
      w.y = tc::pack_bf16(x.z, x.w);
      *reinterpret_cast<uint2*>(ob + row * d + col) = w;
    }
  });
}

template <int DP, typename OT>
int launch_tc(const void* q, const void* k, const void* v, const int* q_pos,
              const int* k_pos, void* o, float* lse, int b, int sq, int sk, int h, int kvh,
              int d, int causal, int window, float softcap, float scale,
              cudaStream_t stream) {
  const int qpk = h / kvh;
  const int bq = tc::Cta<DP>::kRows / qpk;
  const long long n_words = ((sk + tc::kBK - 1) / tc::kBK + 31) / 32;
  const long long smem = tc::Smem<DP>::kBytes + n_words * sizeof(uint2);
  if (smem > INT_MAX) return (int)cudaErrorInvalidValue;
  auto kern = striped_attention_tc_kernel<DP, OT>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((sq + bq - 1) / bq, kvh, b);
  constexpr int threads = tc::Cta<DP>::kThreads;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_pos, k_pos,
      static_cast<OT*>(o), lse, sq, sk, h, kvh, d, qpk, bq, causal,
      window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T, typename OT = T>
int dispatch_d(const void* q, const void* k, const void* v, const int* q_pos,
               const int* k_pos, void* o, float* lse, int b, int sq, int sk, int h,
               int kvh, int d, int causal, int window, float softcap,
               float scale, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // tensor cores
    if (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o) & 15)
      return (int)cudaErrorMisalignedAddress;
#define REPRO_LAUNCH(DP)                                                       \
  return launch_tc<DP, OT>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, kvh, d, \
                           causal, window, softcap, scale, s)
    switch (tc::head_template(d)) {
      case 64: REPRO_LAUNCH(64);
      case 80: REPRO_LAUNCH(80);
      case 128: REPRO_LAUNCH(128);
      default: REPRO_LAUNCH(256);
    }
#undef REPRO_LAUNCH
  } else {  // f32: the fp32-FMA body
#define REPRO_LAUNCH(DP)                                                   \
  return launch<T, DP>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, kvh, d, \
                       causal, window, softcap, scale, s)
    if (d <= 32) REPRO_LAUNCH(32);
    if (d <= 64) REPRO_LAUNCH(64);
    if (d <= 96) REPRO_LAUNCH(96);
    if (d <= 128) REPRO_LAUNCH(128);
    REPRO_LAUNCH(256);
#undef REPRO_LAUNCH
  }
}

}  // namespace

extern "C" {

// q [b, sq, h, d], k / v [b, sk, kvh, d] and o [b, sq, h, d], contiguous,
// all of one dtype (0 = float32, 1 = bfloat16), except that o_f32 != 0 with
// bfloat16 operands writes o in float32: the normalized accumulator before
// any rounding (the ESP ring step's partial); lse, when not null, f32
// [b, h, sq]: each row's m + log l (+inf for a row with no key), the saved
// statistic of the backward (striped_attention_bwd.cu); q_pos [sq] and k_pos [sk]
// int32 in any order.  causal != 0 masks q_pos < k_pos; window <= 0 and
// softcap <= 0 disable those masks.  Requires d % 8 == 0, d <= 256,
// h % kvh == 0, h / kvh <= 64, b <= 65535 and sq, sk >= 1; for bfloat16 also
// 16-byte-aligned q, k, v and o, and two bits per 64 keys in the CTA's shared
// memory beside the tiles (sk up to about nine million).  Returns the
// launch's cudaError_t.
int repro_striped_attention(const void* q, const void* k, const void* v,
                            const int* q_pos, const int* k_pos, void* o,
                            float* lse, int b,
                            int sq, int sk, int h, int kvh, int d, int dtype,
                            int o_f32, int causal, int window, float softcap,
                            float scale, void* stream) {
  if (d % 8 != 0 || d > 256 || d < 8 || kvh < 1 || h % kvh != 0 ||
      h / kvh > kRows || b < 1 || b > 65535 || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk, h, kvh,
                             d, causal, window, softcap, scale, s);
  if (dtype == 1 && o_f32)
    return dispatch_d<__nv_bfloat16, float>(q, k, v, q_pos, k_pos, o, lse, b, sq,
                                            sk, h, kvh, d, causal, window,
                                            softcap, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, lse, b, sq, sk,
                                     h, kvh, d, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_striped_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
