// Packed ragged causal flash prefill for Hopper (sm_90a): K1 and K3.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/paged_flash_prefill.py:
//   * packed_flash_prefill            (K1: one launch per layer per DoP=1
//                                      prefill batch, normalized output)
//   * packed_flash_prefill_ring_chunk (K3: one launch per instance per ring
//                                      step of a DoP>1 striped ring, carrying
//                                      the unnormalized (o, m, l) flash state)
// K1 is K3 with n_shards = 1, no carry and a final o / l, so both run this
// one kernel body.
//
// What it computes: the q rows of a packed token axis [Tl, H, D] attend the
// keys of one KV chunk [Tl, KVH, D] under the mask
//     same segment  &  gq >= gk  (&  gq - gk < window),
// where segment ids come from per-shard offsets [B+1] (trailing repeats are
// empty segments; tokens past offsets[B] form their own padding segment) and
// gq = jq * n + q_shard, gk = jk * n + k_shard are global striped positions.
// Scores get the tanh softcap; the online softmax keeps the reference's
// conventions: masked scores are -1e30, m = -inf and l = 0 for empty rows,
// and exp() is taken against m_safe = max(m, -1e29).
//
// Design.  One CTA per (q tile, KV head).  Its rows (192 on the bf16 route
// at head size 128, 128 at other sizes, 64 on the f32 route) are the
// q_per_kv q heads of that KV head for consecutive tokens, so GQA shares
// every K/V tile across the group (glm4's q_per_kv = 16 gives 12 tokens x
// 16 heads on the bf16 route).  Tile pairs that cannot interact are never
// visited: the CTA derives from the offsets the exact key range its rows
// can reach.  The operand type picks the body:
//   * bf16 (what serving runs): the tensor-core core of attn_tc.cuh (wgmma,
//     64-key tiles in a cp.async ring).  Each row's mask is one key interval
//     [lo, hi) of the chunk — its segment's keys, cut by the causal reach
//     and raised by the window reach on global striped positions — so the
//     per-element mask is two compares, and a tile inside every row's
//     interval skips it.  The CTAs start with the last (longest) q tiles of
//     every KV head.  K3 loads the carried (o, m, l) into the accumulators;
//     o is written with 16-byte stores from the accumulator fragment.
//   * f32 (the parity route of the f32 token checks; tensor cores would round
//     f32 operands to TF32): plain fp32 FMA on 32-key shared-memory tiles
//     (4 x 4 score and 4 x D/8 output register blocks per thread), segment
//     ids per key and ragged edges masked per element.
//
// Bound on this card: the work is 4 * H * D * sum_b len_b (len_b + 1) / 2
// FLOPs against one read of q, k, v and one write of the f32 o (plus the
// carry for K3).  Long segments put it above the H100's ~295 FLOP/byte
// ridge (operations bind); a packed batch of prompts up to ~2k tokens sits
// just below it (bytes bind by a small margin).
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at a 700 W power
// limit, over one 8192-token bucket of 11 prompts (H = KVH = 32, D 128):
// K1's bf16 route 0.55 ms (149 TFLOP/s; the bound is 0.100 ms of bytes;
// SDPA with a block-diagonal mask 3.4 ms), its f32 route 6.1 ms; K3 0.15 ms
// per launch of the DoP-4 ring, which includes the wrapper's upload of the
// two offset arrays.  As in K4, the K/V tile copies set the bf16 time.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tc.cuh"

namespace {

constexpr int kRows = 64;     // (q token, q head) rows per CTA
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;
namespace tc = repro::tc;

__device__ __forceinline__ float to_f32(float x) { return x; }

// number of off[1..n_seqs] <= j (offsets are non-decreasing)
__device__ __forceinline__ int seg_of(const int* off, int n_seqs, int j) {
  int lo = 0, hi = n_seqs;
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (off[mid + 1] <= j) lo = mid + 1; else hi = mid;
  }
  return lo;
}

__device__ __forceinline__ int floor_div(int a, int b) {
  return a >= 0 ? a / b : -((-a + b - 1) / b);
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) flash_prefill_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_off, const int* __restrict__ k_off, int n_seqs,
    const float* __restrict__ o_in, const float* __restrict__ m_in,
    const float* __restrict__ l_in, float* __restrict__ o_out,
    float* __restrict__ m_out, float* __restrict__ l_out,
    int tl, int h, int kvh, int d, int qpk, int bq,
    int q_shard, int k_shard, int n_shards, int window, float softcap,
    float scale, int normalize) {
  constexpr int QS = DP + 1;  // padded row stride: conflict-free columns
  constexpr int PS = kBK + 1;
  constexpr int NC = DP / 8;  // output columns per thread
  extern __shared__ float smem[];
  float* sq = smem;                 // [kRows][QS]
  float* sk = sq + kRows * QS;      // [kBK][QS]
  float* sv = sk + kBK * QS;        // [kBK][DP]
  float* sp = sv + kBK * DP;        // [kRows][PS]
  int* s_qoff = reinterpret_cast<int*>(sp + kRows * PS);  // [n_seqs + 1]
  int* s_koff = s_qoff + (n_seqs + 1);                     // [n_seqs + 1]
  int* s_qseg = s_koff + (n_seqs + 1);                     // [kRows]
  int* s_qpos = s_qseg + kRows;                            // [kRows]
  int* s_kseg = s_qpos + kRows;                            // [kBK]
  int* s_kpos = s_kseg + kBK;                              // [kBK]
  int* s_range = s_kpos + kBK;                             // [2]

  const int tid = threadIdx.x;
  const int tile = blockIdx.x;
  const int g = blockIdx.y;
  const int t0 = tile * bq;
  const int n = n_shards;

  for (int i = tid; i <= n_seqs; i += kThreads) {
    s_qoff[i] = q_off[i];
    s_koff[i] = k_off[i];
  }
  __syncthreads();
  for (int r = tid; r < kRows; r += kThreads) {
    const int t = t0 + r / qpk;
    const bool active = r < bq * qpk && t < tl;
    s_qseg[r] = active ? seg_of(s_qoff, n_seqs, t) : -1;
    s_qpos[r] = t * n + q_shard;
  }
  for (int idx = tid; idx < kRows * DP; idx += kThreads) {
    const int r = idx / DP, dd = idx % DP;
    const int t = t0 + r / qpk;
    float val = 0.f;
    if (r < bq * qpk && t < tl && dd < d)
      val = to_f32(q[((size_t)t * h + g * qpk + r % qpk) * d + dd]);
    sq[r * QS + dd] = val;
  }
  if (tid == 0) {
    // exact reachable key range of this q tile (local indices of the chunk)
    const int t1 = min(t0 + bq, tl) - 1;
    const int seg0 = seg_of(s_qoff, n_seqs, t0);
    const int seg1 = seg_of(s_qoff, n_seqs, t1);
    const int kend = seg1 < n_seqs ? s_koff[seg1 + 1] : tl;
    int k_hi = min(kend, tl);
    k_hi = min(k_hi, floor_div(t1 * n + q_shard - k_shard, n) + 1);  // causal
    int k_lo = max(s_koff[seg0], 0);
    if (window > 0)
      k_lo = max(k_lo, floor_div(t0 * n + q_shard - window - k_shard, n) + 1);
    s_range[0] = k_lo;
    s_range[1] = k_hi;
  }
  __syncthreads();

  // thread tile: rows rg*4 + i (i < 4); score columns cg + 8*j (j < 4);
  // output columns cg + 8*jj (jj < NC).  The 8 threads of a row group are
  // 8 consecutive lanes, so row reductions are xor-shuffles over 1, 2, 4.
  const int rg = tid / 8, cg = tid % 8;
  float o_acc[4][NC];
  float m_row[4], l_row[4];
  int row_seg[4], row_pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    row_seg[i] = s_qseg[r];
    row_pos[i] = s_qpos[r];
    const int t = t0 + r / qpk;
    const size_t row = (size_t)t * h + g * qpk + r % qpk;
    const bool load = o_in != nullptr && row_seg[i] >= 0;
    m_row[i] = load ? m_in[row] : __int_as_float(0xff800000);  // -inf
    l_row[i] = load ? l_in[row] : 0.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 8 * jj;
      o_acc[i][jj] = (load && col < d) ? o_in[row * d + col] : 0.f;
    }
  }

  const int k_lo = s_range[0], k_hi = s_range[1];
  for (int kt = (k_lo / kBK) * kBK; kt < k_hi; kt += kBK) {
    for (int idx = tid; idx < kBK * DP; idx += kThreads) {
      const int c = idx / DP, dd = idx % DP;
      const int jk = kt + c;
      float kv = 0.f, vv = 0.f;
      if (jk < tl && dd < d) {
        const size_t off = ((size_t)jk * kvh + g) * d + dd;
        kv = to_f32(k[off]);
        vv = to_f32(v[off]);
      }
      sk[c * QS + dd] = kv;
      sv[c * DP + dd] = vv;
    }
    for (int c = tid; c < kBK; c += kThreads) {
      const int jk = kt + c;
      s_kseg[c] = jk < tl ? seg_of(s_koff, n_seqs, jk) : -2;
      s_kpos[c] = jk * n + k_shard;
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
      for (int i = 0; i < 4; ++i) qv[i] = sq[(rg * 4 + i) * QS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sk[(cg + 8 * j) * QS + dd];
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
        const int gk = s_kpos[c];
        bool ok = row_seg[i] >= 0 && s_kseg[c] == row_seg[i] && row_pos[i] >= gk;
        if (window > 0) ok = ok && (row_pos[i] - gk) < window;
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
        sp[(rg * 4 + i) * PS + cg + 8 * j] = p;
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

    for (int c = 0; c < kBK; ++c) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sp[(rg * 4 + i) * PS + c];
#pragma unroll
      for (int jj = 0; jj < NC; ++jj) {
        const float vv = sv[c * DP + cg + 8 * jj];
#pragma unroll
        for (int i = 0; i < 4; ++i) o_acc[i][jj] = fmaf(pv[i], vv, o_acc[i][jj]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (row_seg[i] < 0) continue;
    const int r = rg * 4 + i;
    const int t = t0 + r / qpk;
    const size_t row = (size_t)t * h + g * qpk + r % qpk;
    const float denom = (normalize && l_row[i] != 0.f) ? l_row[i] : 1.f;
#pragma unroll
    for (int jj = 0; jj < NC; ++jj) {
      const int col = cg + 8 * jj;
      if (col < d) o_out[row * d + col] = o_acc[i][jj] / denom;
    }
    if (!normalize && cg == 0) {
      m_out[row] = m_row[i];
      l_out[row] = l_row[i];
    }
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* q_off,
           const int* k_off, int n_seqs, const float* o_in, const float* m_in,
           const float* l_in, float* o_out, float* m_out, float* l_out, int tl,
           int h, int kvh, int d, int q_shard, int k_shard, int n_shards,
           int window, float softcap, float scale, int normalize,
           cudaStream_t stream) {
  const int qpk = h / kvh;
  const int bq = kRows / qpk;
  const size_t floats = (size_t)kRows * (DP + 1) + (size_t)kBK * (DP + 1) +
                        (size_t)kBK * DP + (size_t)kRows * (kBK + 1);
  const size_t ints = 2 * (size_t)(n_seqs + 1) + 2 * kRows + 2 * kBK + 2;
  const size_t smem = floats * sizeof(float) + ints * sizeof(int);
  auto kern = flash_prefill_kernel<T, DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tl + bq - 1) / bq, kvh);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), q_off, k_off, n_seqs, o_in, m_in, l_in, o_out,
      m_out, l_out, tl, h, kvh, d, qpk, bq, q_shard, k_shard, n_shards, window,
      softcap, scale, normalize);
  return (int)cudaGetLastError();
}

// ------------------------------------------------ bf16: the tensor-core core

// The segment mask for tc::attend.  Each row's mask is one key interval
// [lo, hi) of the chunk: its segment's keys, cut by the causal reach and
// raised by the window reach on global striped positions.
struct SegmentMask {
  int lo[2], hi[2];    // the thread's two rows
  int first, end;      // keys any row of the CTA reaches
  int in_lo, in_hi;    // a tile inside [in_lo, in_hi) needs no mask

  __device__ int next(int kt) const {
    const int n = kt < 0 ? (first / tc::kBK) * tc::kBK : kt + tc::kBK;
    return n < end ? n : -1;
  }
  __device__ bool interior(int kt) const { return kt >= in_lo && kt + tc::kBK <= in_hi; }
  __device__ int key(int j) const { return j; }
  __device__ bool ok(int slot, int j) const { return j >= lo[slot] && j < hi[slot]; }
};

template <int DP>
__global__ void __launch_bounds__(tc::Cta<DP>::kThreads, tc::Cta<DP>::kMinBlocks)
    flash_prefill_tc_kernel(
    const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
    const __nv_bfloat16* __restrict__ v, const int* __restrict__ q_off,
    const int* __restrict__ k_off, int n_seqs, const float* __restrict__ o_in,
    const float* __restrict__ m_in, const float* __restrict__ l_in,
    float* __restrict__ o_out, float* __restrict__ m_out,
    float* __restrict__ l_out, int tl, int h, int kvh, int d, int qpk, int bq,
    int q_shard, int k_shard, int n_shards, int window, float softcap,
    float scale, int normalize) {
  extern __shared__ __align__(128) char tc_smem[];
  constexpr int kWarps = tc::Cta<DP>::kThreads / 32;
  __shared__ int s_red[kWarps][4];
  const int tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  // launch order: every KV head's q tile before the next q tile, the later
  // (longer causal) rows first, so long tiles do not form the tail
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int g = lin % kvh;
  const int t0 = (gridDim.x - 1 - lin / kvh) * bq;
  const int n = n_shards;
  auto row_of = [&](int r) {  // global row (token * h + head), or -1
    const int t = t0 + r / qpk;
    return r < bq * qpk && t < tl ? t * h + g * qpk + r % qpk : -1;
  };

  SegmentMask mask;
  // per CTA: min lo / max hi over rows that reach a key, and max lo / min
  // hi over every active row
  int red[4] = {INT_MAX, INT_MIN, INT_MIN, INT_MAX};
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int r = tc::frag_row(sl);
    int lo = 0, hi = 0;
    if (row_of(r) >= 0) {
      const int t = t0 + r / qpk;
      const int seg = seg_of(q_off, n_seqs, t);
      const int gq = t * n + q_shard;
      lo = max(k_off[seg], 0);
      if (window > 0) lo = max(lo, floor_div(gq - window - k_shard, n) + 1);
      hi = min(seg < n_seqs ? k_off[seg + 1] : tl, tl);
      hi = min(hi, floor_div(gq - k_shard, n) + 1);
      red[2] = max(red[2], lo);
      red[3] = min(red[3], hi);
      if (lo < hi) {
        red[0] = min(red[0], lo);
        red[1] = max(red[1], hi);
      }
    }
    mask.lo[sl] = lo;
    mask.hi[sl] = hi;
  }
#pragma unroll
  for (int w = 1; w < 32; w <<= 1) {
    red[0] = min(red[0], __shfl_xor_sync(0xffffffffu, red[0], w));
    red[1] = max(red[1], __shfl_xor_sync(0xffffffffu, red[1], w));
    red[2] = max(red[2], __shfl_xor_sync(0xffffffffu, red[2], w));
    red[3] = min(red[3], __shfl_xor_sync(0xffffffffu, red[3], w));
  }
  if (lane == 0)
#pragma unroll
    for (int i = 0; i < 4; ++i) s_red[warp][i] = red[i];
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    red[0] = min(red[0], s_red[w][0]);
    red[1] = max(red[1], s_red[w][1]);
    red[2] = max(red[2], s_red[w][2]);
    red[3] = min(red[3], s_red[w][3]);
  }
  mask.first = red[0] < red[1] ? red[0] : 0;
  mask.end = red[0] < red[1] ? red[1] : 0;
  mask.in_lo = red[2];
  mask.in_hi = red[3];

  tc::Acc<DP> acc;
  acc.clear();
  if (o_in != nullptr) {  // the carried (o, m, l) of active rows
    const int c0 = 2 * (tid & 3);
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int row = row_of(tc::frag_row(sl));
      if (row < 0) continue;
      acc.m[sl] = m_in[row];
      acc.l[sl] = l_in[row];
#pragma unroll
      for (int j = 0; j < DP / 8; ++j) {
        if (8 * j >= d) continue;
        const float2 x = *reinterpret_cast<const float2*>(o_in + (size_t)row * d + 8 * j + c0);
        acc.o[4 * j + 2 * sl] = x.x;
        acc.o[4 * j + 2 * sl + 1] = x.y;
      }
    }
  }

  auto q_src = [&](int r) -> const __nv_bfloat16* {
    const int row = row_of(r);
    return row >= 0 ? q + (size_t)row * d : nullptr;
  };
  tc::attend<DP>(tc_smem, q_src, k + (size_t)g * d, v + (size_t)g * d,
                 (long long)kvh * d, tl, d, scale, softcap, mask, acc);

  if (normalize) {
    float inv[2];  // 1 / l, or 1 for a row without keys (o = 0)
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) inv[sl] = acc.l[sl] != 0.f ? 1.f / acc.l[sl] : 1.f;
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc.o[i] *= inv[(i >> 1) & 1];
  } else if ((tid & 3) == 0) {
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const int row = row_of(tc::frag_row(sl));
      if (row < 0) continue;
      m_out[row] = acc.m[sl];
      l_out[row] = acc.l[sl];
    }
  }
  tc::store_rows<DP>(acc.o, [&](int r, int col, float4 x) {
    const int row = row_of(r);
    if (row >= 0 && col < d)
      *reinterpret_cast<float4*>(o_out + (size_t)row * d + col) = x;
  });
}

template <int DP>
int launch_tc(const void* q, const void* k, const void* v, const int* q_off,
              const int* k_off, int n_seqs, const float* o_in,
              const float* m_in, const float* l_in, float* o_out,
              float* m_out, float* l_out, int tl, int h, int kvh, int d,
              int q_shard, int k_shard, int n_shards, int window,
              float softcap, float scale, int normalize, cudaStream_t stream) {
  const int qpk = h / kvh;
  const int bq = tc::Cta<DP>::kRows / qpk;
  const int smem = tc::Smem<DP>::kBytes;
  auto kern = flash_prefill_tc_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((tl + bq - 1) / bq, kvh);
  constexpr int threads = tc::Cta<DP>::kThreads;
  kern<<<grid, threads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), q_off, k_off, n_seqs, o_in, m_in,
      l_in, o_out, m_out, l_out, tl, h, kvh, d, qpk, bq, q_shard, k_shard,
      n_shards, window, softcap, scale, normalize);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* q_off, const int* k_off, int n_seqs,
               const float* o_in, const float* m_in, const float* l_in,
               float* o_out, float* m_out, float* l_out, int tl, int h,
               int kvh, int q_shard, int k_shard, int n_shards, int window,
               float softcap, float scale, int normalize, cudaStream_t s) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {  // tensor cores
    if (d % 8 != 0 ||
        (((uintptr_t)q | (uintptr_t)k | (uintptr_t)v | (uintptr_t)o_out |
          (uintptr_t)o_in) & 15))
      return d % 8 != 0 ? (int)cudaErrorInvalidValue
                        : (int)cudaErrorMisalignedAddress;
#define REPRO_LAUNCH(DP)                                                   \
  return launch_tc<DP>(q, k, v, q_off, k_off, n_seqs, o_in, m_in, l_in,  \
                       o_out, m_out, l_out, tl, h, kvh, d, q_shard,        \
                       k_shard, n_shards, window, softcap, scale,          \
                       normalize, s)
    switch (tc::head_template(d)) {
      case 64: REPRO_LAUNCH(64);
      case 80: REPRO_LAUNCH(80);
      case 128: REPRO_LAUNCH(128);
      default: REPRO_LAUNCH(256);
    }
#undef REPRO_LAUNCH
  } else {  // f32: the fp32-FMA body
#define REPRO_LAUNCH(DP)                                                   \
  return launch<T, DP>(q, k, v, q_off, k_off, n_seqs, o_in, m_in, l_in,  \
                       o_out, m_out, l_out, tl, h, kvh, d, q_shard,        \
                       k_shard, n_shards, window, softcap, scale,          \
                       normalize, s)
    if (d <= 32) REPRO_LAUNCH(32);
    if (d <= 64) REPRO_LAUNCH(64);
    if (d <= 128) REPRO_LAUNCH(128);
    REPRO_LAUNCH(256);
#undef REPRO_LAUNCH
  }
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16 (q, k and v share it).  o_in/m_in/l_in
// may be null (empty carry: m = -inf, l = 0).  normalize != 0 writes o / l
// and leaves m_out/l_out untouched (they may be null).  window <= 0 and
// softcap <= 0 disable those masks.  Requires d <= 256, h % kvh == 0,
// h / kvh <= 64 and contiguous [tl, h, d] / [tl, kvh, d] operands.
// Returns the launch's cudaError_t.
int repro_flash_prefill(const void* q, const void* k, const void* v,
                        const int* q_off, const int* k_off, int n_seqs,
                        const float* o_in, const float* m_in,
                        const float* l_in, float* o_out, float* m_out,
                        float* l_out, int tl, int h, int kvh, int d,
                        int dtype, int q_shard, int k_shard, int n_shards,
                        int window, float softcap, float scale, int normalize,
                        void* stream) {
  if (d > 256 || h % kvh != 0 || h / kvh > kRows || tl <= 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(d, q, k, v, q_off, k_off, n_seqs, o_in, m_in,
                             l_in, o_out, m_out, l_out, tl, h, kvh, q_shard,
                             k_shard, n_shards, window, softcap, scale,
                             normalize, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(d, q, k, v, q_off, k_off, n_seqs, o_in,
                                     m_in, l_in, o_out, m_out, l_out, tl, h,
                                     kvh, q_shard, k_shard, n_shards, window,
                                     softcap, scale, normalize, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_flash_prefill_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
