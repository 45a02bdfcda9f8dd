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
// Design.  One CTA per (q tile, KV head).  Its 64 rows are the q_per_kv q
// heads of that KV head for 64 / q_per_kv consecutive tokens, so GQA shares
// every K/V tile across the group (glm4's q_per_kv = 16 gives 4 tokens x 16
// heads).  The CTA loads the offsets into shared memory and derives the exact
// key range its rows can reach — the first row's segment start (raised by
// the window reach) up to the last row's segment end (cut by the causal
// reach) — so tile pairs that cannot interact are never visited and the
// ragged block-diagonal costs what it needs.  Ragged edges (Tl not a
// multiple of the tile, partial segments) are masked per element.
// The inner loops are plain fp32 FMA on shared-memory tiles (4 x 4 score
// and 4 x D/8 output register blocks per thread); operands of either input
// type (f32 or bf16) are widened to f32 on load and accumulate in f32.
//
// Bound on this card: the work is 4 * H * D * sum_b len_b (len_b + 1) / 2
// FLOPs against one read of q, k, v and one write of the f32 o (plus the
// carry for K3).  Long segments put it above the H100's ~295 FLOP/byte
// ridge (operations bind); a packed batch of prompts up to ~2k tokens sits
// just below it (bytes bind by a small margin).  Either bound is far below
// what this first version takes: it runs both products on the fp32 CUDA
// cores, not the tensor cores.  Moving them to wgmma with TMA-fed tiles is
// the later step that attacks the bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kRows = 64;     // (q token, q head) rows per CTA
constexpr int kBK = 32;       // keys per tile
constexpr int kThreads = 128;
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

template <typename T>
int dispatch_d(int d, const void* q, const void* k, const void* v,
               const int* q_off, const int* k_off, int n_seqs,
               const float* o_in, const float* m_in, const float* l_in,
               float* o_out, float* m_out, float* l_out, int tl, int h,
               int kvh, int q_shard, int k_shard, int n_shards, int window,
               float softcap, float scale, int normalize, cudaStream_t s) {
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
