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
// Design.  One CTA per (q tile, KV head, batch row); its 64 rows are the
// q_per_kv q heads of that KV head for 64 / q_per_kv consecutive query
// tokens, so GQA shares every K/V tile across the group (mixtral's
// q_per_kv = 4 gives 16 tokens x 4 heads).  The CTA walks the key axis 32
// keys at a time.  Because positions can be in any order, tile skipping
// works from ranges: the CTA knows the min / max position of its queries, and
// for each key tile warp 0 reduces the tile's min / max key position; the
// tile is skipped when every key lies after every query (causal) or every
// key lies outside every query's window.  For contiguous positions that
// skips the upper triangle (about half the work) and everything beyond the
// window.  The products run as plain fp32 FMAs on shared-memory tiles (4 x 4
// score and 4 x D/8 output register blocks per thread), with operands of
// either input type widened to f32 on load; the output is written in the
// input type.  The head size is a template bound DP in {32, 64, 96, 128, 256}
// (zamba2's 80 runs at 96, masked per element), so no tile assumes a power
// of two.
//
// Bound on this card: 4 * H * D * (attended pairs) FLOPs against one read of
// q, k, v and one write of o.  A serial prompt of a few thousand tokens is
// far above the H100's ~295 FLOP/byte ridge, so operations bind.  This first
// version runs both products on the fp32 CUDA cores, not the tensor cores,
// so it sits far from that bound; moving them to wgmma with TMA-fed tiles is
// the later step that attacks it.
#include <climits>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::kNegInf;
using repro::to_f32;

constexpr int kRows = 64;  // (q token, q head) rows per CTA
constexpr int kBK = 32;    // keys per tile
constexpr int kThreads = 128;

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) striped_attention_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    T* __restrict__ o, int sq, int sk, int h, int kvh, int d, int qpk, int bq,
    int causal, int window, float softcap, float scale) {
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
  }
}

template <typename T, int DP>
int launch(const void* q, const void* k, const void* v, const int* q_pos,
           const int* k_pos, void* o, int b, int sq, int sk, int h, int kvh,
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
      static_cast<const T*>(v), q_pos, k_pos, static_cast<T*>(o), sq, sk, h,
      kvh, d, qpk, bq, causal, window, softcap, scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const void* q, const void* k, const void* v, const int* q_pos,
               const int* k_pos, void* o, int b, int sq, int sk, int h,
               int kvh, int d, int causal, int window, float softcap,
               float scale, cudaStream_t s) {
#define REPRO_LAUNCH(DP)                                                   \
  return launch<T, DP>(q, k, v, q_pos, k_pos, o, b, sq, sk, h, kvh, d,     \
                       causal, window, softcap, scale, s)
  if (d <= 32) REPRO_LAUNCH(32);
  if (d <= 64) REPRO_LAUNCH(64);
  if (d <= 96) REPRO_LAUNCH(96);
  if (d <= 128) REPRO_LAUNCH(128);
  REPRO_LAUNCH(256);
#undef REPRO_LAUNCH
}

}  // namespace

extern "C" {

// q [b, sq, h, d], k / v [b, sk, kvh, d] and o [b, sq, h, d], contiguous,
// all of one dtype (0 = float32, 1 = bfloat16); q_pos [sq] and k_pos [sk]
// int32 in any order.  causal != 0 masks q_pos < k_pos; window <= 0 and
// softcap <= 0 disable those masks.  Requires d % 8 == 0, d <= 256,
// h % kvh == 0, h / kvh <= 64, b <= 65535 and sq, sk >= 1.  Returns the
// launch's cudaError_t.
int repro_striped_attention(const void* q, const void* k, const void* v,
                            const int* q_pos, const int* k_pos, void* o, int b,
                            int sq, int sk, int h, int kvh, int d, int dtype,
                            int causal, int window, float softcap, float scale,
                            void* stream) {
  if (d % 8 != 0 || d > 256 || d < 8 || kvh < 1 || h % kvh != 0 ||
      h / kvh > kRows || b < 1 || b > 65535 || sq < 1 || sk < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return dispatch_d<float>(q, k, v, q_pos, k_pos, o, b, sq, sk, h, kvh, d,
                             causal, window, softcap, scale, s);
  if (dtype == 1)
    return dispatch_d<__nv_bfloat16>(q, k, v, q_pos, k_pos, o, b, sq, sk, h,
                                     kvh, d, causal, window, softcap, scale, s);
  return (int)cudaErrorInvalidValue;
}

const char* repro_striped_attention_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
