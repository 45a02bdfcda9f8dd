// Backward of the position-masked flash attention (K4) for Hopper (sm_90a).
//
// The TPU reference has no backward kernel: it differentiates
// src/repro/models/attention.py::full_attention (the function of the Pallas
// kernel src/repro/kernels/striped_attention.py::striped_flash_attention)
// through XLA.  This is the port's hand-written counterpart of that
// gradient; `kernels/striped_attention.py::StripedFlashAttentionFn` launches
// it from its backward on CUDA tensors.  It is what every train step's
// attention layers run (`launch/steps.py::make_train_step`).
//
// What it computes (the FlashAttention-2 backward): with the forward's row
// statistic lse = m + log l (f32 [B, H, Sq], written by striped_attention.cu;
// +inf for a row with no key) and, per attended pair (the forward's mask:
// causal q_pos >= k_pos, window q_pos - k_pos < window),
//     s = (q . k) * scale,  t = c tanh(s / c) (softcap c) or s,
//     p = exp(t - lse),  delta = rowsum(do * o),  dp = do . v,
//     ds = p (dp - delta) [* (1 - tanh^2(s / c))],
//     dv += p^T do,  dk += scale ds^T q,  dq += scale ds k,
// with dk / dv summed over the q heads of each KV head (GQA).  Masked pairs
// and empty rows (exp(t - inf) = 0) contribute exactly zero.
//
// Design (simple and right first).  Three launches, no atomics, so the
// result is deterministic:
//   1. delta_kernel: one warp per (token, head) row, delta in f32;
//   2. dkdv_kernel: one CTA per (32-key tile, KV head, batch row) holds its
//      K / V tile in shared memory and walks every 64-row q tile and every q
//      head of its group, accumulating dk / dv in registers;
//   3. dq_kernel: one CTA per (64-row q tile, q head, batch row) holds its Q
//      / dO tile and walks every key tile, accumulating dq in registers.
// Operands of either type (f32, bf16) are widened to f32 in shared memory
// (rows padded to DP + 1 floats: conflict-free columns) and every product
// is an fp32 FMA; the score tile recomputes S and dP per (q tile, key tile)
// in both kernels.  A tile pair is skipped when the position ranges of its
// queries and keys admit no pair (causal, window); inside a tile the mask
// is tested per element from the positions.  Head-size templates DP in
// {32, 64, 96, 128, 256} (zero-padded past d).
//
// Bound on this card: 2 x 5 x D FLOPs per attended pair and head (S, dP,
// dV, dK, dQ) against one read of q, k, v, o, do, lse and one write of dq,
// dk, dv.  At training shapes (thousands of tokens) operations bind (989
// TFLOP/s bf16 on the tensor cores); these fp32 FMAs (67 TFLOP/s outside
// the tensor cores, and S / dP computed twice) can reach a few percent of
// that bound.  wgmma products are ROADMAP queue 2's later work.
#include <climits>
#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace {

using repro::to_f32;

constexpr int kBQ = 64;  // query rows of a tile
constexpr int kBK = 32;  // keys of a tile
constexpr int kThreads = 128;
constexpr int kPS = kBK + 1;  // padded row stride of the P / dS tiles

// delta[b, h, i] = sum_d do[b, i, h, d] * o[b, i, h, d]: one warp per row
// (rows in the [B, Sq, H] order of o)
template <typename T>
__global__ void __launch_bounds__(kThreads) delta_kernel(
    const T* __restrict__ o, const T* __restrict__ dout,
    float* __restrict__ delta, long long rows, int sq, int h, int d) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) + threadIdx.x / 32;
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // uniform across the warp
  const T* op = o + row * d;
  const T* dp = dout + row * d;
  float acc = 0.f;
  for (int c = lane; c < d; c += 32) acc = fmaf(to_f32(op[c]), to_f32(dp[c]), acc);
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, w);
  if (lane == 0) {
    const long long hh = row % h, bi = row / h;
    delta[(bi / sq * h + hh) * sq + bi % sq] = acc;
  }
}

// Rows r0 .. r0 + R - 1 of one head into s[R][DP + 1] as f32; row r is at
// base + r * stride.  Rows at or past n and columns at or past d are zero.
template <int R, int DP, typename T>
__device__ __forceinline__ void load_rows(float* s, const T* base,
                                          long long stride, int r0, int n,
                                          int d) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (r0 + r < n && c < d) x = to_f32(base[(long long)(r0 + r) * stride + c]);
    s[r * (DP + 1) + c] = x;
  }
}

// Warp 0 writes the min / max of pos[0 .. n) to out[0], out[1].
__device__ __forceinline__ void pos_range(const int* pos, int n, int* out) {
  if (threadIdx.x >= 32) return;
  int lo = INT_MAX, hi = INT_MIN;
  for (int i = threadIdx.x; i < n; i += 32) {
    const int p = pos[i];
    lo = min(lo, p);
    hi = max(hi, p);
  }
  lo = repro::warp_min(lo);
  hi = repro::warp_max(hi);
  if (threadIdx.x == 0) {
    out[0] = lo;
    out[1] = hi;
  }
}

// true when no query of [q_lo, q_hi] can attend a key of [k_lo, k_hi]
__device__ __forceinline__ bool no_pair(long long q_lo, long long q_hi,
                                        long long k_lo, long long k_hi,
                                        int causal, int window) {
  return (causal && q_hi < k_lo) || (window > 0 && q_lo - k_hi >= window);
}

// The score tile of kBQ rows x kBK keys.  Thread (rg = tid / 8, cg = tid %
// 8) computes rows 4 rg + i and keys cg + 8 j (i, j < 4) of S = Q K^T and
// dP = dO V^T, then p = exp(t - lse) and ds = p (dp - delta) [x (1 -
// tanh^2)] on the pairs the mask admits (zero elsewhere) into s_p / s_ds
// ([kBQ][kPS]).
template <int DP>
__device__ __forceinline__ void score_tile(
    const float* s_q, const float* s_do, const float* s_k, const float* s_v,
    const float* s_lse, const float* s_delta, const int* s_qpos,
    const int* s_kpos, int nq, int nk, int causal, int window, float softcap,
    float scale, float* s_p, float* s_ds) {
  constexpr int QS = DP + 1;
  const int rg = threadIdx.x / 8, cg = threadIdx.x % 8;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < DP; ++dd) {
    float qv[4], dov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = s_q[(rg * 4 + i) * QS + dd];
      dov[i] = s_do[(rg * 4 + i) * QS + dd];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = s_k[(cg + 8 * j) * QS + dd];
      vv[j] = s_v[(cg + 8 * j) * QS + dd];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(dov[i], vv[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = rg * 4 + i;
    const int qp = s_qpos[r];
    const float lse = s_lse[r], del = s_delta[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = cg + 8 * j;
      const int kp = s_kpos[c];
      bool ok = r < nq && c < nk;
      if (causal) ok = ok && qp >= kp;
      if (window > 0) ok = ok && (long long)qp - kp < window;
      float x = s[i][j] * scale, dt = 1.f;
      if (softcap > 0.f) {
        const float th = tanhf(x / softcap);
        x = softcap * th;
        dt = 1.f - th * th;
      }
      const float p = ok ? expf(x - lse) : 0.f;  // exp(-inf) = 0: empty rows
      s_p[r * kPS + c] = p;
      s_ds[r * kPS + c] = p * (dp[i][j] - del) * dt;
    }
  }
}

// dynamic shared memory of both kernels (they hold the same tiles)
template <int DP>
constexpr size_t smem_bytes() {
  return (2 * (size_t)kBK * (DP + 1) + 2 * (size_t)kBQ * (DP + 1) +
          2 * (size_t)kBQ * kPS + 2 * (size_t)kBQ) * sizeof(float) +
         ((size_t)kBQ + kBK + 4) * sizeof(int);
}

struct Smem {
  float *k, *v, *q, *dout, *p, *ds, *lse, *delta;
  int *qpos, *kpos, *range;  // range: q lo, q hi, k lo, k hi
};

template <int DP>
__device__ __forceinline__ Smem carve(float* base) {
  constexpr int QS = DP + 1;
  Smem s;
  s.k = base;
  s.v = s.k + kBK * QS;
  s.q = s.v + kBK * QS;
  s.dout = s.q + kBQ * QS;
  s.p = s.dout + kBQ * QS;
  s.ds = s.p + kBQ * kPS;
  s.lse = s.ds + kBQ * kPS;
  s.delta = s.lse + kBQ;
  s.qpos = reinterpret_cast<int*>(s.delta + kBQ);
  s.kpos = s.qpos + kBQ;
  s.range = s.kpos + kBK;
  return s;
}

// Q / dO rows t0 .. t0 + kBQ - 1 of q head hh, their lse / delta and
// positions (the q tile of both kernels)
template <int DP, typename T>
__device__ __forceinline__ void load_q_tile(
    const Smem& s, const T* q, const T* dout, const float* lse,
    const float* delta, const int* q_pos, int b, int hh, int t0, int sq,
    int h, int d) {
  const long long stride = (long long)h * d;
  const size_t off = (size_t)b * sq * stride + (size_t)hh * d;
  load_rows<kBQ, DP>(s.q, q + off, stride, t0, sq, d);
  load_rows<kBQ, DP>(s.dout, dout + off, stride, t0, sq, d);
  for (int r = threadIdx.x; r < kBQ; r += kThreads) {
    const bool on = t0 + r < sq;
    const size_t li = ((size_t)b * h + hh) * sq + t0 + r;
    s.lse[r] = on ? lse[li] : 0.f;
    s.delta[r] = on ? delta[li] : 0.f;
    s.qpos[r] = on ? q_pos[t0 + r] : 0;
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, T* __restrict__ dk, T* __restrict__ dv,
    int sq, int sk, int h, int kvh, int d, int causal, int window,
    float softcap, float scale) {
  constexpr int NC = DP / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  const Smem s = carve<DP>(smem);
  const int tid = threadIdx.x;
  const int g = blockIdx.y, b = blockIdx.z;
  const int qpk = h / kvh;
  const int k0 = blockIdx.x * kBK;
  const int nk = min(kBK, sk - k0);
  const long long kv_stride = (long long)kvh * d;
  const size_t kv_off = (size_t)b * sk * kv_stride + (size_t)g * d;
  load_rows<kBK, DP>(s.k, k + kv_off, kv_stride, k0, sk, d);
  load_rows<kBK, DP>(s.v, v + kv_off, kv_stride, k0, sk, d);
  for (int c = tid; c < kBK; c += kThreads) s.kpos[c] = c < nk ? k_pos[k0 + c] : 0;
  pos_range(k_pos + k0, nk, s.range + 2);
  __syncthreads();
  const long long k_lo = s.range[2], k_hi = s.range[3];

  // thread owns keys 4 (tid / 16) + a (a < 4), columns tid % 16 + 16 c
  const int kr = tid / 16, cc = tid % 16;
  float acc_k[4][NC], acc_v[4][NC];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc_k[a][c] = acc_v[a][c] = 0.f;

  for (int t0 = 0; t0 < sq; t0 += kBQ) {
    const int nq = min(kBQ, sq - t0);
    __syncthreads();  // the previous tile is consumed
    pos_range(q_pos + t0, nq, s.range);
    __syncthreads();
    if (no_pair(s.range[0], s.range[1], k_lo, k_hi, causal, window)) continue;
    for (int hq = 0; hq < qpk; ++hq) {
      __syncthreads();  // the previous head's tiles are consumed
      load_q_tile<DP>(s, q, dout, lse, delta, q_pos, b, g * qpk + hq, t0, sq, h, d);
      __syncthreads();
      score_tile<DP>(s.q, s.dout, s.k, s.v, s.lse, s.delta, s.qpos, s.kpos, nq,
                     nk, causal, window, softcap, scale, s.p, s.ds);
      __syncthreads();
      for (int i = 0; i < nq; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int a = 0; a < 4; ++a) {
          pv[a] = s.p[i * kPS + kr * 4 + a];
          dsv[a] = s.ds[i * kPS + kr * 4 + a];
        }
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const float dov = s.dout[i * (DP + 1) + cc + 16 * c];
          const float qv = s.q[i * (DP + 1) + cc + 16 * c];
#pragma unroll
          for (int a = 0; a < 4; ++a) {
            acc_v[a][c] = fmaf(pv[a], dov, acc_v[a][c]);
            acc_k[a][c] = fmaf(dsv[a], qv, acc_k[a][c]);
          }
        }
      }
    }
  }
#pragma unroll
  for (int a = 0; a < 4; ++a) {
    const int j = kr * 4 + a;
    if (j >= nk) continue;
    const size_t row = kv_off + (size_t)(k0 + j) * kv_stride;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cc + 16 * c;
      if (col < d) {
        repro::store(&dk[row + col], acc_k[a][c] * scale);
        repro::store(&dv[row + col], acc_v[a][c]);
      }
    }
  }
}

template <typename T, int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
    const T* __restrict__ dout, const float* __restrict__ lse,
    const float* __restrict__ delta, const int* __restrict__ q_pos,
    const int* __restrict__ k_pos, T* __restrict__ dq, int sq, int sk, int h,
    int kvh, int d, int causal, int window, float softcap, float scale) {
  constexpr int NC = DP / 16;
  extern __shared__ float smem[];
  const Smem s = carve<DP>(smem);
  const int tid = threadIdx.x;
  const int hh = blockIdx.y, b = blockIdx.z;
  const int g = hh / (h / kvh);
  const int t0 = blockIdx.x * kBQ;
  const int nq = min(kBQ, sq - t0);
  load_q_tile<DP>(s, q, dout, lse, delta, q_pos, b, hh, t0, sq, h, d);
  pos_range(q_pos + t0, nq, s.range);
  __syncthreads();
  const long long q_lo = s.range[0], q_hi = s.range[1];
  const long long kv_stride = (long long)kvh * d;
  const size_t kv_off = (size_t)b * sk * kv_stride + (size_t)g * d;

  // thread owns rows 8 (tid / 16) + a (a < 8), columns tid % 16 + 16 c
  const int rr = tid / 16, cc = tid % 16;
  float acc[8][NC];
#pragma unroll
  for (int a = 0; a < 8; ++a)
#pragma unroll
    for (int c = 0; c < NC; ++c) acc[a][c] = 0.f;

  for (int k0 = 0; k0 < sk; k0 += kBK) {
    const int nk = min(kBK, sk - k0);
    __syncthreads();  // the previous tile is consumed
    for (int c = tid; c < kBK; c += kThreads) s.kpos[c] = c < nk ? k_pos[k0 + c] : 0;
    pos_range(k_pos + k0, nk, s.range + 2);
    __syncthreads();
    if (no_pair(q_lo, q_hi, s.range[2], s.range[3], causal, window)) continue;
    load_rows<kBK, DP>(s.k, k + kv_off, kv_stride, k0, sk, d);
    load_rows<kBK, DP>(s.v, v + kv_off, kv_stride, k0, sk, d);
    __syncthreads();
    score_tile<DP>(s.q, s.dout, s.k, s.v, s.lse, s.delta, s.qpos, s.kpos, nq,
                   nk, causal, window, softcap, scale, s.p, s.ds);
    __syncthreads();
    for (int j = 0; j < nk; ++j) {
      float dsv[8];
#pragma unroll
      for (int a = 0; a < 8; ++a) dsv[a] = s.ds[(rr * 8 + a) * kPS + j];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        const float kv = s.k[j * (DP + 1) + cc + 16 * c];
#pragma unroll
        for (int a = 0; a < 8; ++a) acc[a][c] = fmaf(dsv[a], kv, acc[a][c]);
      }
    }
  }
  const long long q_stride = (long long)h * d;
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    const int i = rr * 8 + a;
    if (i >= nq) continue;
    const size_t row = (size_t)b * sq * q_stride + (size_t)(t0 + i) * q_stride +
                       (size_t)hh * d;
#pragma unroll
    for (int c = 0; c < NC; ++c) {
      const int col = cc + 16 * c;
      if (col < d) repro::store(&dq[row + col], acc[a][c] * scale);
    }
  }
}

struct Args {
  const void *q, *k, *v, *o, *dout;
  const float* lse;
  const int *q_pos, *k_pos;
  void *dq, *dk, *dv;
  float* delta;
  int b, sq, sk, h, kvh, d, causal, window;
  float softcap, scale;
  cudaStream_t stream;
};

template <typename T, int DP>
int launch(const Args& a) {
  const T* q = static_cast<const T*>(a.q);
  const T* k = static_cast<const T*>(a.k);
  const T* v = static_cast<const T*>(a.v);
  const T* dout = static_cast<const T*>(a.dout);
  const long long rows = (long long)a.b * a.sq * a.h;
  delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                    kThreads, 0, a.stream>>>(static_cast<const T*>(a.o), dout,
                                             a.delta, rows, a.sq, a.h, a.d);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  constexpr size_t smem = smem_bytes<DP>();
  auto kv_kern = dkdv_kernel<T, DP>;
  err = cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  kv_kern<<<dim3((a.sk + kBK - 1) / kBK, a.kvh, a.b), kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.q_pos, a.k_pos, static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.sq, a.sk, a.h, a.kvh, a.d, a.causal, a.window,
      a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kern = dq_kernel<T, DP>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  q_kern<<<dim3((a.sq + kBQ - 1) / kBQ, a.h, a.b), kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.q_pos, a.k_pos, static_cast<T*>(a.dq),
      a.sq, a.sk, a.h, a.kvh, a.d, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_d(const Args& a) {
  if (a.d <= 32) return launch<T, 32>(a);
  if (a.d <= 64) return launch<T, 64>(a);
  if (a.d <= 96) return launch<T, 96>(a);
  if (a.d <= 128) return launch<T, 128>(a);
  return launch<T, 256>(a);
}

}  // namespace

extern "C" {

// q / o / dout / dq [b, sq, h, d], k / v / dk / dv [b, sk, kvh, d],
// contiguous, all of one dtype (0 = float32, 1 = bfloat16); lse [b, h, sq]
// f32 from the forward (striped_attention.cu); delta [b, h, sq] f32
// scratch; q_pos [sq] and k_pos [sk] int32 in any order.  causal, window
// and softcap as in repro_striped_attention.  Requires d % 8 == 0, d <=
// 256, h % kvh == 0, h / kvh <= 64, b <= 65535 and sq, sk >= 1.  Writes dq,
// dk and dv (no accumulation into them); returns the first failing
// launch's cudaError_t.
int repro_striped_attention_bwd(const void* q, const void* k, const void* v,
                                const void* o, const void* dout,
                                const float* lse, const int* q_pos,
                                const int* k_pos, void* dq, void* dk, void* dv,
                                float* delta, int b, int sq, int sk, int h,
                                int kvh, int d, int dtype, int causal,
                                int window, float softcap, float scale,
                                void* stream) {
  if (d % 8 != 0 || d > 256 || d < 8 || kvh < 1 || h % kvh != 0 ||
      h / kvh > 64 || b < 1 || b > 65535 || sq < 1 || sk < 1 || h > 65535)
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, delta, b, sq,
               sk, h, kvh, d, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  if (dtype == 0) return dispatch_d<float>(a);
  if (dtype == 1) return dispatch_d<__nv_bfloat16>(a);
  return (int)cudaErrorInvalidValue;
}

const char* repro_striped_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
