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
// Design.  Three launches and no atomics, so two calls on the same inputs
// give bitwise-equal gradients:
//   1. delta_kernel: one warp per (token, head) row, delta in f32;
//   2. the dk / dv grid, K/V-stationary: one CTA per (key tile, KV head,
//      batch row) holds its keys' K and V and streams the Q / dO rows of
//      every q head of the group, summing dk and dv in registers;
//   3. the dq grid, Q-stationary: one CTA per (q tile, head or KV head,
//      batch row) holds its Q / dO rows and streams every K / V tile,
//      summing dq in registers.
// The dq grid recomputes S and dP, so the grids do seven products per
// attended pair where the function needs five: the price of writing every
// gradient from the one CTA that sums it.  The operand type picks the body:
//   * bf16 (the train step's route): every product is wgmma (m64nNk16, f32
//     accumulators) on attn_tc.cuh's no-swizzle tiles, descriptors and
//     Wgmma<N> forms.  A warpgroup owns 64 rows of the held side (keys in
//     the dk / dv grid, q rows in the dq grid); a CTA is two warpgroups (one
//     at head size 256, for shared memory).  The held tiles come by
//     cp.async once; the streamed tiles (K / V in the dq grid, Q / dO in
//     the dk / dv grid) by TMA into a two-stage ring, one lane asking for
//     each box and an mbarrier per stage completing on its bytes, so the
//     CTA's threads spend no instructions on those copies: issuing the
//     copies per thread (cp.async) took about a third of the kernel's time.  A q tile of the dk / dv grid is 64 /
//     q_per_kv tokens times the group's q heads, with each row's lse, delta
//     and position gathered beside it.  The dk / dv grid takes S^T = K Q^T
//     and dP^T = V dO^T (both operands K-major), then P^T and dS^T on the
//     accumulator fragment, then dV += P^T dO and dK += dS^T Q with P^T /
//     dS^T rounded to bf16 in registers as the A fragment (the forward's
//     step for P) and dO / Q read MN-major from the same tiles.  The dq grid
//     is the forward's loop plus one product: S = Q K^T, dP = dO V^T, dS on
//     the fragment, dQ += dS K with K read MN-major.  The softcap branch
//     sits outside the per-element loop.  At head size 256 the accumulators
//     would not fit a thread's 255 registers, so a dk / dv CTA sums a
//     quarter of the columns of dk and dv and a dq CTA half of dq's: four
//     (two) CTAs share a tile and each computes its S and dP.  Tiles are
//     visited from per-CTA bitmaps, as in the forward's PositionMask: a bit
//     per tile where some pair may pass the mask (live) and one where every
//     pair passes and every row and key exists (inner: no per-element mask);
//     the dk / dv grid keeps a pair of bits per warpgroup, so a warpgroup
//     whose keys meet no query of a tile skips its products.  Head-size
//     templates 64, 80, 128 and 256 (tc::head_template; zero-padded past d).
//   * f32 (the parity route; tensor cores would round f32 operands to
//     TF32): fp32 FMAs on tiles widened in shared memory (rows padded to DP
//     + 1 floats: conflict-free columns); the dk / dv CTA holds 32 keys and
//     walks each q head of its group, the dq CTA holds 64 rows of one q
//     head.  A tile pair is skipped when the position ranges of its queries
//     and keys admit no pair; inside a tile the mask is tested per element.
//     Head-size templates DP in {32, 64, 96, 128, 256}.
//
// Bound on this card: 2 x 5 x D FLOPs per attended pair and head (S, dP,
// dV, dK, dQ) against one read of q, k, v, o, do, lse and one write of dq,
// dk, dv.  At training shapes (thousands of tokens) operations bind (989
// TFLOP/s bf16 on the tensor cores; the f32 route's FMAs reach about 1 % of
// it).  Measured by tools/k4_bwd_probe.py on an NVIDIA H100 80GB HBM3 at a
// 700 W power limit, at the lwm-7b train shape (B 2, S 4096, H = KVH = 32,
// D 128, causal): 3.6 ms a call, 19 % of its 0.695 ms bound (the dk / dv
// grid 1.8 ms at 299 TFLOP/s on its 4 products, the dq grid 1.7 ms at 242
// on its 3); SDPA's flash backward 1.44 ms.  The two warpgroups of a CTA
// run their products and their elementwise steps in step with each other,
// so the tensor cores idle while the P / dS fragments are computed.
#include <climits>
#include <cstdint>
#include <type_traits>

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "attn_tc.cuh"
#include "common.cuh"

namespace {

using repro::to_f32;
namespace tc = repro::tc;
using bf16 = __nv_bfloat16;

constexpr int kBQ = 64;  // query rows of an f32 tile
constexpr int kBK = 32;  // keys of an f32 tile
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

// ------------------------------------------------------ f32: fp32 FMAs

// Rows r0 .. r0 + R - 1 of one head into s[R][DP + 1]; row r is at base +
// r * stride.  Rows at or past n and columns at or past d are zero.
template <int R, int DP>
__device__ __forceinline__ void load_rows(float* s, const float* base,
                                          long long stride, int r0, int n,
                                          int d) {
  for (int idx = threadIdx.x; idx < R * DP; idx += kThreads) {
    const int r = idx / DP, c = idx % DP;
    float x = 0.f;
    if (r0 + r < n && c < d) x = base[(long long)(r0 + r) * stride + c];
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

// dynamic shared memory of both f32 kernels (they hold the same tiles)
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
template <int DP>
__device__ __forceinline__ void load_q_tile(
    const Smem& s, const float* q, const float* dout, const float* lse,
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

template <int DP>
__global__ void __launch_bounds__(kThreads) dkdv_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dk, float* __restrict__ dv, int sq, int sk, int h,
    int kvh, int d, int causal, int window, float softcap, float scale) {
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
        dk[row + col] = acc_k[a][c] * scale;
        dv[row + col] = acc_v[a][c];
      }
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads) dq_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    float* __restrict__ dq, int sq, int sk, int h, int kvh, int d, int causal,
    int window, float softcap, float scale) {
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
      if (col < d) dq[row + col] = acc[a][c] * scale;
    }
  }
}

// ------------------------------------------------ bf16: the tensor cores

constexpr int kTR = 64;  // rows of a streamed tile: q rows (dk / dv grid) or keys (dq grid)

// CTA shape of both bf16 grids for head-size template DP: two warpgroups,
// one at head size 256 (shared memory)
template <int DP>
struct Tc {
  static constexpr int kWarpgroups = DP == 256 ? 1 : 2;
  static constexpr int kThreads = 128 * kWarpgroups;
  static constexpr int kRows = 64 * kWarpgroups;     // held rows: keys or q rows
  static constexpr int kDN = DP == 256 ? 64 : DP;    // dk / dv columns of a CTA
  static constexpr int kQN = DP == 256 ? 128 : DP;   // dq columns of a CTA
  static constexpr int kHeld = kRows * DP * 2;       // bytes of a held tile
  static constexpr int kTile = kTR * DP * 2;         // bytes of a streamed tile
  static constexpr int kStage = 2 * kTile;           // Q then dO, or K then V
  static constexpr int kRowData = 3 * kTR * 4;       // lse, delta, position
  // dynamic shared memory before the visit bitmaps (two stages in the ring)
  static constexpr int kDkdvBytes = 2 * kHeld + 2 * kStage + 2 * kRowData;
  static constexpr int kDqBytes = 2 * kHeld + 2 * kStage;
};

// Copy R rows x DP bf16 into attn_tc.cuh's no-swizzle layout at dst with
// kT threads (tc::load_tile's pattern: a warp copies 4 chunks of 8
// consecutive rows).  row_src(r) is row r's first element, or nullptr for a
// row of zeros; 16-byte chunks at or past d are zero-filled; `any` is a
// valid global address for the zero-filling copies.
template <int R, int DP, int kT, class RowSrc>
__device__ __forceinline__ void copy_tile(uint32_t dst, RowSrc row_src, int d,
                                          const void* any) {
  constexpr int kCh = DP / 8;
#pragma unroll
  for (int it = 0; it < (R * kCh + kT - 1) / kT; ++it) {
    const int idx = it * kT + threadIdx.x;
    if constexpr ((R * kCh) % kT != 0)
      if (idx >= R * kCh) break;
    const int row = (idx / (8 * kCh)) * 8 + (idx & 7);
    const int ch = (idx >> 3) % kCh;
    const bf16* src = row_src(row);
    const bool ok = src != nullptr && ch * 8 < d;
    repro::cp_async16(dst + ch * (R * 16) + row * 16,
                      ok ? static_cast<const void*>(src + ch * 8) : any, ok);
  }
}

// Visit bitmaps of kP / 2 units (warpgroups of a dk / dv CTA, or the whole
// dq CTA): one bit per streamed tile in each of kP planes, word w of plane
// p at bits[w * kP + p].  Plane 2u marks the tiles where some pair of unit
// u may pass the mask (live), plane 2u + 1 those where every pair passes
// and every row and key exists (inner).
template <int kP>
struct Visits {
  const uint32_t* bits;
  int n;  // tiles

  // the first tile after t that some unit visits, or -1
  __device__ int next(int t) const {
    for (int u = t + 1; u < n;) {
      uint32_t w = 0;
#pragma unroll
      for (int p = 0; p < kP; p += 2) w |= bits[(u >> 5) * kP + p];
      w >>= u & 31;
      if (w) return u + __ffs(w) - 1;
      u = (u | 31) + 1;
    }
    return -1;
  }
  __device__ bool bit(int t, int plane) const {
    return (bits[(t >> 5) * kP + plane] >> (t & 31)) & 1u;
  }
};

// Streamed tiles arrive by TMA: one thread asks for a box of a 5-D tensor
// map, and the stage's mbarrier (arrival count 1) completes when the
// transfer's bytes have landed.
__device__ __forceinline__ void mbar_init(uint32_t bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}
// arrive on bar and expect `bytes` of TMA transfers in its current phase
__device__ __forceinline__ void mbar_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes) : "memory");
}
// wait until bar's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  asm volatile(
      "{\n.reg .pred done;\nWAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n}\n" ::"r"(bar), "r"(parity) : "memory");
}
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         uint32_t bar, int c0, int c1, int c2,
                                         int c3, int c4) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6, %7}], [%2];\n"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3), "r"(c4) : "memory");
}

// the two stages' mbarriers, initialized by thread 0 before a __syncthreads
__device__ __forceinline__ void init_stage_barriers(uint64_t (&bars)[2]) {
  if (threadIdx.x == 0) {
    mbar_init(repro::smem_u32(&bars[0]));
    mbar_init(repro::smem_u32(&bars[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
}

// The gradient of one score, on the accumulator fragment: s = q . k and dp
// = do . v on entry; on exit s = p = exp(t - lse) (0 where !ok) and dp = ds
// = p (dp - delta) [* (1 - tanh^2)], t the scaled (and, with kCap, capped)
// score.  c = scale * log2 e, or log2 e with a softcap; lse2 = lse * log2 e
// (+inf for a row without keys gives p = 0).
template <bool kCap>
__device__ __forceinline__ void grad(float& s, float& dp, bool ok, float lse2,
                                     float delta, float c, float scale,
                                     float softcap) {
  if constexpr (kCap) {
    const float th = tanhf(s * scale / softcap);
    const float p = ok ? repro::ex2(fmaf(softcap * th, c, -lse2)) : 0.f;
    s = p;
    dp = p * (dp - delta) * (1.f - th * th);
  } else {
    const float p = ok ? repro::ex2(fmaf(s, c, -lse2)) : 0.f;
    s = p;
    dp = p * (dp - delta);
  }
}

// an m64n64 f32 accumulator fragment as the bf16 A fragments of its four
// k-steps of 16 columns (the forward's step for P)
__device__ __forceinline__ void to_a(const float (&x)[kTR / 2], uint32_t (&a)[kTR / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < kTR / 16; ++ks)
#pragma unroll
    for (int r = 0; r < 4; ++r) a[ks][r] = tc::pack_bf16(x[8 * ks + 2 * r], x[8 * ks + 2 * r + 1]);
}

// write one f32 fragment row block to bf16 rows: 8-byte stores of four
// columns, row r at out + row_off(r), skipped where row_off(r) < 0 or col >= d
template <int N, class RowOff>
__device__ __forceinline__ void store_bf16(const float (&acc)[N / 2], bf16* out,
                                           RowOff row_off, int col0, int d) {
  tc::store_rows<N>(acc, [&](int r, int col, float4 x) {
    const long long off = row_off(r);
    if (off < 0 || col0 + col >= d) return;
    uint2 w;
    w.x = tc::pack_bf16(x.x, x.y);
    w.y = tc::pack_bf16(x.z, x.w);
    *reinterpret_cast<uint2*>(out + off + col0 + col) = w;
  });
}

// A q tile of the dk / dv grid is tpt = kTR / q_per_kv consecutive tokens
// times the group's q heads, rows head-major: row r is q head r / tpt of
// token r % tpt.  Its Q and dO arrive by TMA (tensor maps over [B, Sq, H,
// D] as 5-D boxes of (8 columns, tpt tokens, q_per_kv heads, cpb column
// blocks, 1)): one box per tensor (cpb = DP / 8) when q_per_kv divides kTR,
// else one per 8-column block (cpb = 1), so every block keeps its kTR-row
// stride.  Rows past tpt * q_per_kv stay zero, and a row past the last
// token or past the tile has lse = +inf (p = 0).
template <int DP>
__global__ void __launch_bounds__(Tc<DP>::kThreads, 1) dkdv_tc_kernel(
    const __grid_constant__ CUtensorMap tm_q, const __grid_constant__ CUtensorMap tm_do,
    const bf16* __restrict__ k, const bf16* __restrict__ v,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    bf16* __restrict__ dk, bf16* __restrict__ dv, int sq, int sk, int h,
    int kvh, int d, int causal, int window, float softcap, float scale, int cpb) {
  using C = Tc<DP>;
  constexpr int kT = C::kThreads, kW = C::kWarpgroups, KR = C::kRows, DN = C::kDN;
  constexpr int kP = 2 * kW;  // bitmap planes: (live, inner) per warpgroup
  extern __shared__ __align__(128) char tc_smem[];
  __shared__ int s_krange[kW][2];
  __shared__ uint64_t s_full[2];  // the stages' TMA barriers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int qpk = h / kvh;
  const int tpt = kTR / qpk, rpt = tpt * qpk;  // tokens and rows of a q tile
  const int n_qt = (sq + tpt - 1) / tpt;
  // launch order: every KV head's key tile before the next key tile (under
  // a causal mask the first keys meet the most queries: longest first)
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int g = lin % kvh;
  const int cb = lin / kvh % (DP / DN);  // column block of dk / dv
  const int k0 = lin / kvh / (DP / DN) * KR;
  const int b = blockIdx.z;
  const long long kv_stride = (long long)kvh * d;
  const bf16* kb = k + ((size_t)b * sk * kvh + g) * d;
  const bf16* vb = v + ((size_t)b * sk * kvh + g) * d;
  const uint32_t s_k = repro::smem_u32(tc_smem);
  const uint32_t s_v = s_k + C::kHeld;
  const uint32_t s_st = s_v + C::kHeld;  // the stages of the Q / dO ring
  float* s_rows = reinterpret_cast<float*>(tc_smem + 2 * C::kHeld + 2 * C::kStage);
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(tc_smem + C::kDkdvBytes);

  if ((warp & 3) == 0) {  // the key position range of each warpgroup
    int lo = INT_MAX, hi = INT_MIN;
    for (int e = lane; e < 64; e += 32) {
      const int j = k0 + wg * 64 + e;
      if (j < sk) {
        const int p = k_pos[j];
        lo = min(lo, p);
        hi = max(hi, p);
      }
    }
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
    if (lane == 0) {
      s_krange[wg][0] = lo;
      s_krange[wg][1] = hi;
    }
  }
  for (int i = tid; i < (n_qt + 31) / 32 * kP; i += kT) s_bits[i] = 0u;
  for (int i = tid; i < 4 * (kTR - rpt) * (DP / 8); i += kT) {  // rows TMA never writes
    const int chunk = i % ((kTR - rpt) * (DP / 8)), tile = i / ((kTR - rpt) * (DP / 8));
    const int r = rpt + chunk % (kTR - rpt), ch = chunk / (kTR - rpt);
    *reinterpret_cast<uint4*>(tc_smem + 2 * C::kHeld + tile * C::kTile + ch * (kTR * 16) +
                              r * 16) = make_uint4(0u, 0u, 0u, 0u);
  }
  init_stage_barriers(s_full);
  __syncthreads();
  // visit bitmaps: one warp per q tile, the tile's tokens over the lanes
  for (int t = warp; t < n_qt; t += kT / 32) {
    const int tk0 = t * tpt, tk1 = min(tk0 + tpt, sq);
    bool live[kW];
#pragma unroll
    for (int u = 0; u < kW; ++u) live[u] = false;
    int lo = INT_MAX, hi = INT_MIN;
    for (int tk = tk0 + lane; tk < tk1; tk += 32) {
      const int p = q_pos[tk];
      lo = min(lo, p);
      hi = max(hi, p);
#pragma unroll
      for (int u = 0; u < kW; ++u)
        live[u] |= s_krange[u][0] <= s_krange[u][1] &&
                   (!causal || p >= s_krange[u][0]) &&
                   (window <= 0 || (long long)p - s_krange[u][1] < window);
    }
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
#pragma unroll
    for (int u = 0; u < kW; ++u) {
      const bool any = __any_sync(0xffffffffu, live[u]);
      const long long klo = s_krange[u][0], khi = s_krange[u][1];
      const bool inner = tk1 - tk0 == tpt && k0 + 64 * (u + 1) <= sk &&
                         (!causal || lo >= khi) && (window <= 0 || hi - klo < window);
      if (lane == 0 && any) {
        atomicOr(&s_bits[(t >> 5) * kP + 2 * u], 1u << (t & 31));
        if (inner) atomicOr(&s_bits[(t >> 5) * kP + 2 * u + 1], 1u << (t & 31));
      }
    }
  }
  __syncthreads();

  int kp[2];  // the positions of the thread's two keys (fragment rows)
  bool kon[2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int j = k0 + tc::frag_row(sl);
    kon[sl] = j < sk;
    kp[sl] = kon[sl] ? k_pos[j] : 0;
  }
  auto key_rows = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      return k0 + r < sk ? base + (k0 + r) * kv_stride : nullptr;
    };
  };
  // Q / dO of q tile t into stage st by TMA (warp 0: a lane per box), and
  // each row's lse, delta and position by cp.async (lse = +inf, delta = 0
  // past the last row)
  auto load_q = [&](int st, int t) {
    const int tk0 = t * tpt;
    if (warp == 0) {
      const uint32_t bar = repro::smem_u32(&s_full[st]);
      if (lane == 0) mbar_expect(bar, 2 * rpt * DP * 2);
      const int nb = DP / 8 / cpb;
      for (int i = lane; i < 2 * nb; i += 32)
        tma_load(s_st + st * C::kStage + (i / nb) * C::kTile + i % nb * cpb * (kTR * 16),
                 i < nb ? &tm_q : &tm_do, bar, 0, tk0, g * qpk, i % nb * cpb, b);
    }
    float* rd = s_rows + st * 3 * kTR;
    for (int i = tid; i < 3 * kTR; i += kT) {
      const int r = i % kTR, what = i / kTR;
      const int tok = tk0 + r % tpt;
      if (r < rpt && tok < sq) {
        const size_t li = ((size_t)b * h + g * qpk + r / tpt) * sq + tok;
        repro::cp_async4(repro::smem_u32(rd + i),
                         what == 0 ? static_cast<const void*>(lse + li)
                         : what == 1 ? static_cast<const void*>(delta + li)
                                     : static_cast<const void*>(q_pos + tok), true);
      } else {
        rd[i] = what == 0 ? __int_as_float(0x7f800000) : 0.f;
      }
    }
  };

  const Visits<kP> vis{s_bits, n_qt};
  const uint32_t s_kw = s_k + wg * 64 * 16, s_vw = s_v + wg * 64 * 16;  // this warpgroup's keys
  const float c = (softcap > 0.f ? 1.f : scale) * repro::kLog2e;
  float acc_k[DN / 2], acc_v[DN / 2];
#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc_k[i] = acc_v[i] = 0.f;
  copy_tile<KR, DP, kT>(s_k, key_rows(kb), d, kb);
  copy_tile<KR, DP, kT>(s_v, key_rows(vb), d, vb);
  int t = vis.next(-1);
  if (t >= 0) load_q(0, t);
  repro::cp_async_commit();  // K, V and the first q tile's row data
  int st = 0;
  uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait for
  while (t >= 0) {
    const int nx = vis.next(t);
    mbar_wait(repro::smem_u32(&s_full[st]), (parity >> st) & 1u);
    parity ^= 1u << st;
    repro::cp_async_wait<0>();
    tc::fence_async_smem();  // K and V came by cp.async
    __syncthreads();
    if (nx >= 0) load_q(st ^ 1, nx);  // stage st ^ 1 was read before the barrier
    repro::cp_async_commit();
    if (vis.bit(t, 2 * wg)) {  // uniform across the warpgroup
      const uint32_t s_q = s_st + st * C::kStage, s_do = s_q + C::kTile;
      const float* rd = s_rows + st * 3 * kTR;
      // S^T = K Q^T and dP^T = V dO^T over DP / 16 steps of 16 head dims
      float s[kTR / 2], dp[kTR / 2];
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < DP / 16; ++ks) {
        tc::Wgmma<kTR>::ss(s, tc::desc(s_kw + ks * 2 * KR * 16, KR * 16, 128),
                           tc::desc(s_q + ks * 2 * kTR * 16, kTR * 16, 128), ks);
        tc::Wgmma<kTR>::ss(dp, tc::desc(s_vw + ks * 2 * KR * 16, KR * 16, 128),
                           tc::desc(s_do + ks * 2 * kTR * 16, kTR * 16, 128), ks);
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(s);
      tc::fence_regs(dp);

      // P^T and dS^T: element 4 j + e is key slot e / 2, q row 8 j + 2 (t %
      // 4) + e % 2 of the tile; the mask only on boundary tiles
      const bool inner = vis.bit(t, 2 * wg + 1);
      auto grads = [&](auto cap) {  // the softcap branch outside the loop
#pragma unroll
        for (int j = 0; j < kTR / 8; ++j) {
          const int col = 8 * j + 2 * (tid & 3);
          const float2 ls = *reinterpret_cast<const float2*>(rd + col);
          const float2 de = *reinterpret_cast<const float2*>(rd + kTR + col);
          const int2 qp = *reinterpret_cast<const int2*>(rd + 2 * kTR + col);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int sl = e >> 1, cc = e & 1;
            const int qpv = cc ? qp.y : qp.x;
            const bool ok = inner || (kon[sl] && (!causal || qpv >= kp[sl]) &&
                                      (window <= 0 || (long long)qpv - kp[sl] < window));
            grad<decltype(cap)::value>(s[4 * j + e], dp[4 * j + e], ok,
                                       (cc ? ls.y : ls.x) * repro::kLog2e,
                                       cc ? de.y : de.x, c, scale, softcap);
          }
        }
      };
      if (softcap > 0.f)
        grads(std::true_type{});
      else
        grads(std::false_type{});
      uint32_t pa[kTR / 16][4], da[kTR / 16][4];
      to_a(s, pa);
      to_a(dp, da);

      // dV += P^T dO and dK += dS^T Q, dO / Q read MN-major: 8-row core
      // matrices 128 bytes apart (K), 8-column blocks kTR * 16 bytes apart (N)
      const uint32_t col_off = cb * (DN / 8) * kTR * 16;
      tc::wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < kTR / 16; ++ks) {
        tc::Wgmma<DN>::rs(acc_v, pa[ks], tc::desc(s_do + col_off + ks * 16 * 16, 128, kTR * 16));
        tc::Wgmma<DN>::rs(acc_k, da[ks], tc::desc(s_q + col_off + ks * 16 * 16, 128, kTR * 16));
      }
      tc::wgmma_commit();
      tc::wgmma_wait_all();
      tc::fence_regs(acc_v);
      tc::fence_regs(acc_k);
    }
    __syncthreads();  // stage st is free for the next step's copies
    st ^= 1;
    t = nx;
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < DN / 2; ++i) acc_k[i] *= scale;
  const long long kv_off = ((long long)b * sk * kvh + g) * d;
  auto key_off = [&](int r) -> long long {
    return k0 + r < sk ? kv_off + (k0 + r) * kv_stride : -1;
  };
  store_bf16<DN>(acc_k, dk, key_off, cb * DN, d);
  store_bf16<DN>(acc_v, dv, key_off, cb * DN, d);
}

template <int DP>
__global__ void __launch_bounds__(Tc<DP>::kThreads, 1) dq_tc_kernel(
    const __grid_constant__ CUtensorMap tm_k, const __grid_constant__ CUtensorMap tm_v,
    const bf16* __restrict__ q, const bf16* __restrict__ dout,
    const float* __restrict__ lse, const float* __restrict__ delta,
    const int* __restrict__ q_pos, const int* __restrict__ k_pos,
    bf16* __restrict__ dq, int sq, int sk, int h, int kvh, int d, int causal,
    int window, float softcap, float scale) {
  using C = Tc<DP>;
  constexpr int kT = C::kThreads, QR = C::kRows, QN = C::kQN;
  extern __shared__ __align__(128) char tc_smem[];
  __shared__ int s_qrange[2];
  __shared__ uint64_t s_full[2];  // the stages' TMA barriers
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, wg = tid >> 7;
  const int qpk = h / kvh;
  const int n_rows = sq * qpk;  // the group's (token, q head) rows, token-major
  const int n_kt = (sk + kTR - 1) / kTR;
  // launch order: every KV head's q tile before the next q tile, the
  // longest rows first under a causal mask (the forward's order)
  const int lin = blockIdx.x + gridDim.x * blockIdx.y;
  const int g = lin % kvh;
  const int cb = lin / kvh % (DP / QN);  // column block of dq
  const int n_tiles = gridDim.x / (DP / QN);
  const int tile = causal ? n_tiles - 1 - lin / kvh / (DP / QN) : lin / kvh / (DP / QN);
  const int b = blockIdx.z;
  const int r0 = tile * QR, r1 = min(r0 + QR, n_rows);
  const long long q_stride = (long long)h * d;
  const size_t q_off = ((size_t)b * sq * h + (size_t)g * qpk) * d;
  const uint32_t s_q = repro::smem_u32(tc_smem);
  const uint32_t s_do = s_q + C::kHeld;
  const uint32_t s_st = s_do + C::kHeld;  // the stages of the K / V ring
  uint32_t* s_bits = reinterpret_cast<uint32_t*>(tc_smem + C::kDqBytes);

  if (warp == 0) {  // position range of this tile's tokens
    int lo = INT_MAX, hi = INT_MIN;
    for (int tk = r0 / qpk + lane; tk <= (r1 - 1) / qpk; tk += 32) {
      const int p = q_pos[tk];
      lo = min(lo, p);
      hi = max(hi, p);
    }
    lo = repro::warp_min(lo);
    hi = repro::warp_max(hi);
    if (lane == 0) {
      s_qrange[0] = lo;
      s_qrange[1] = hi;
    }
  }
  for (int i = tid; i < (n_kt + 31) / 32 * 2; i += kT) s_bits[i] = 0u;
  init_stage_barriers(s_full);
  __syncthreads();
  const long long q_lo = s_qrange[0], q_hi = s_qrange[1];
  // visit bitmaps: one warp per key tile, two keys per lane
  for (int t = warp; t < n_kt; t += kT / 32) {
    bool live = false;
    int lo = INT_MAX, hi = INT_MIN;
#pragma unroll
    for (int e = 0; e < kTR; e += 32) {
      const int j = t * kTR + e + lane;
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
      atomicOr(&s_bits[(t >> 5) * 2], 1u << (t & 31));
      const bool inner = (t + 1) * kTR <= sk && (!causal || q_lo >= hi) &&
                         (window <= 0 || q_hi - lo < window);
      if (inner) atomicOr(&s_bits[(t >> 5) * 2 + 1], 1u << (t & 31));
    }
  }
  __syncthreads();

  bool on[2];  // the thread's two q rows (fragment rows): position, lse, delta
  int qpv[2];
  float lse2[2], dl[2];
#pragma unroll
  for (int sl = 0; sl < 2; ++sl) {
    const int fr = r0 + tc::frag_row(sl);
    on[sl] = fr < n_rows;
    const int tok = on[sl] ? fr / qpk : 0;
    const size_t li = ((size_t)b * h + g * qpk + (on[sl] ? fr % qpk : 0)) * sq + tok;
    qpv[sl] = on[sl] ? q_pos[tok] : 0;
    lse2[sl] = on[sl] ? lse[li] * repro::kLog2e : __int_as_float(0x7f800000);
    dl[sl] = on[sl] ? delta[li] : 0.f;
  }
  auto rows = [&](const bf16* base) {
    return [=](int r) -> const bf16* {
      const int fr = r0 + r;
      return fr < n_rows ? base + (fr / qpk) * q_stride + (fr % qpk) * d : nullptr;
    };
  };
  // K / V of key tile t into stage st: one TMA box (8 columns, kTR keys,
  // DP / 8 column blocks, 1, 1) each, zeros past the last key and past d
  auto load_kv = [&](int st, int t) {
    if (tid == 0) {
      const uint32_t bar = repro::smem_u32(&s_full[st]), dst = s_st + st * C::kStage;
      mbar_expect(bar, 2 * C::kTile);
      tma_load(dst, &tm_k, bar, 0, t * kTR, 0, g, b);
      tma_load(dst + C::kTile, &tm_v, bar, 0, t * kTR, 0, g, b);
    }
  };

  const Visits<2> vis{s_bits, n_kt};
  const uint32_t s_qw = s_q + wg * 64 * 16, s_dow = s_do + wg * 64 * 16;  // this warpgroup's rows
  const float c = (softcap > 0.f ? 1.f : scale) * repro::kLog2e;
  float acc[QN / 2];
#pragma unroll
  for (int i = 0; i < QN / 2; ++i) acc[i] = 0.f;
  copy_tile<QR, DP, kT>(s_q, rows(q + q_off), d, q);
  copy_tile<QR, DP, kT>(s_do, rows(dout + q_off), d, q);
  repro::cp_async_commit();  // Q and dO
  int t = vis.next(-1);
  if (t >= 0) load_kv(0, t);
  int st = 0;
  uint32_t parity = 0;  // bit s: the phase of stage s's barrier to wait for
  repro::cp_async_wait<0>();
  tc::fence_async_smem();  // Q and dO came by cp.async
  while (t >= 0) {
    const int nx = vis.next(t);
    mbar_wait(repro::smem_u32(&s_full[st]), (parity >> st) & 1u);
    parity ^= 1u << st;
    __syncthreads();
    if (nx >= 0) load_kv(st ^ 1, nx);  // stage st ^ 1 was read before the barrier
    const uint32_t s_kt = s_st + st * C::kStage, s_vt = s_kt + C::kTile;

    // S = Q K^T and dP = dO V^T (the forward's S product, twice)
    float s[kTR / 2], dp[kTR / 2];
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks) {
      tc::Wgmma<kTR>::ss(s, tc::desc(s_qw + ks * 2 * QR * 16, QR * 16, 128),
                         tc::desc(s_kt + ks * 2 * kTR * 16, kTR * 16, 128), ks);
      tc::Wgmma<kTR>::ss(dp, tc::desc(s_dow + ks * 2 * QR * 16, QR * 16, 128),
                         tc::desc(s_vt + ks * 2 * kTR * 16, kTR * 16, 128), ks);
    }
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(s);
    tc::fence_regs(dp);

    // dS: element 4 j + 2 sl + cc is row slot sl, key 8 j + 2 (t % 4) + cc
    // of the tile; the mask only on boundary tiles
    const bool inner = vis.bit(t, 1);
    auto grads = [&](auto cap) {  // the softcap branch outside the loop
#pragma unroll
      for (int j = 0; j < kTR / 8; ++j) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int key = t * kTR + 8 * j + 2 * (tid & 3) + cc;
          const bool key_on = inner || key < sk;
          const int kpv = inner || !key_on ? 0 : __ldg(k_pos + key);
#pragma unroll
          for (int sl = 0; sl < 2; ++sl) {
            const bool ok = inner || (key_on && on[sl] && (!causal || qpv[sl] >= kpv) &&
                                      (window <= 0 || (long long)qpv[sl] - kpv < window));
            const int i = 4 * j + 2 * sl + cc;
            grad<decltype(cap)::value>(s[i], dp[i], ok, lse2[sl], dl[sl], c, scale,
                                       softcap);
          }
        }
      }
    };
    if (softcap > 0.f)
      grads(std::true_type{});
    else
      grads(std::false_type{});
    uint32_t da[kTR / 16][4];
    to_a(dp, da);

    // dQ += dS K, K read MN-major (the forward's P V read of V)
    tc::wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kTR / 16; ++ks)
      tc::Wgmma<QN>::rs(acc, da[ks], tc::desc(s_kt + cb * (QN / 8) * kTR * 16 + ks * 16 * 16,
                                              128, kTR * 16));
    tc::wgmma_commit();
    tc::wgmma_wait_all();
    tc::fence_regs(acc);
    __syncthreads();  // stage st is free for the next step's copies
    st ^= 1;
    t = nx;
  }
  repro::cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < QN / 2; ++i) acc[i] *= scale;
  const long long q_base = (long long)b * sq * h * d + (long long)g * qpk * d;
  store_bf16<QN>(acc, dq, [&](int r) -> long long {
    const int fr = r0 + r;
    return fr < n_rows ? q_base + (fr / qpk) * q_stride + (long long)(fr % qpk) * d : -1;
  }, cb * QN, d);
}

// ------------------------------------------------------------ launches

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

template <typename T>
int launch_delta(const Args& a) {
  const long long rows = (long long)a.b * a.sq * a.h;
  delta_kernel<T><<<(unsigned)((rows + kThreads / 32 - 1) / (kThreads / 32)),
                    kThreads, 0, a.stream>>>(static_cast<const T*>(a.o),
                                             static_cast<const T*>(a.dout),
                                             a.delta, rows, a.sq, a.h, a.d);
  return (int)cudaGetLastError();
}

template <int DP>
int launch_f32(const Args& a) {
  const float* q = static_cast<const float*>(a.q);
  const float* k = static_cast<const float*>(a.k);
  const float* v = static_cast<const float*>(a.v);
  const float* dout = static_cast<const float*>(a.dout);
  constexpr size_t smem = smem_bytes<DP>();
  auto kv_kern = dkdv_kernel<DP>;
  cudaError_t err = cudaFuncSetAttribute(
      kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kv_kern<<<dim3((a.sk + kBK - 1) / kBK, a.kvh, a.b), kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.q_pos, a.k_pos, static_cast<float*>(a.dk),
      static_cast<float*>(a.dv), a.sq, a.sk, a.h, a.kvh, a.d, a.causal, a.window,
      a.softcap, a.scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  auto q_kern = dq_kernel<DP>;
  err = cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  q_kern<<<dim3((a.sq + kBQ - 1) / kBQ, a.h, a.b), kThreads, smem, a.stream>>>(
      q, k, v, dout, a.lse, a.delta, a.q_pos, a.k_pos, static_cast<float*>(a.dq),
      a.sq, a.sk, a.h, a.kvh, a.d, a.causal, a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

// cuTensorMapEncodeTiled, from the driver through the runtime (no -lcuda)
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult found;
    return cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &f, cudaEnableDefault,
                                   &found) == cudaSuccess &&
                   found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(f)
               : nullptr;
  }();
  return fn;
}

// A 5-D bf16 tensor map without swizzle: dims and box innermost first,
// strides in bytes of dims 1-4; reads past a dim are zeros.
int tensor_map(CUtensorMap* map, const void* base, const cuuint64_t (&dims)[5],
               const cuuint64_t (&strides)[4], const cuuint32_t (&box)[5]) {
  const EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return (int)cudaErrorNotSupported;
  const cuuint32_t ones[5] = {1, 1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5, const_cast<void*>(base), dims,
            strides, box, ones, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) ==
                 CUDA_SUCCESS
             ? 0
             : (int)cudaErrorInvalidValue;
}

template <int DP>
int launch_tc(const Args& a) {
  using C = Tc<DP>;
  const bf16* q = static_cast<const bf16*>(a.q);
  const bf16* k = static_cast<const bf16*>(a.k);
  const bf16* v = static_cast<const bf16*>(a.v);
  const bf16* dout = static_cast<const bf16*>(a.dout);
  const int qpk = a.h / a.kvh, tpt = kTR / qpk;
  const int n_rows = a.sq * qpk;
  // the visit bitmaps after the tiles: kP 32-bit words per 32 tiles
  const long long kv_smem =
      C::kDkdvBytes + ((a.sq + tpt - 1) / tpt + 31) / 32 * (2 * C::kWarpgroups) * 4LL;
  const long long q_smem = C::kDqBytes + ((a.sk + kTR - 1) / kTR + 31) / 32 * 2 * 4LL;
  if (kv_smem > INT_MAX || q_smem > INT_MAX) return (int)cudaErrorInvalidValue;
  // [B, S, heads, D] as (8 columns, S, heads, D / 8 column blocks, B)
  const cuuint64_t e = sizeof(bf16);
  const cuuint64_t q_dims[5] = {8, (cuuint64_t)a.sq, (cuuint64_t)a.h, (cuuint64_t)a.d / 8,
                                (cuuint64_t)a.b};
  const cuuint64_t q_strides[4] = {a.h * a.d * e, a.d * e, 16, (cuuint64_t)a.sq * a.h * a.d * e};
  const int cpb = tpt * qpk == kTR ? DP / 8 : 1;
  const cuuint32_t q_box[5] = {8, (cuuint32_t)tpt, (cuuint32_t)qpk, (cuuint32_t)cpb, 1};
  const cuuint64_t kv_dims[5] = {8, (cuuint64_t)a.sk, (cuuint64_t)a.d / 8, (cuuint64_t)a.kvh,
                                 (cuuint64_t)a.b};
  const cuuint64_t kv_strides[4] = {a.kvh * a.d * e, 16, a.d * e,
                                    (cuuint64_t)a.sk * a.kvh * a.d * e};
  const cuuint32_t kv_box[5] = {8, kTR, DP / 8, 1, 1};
  CUtensorMap tm_q, tm_do, tm_k, tm_v;
  int err = tensor_map(&tm_q, q, q_dims, q_strides, q_box);
  if (err == 0) err = tensor_map(&tm_do, dout, q_dims, q_strides, q_box);
  if (err == 0) err = tensor_map(&tm_k, k, kv_dims, kv_strides, kv_box);
  if (err == 0) err = tensor_map(&tm_v, v, kv_dims, kv_strides, kv_box);
  if (err != 0) return err;

  auto kv_kern = dkdv_tc_kernel<DP>;
  err = (int)cudaFuncSetAttribute(kv_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)kv_smem);
  if (err != 0) return err;
  kv_kern<<<dim3((a.sk + C::kRows - 1) / C::kRows * (DP / C::kDN), a.kvh, a.b),
            C::kThreads, kv_smem, a.stream>>>(
      tm_q, tm_do, k, v, a.lse, a.delta, a.q_pos, a.k_pos, static_cast<bf16*>(a.dk),
      static_cast<bf16*>(a.dv), a.sq, a.sk, a.h, a.kvh, a.d, a.causal, a.window,
      a.softcap, a.scale, cpb);
  err = (int)cudaGetLastError();
  if (err != 0) return err;

  auto q_kern = dq_tc_kernel<DP>;
  err = (int)cudaFuncSetAttribute(q_kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)q_smem);
  if (err != 0) return err;
  q_kern<<<dim3((n_rows + C::kRows - 1) / C::kRows * (DP / C::kQN), a.kvh, a.b),
           C::kThreads, q_smem, a.stream>>>(tm_k, tm_v, q, dout, a.lse, a.delta,
                                            a.q_pos, a.k_pos, static_cast<bf16*>(a.dq),
                                            a.sq, a.sk, a.h, a.kvh, a.d, a.causal,
                                            a.window, a.softcap, a.scale);
  return (int)cudaGetLastError();
}

int launch_all(const Args& a, int dtype) {
  if (dtype == 0) {  // f32: the fp32-FMA bodies
    const int err = launch_delta<float>(a);
    if (err != 0) return err;
    if (a.d <= 32) return launch_f32<32>(a);
    if (a.d <= 64) return launch_f32<64>(a);
    if (a.d <= 96) return launch_f32<96>(a);
    if (a.d <= 128) return launch_f32<128>(a);
    return launch_f32<256>(a);
  }
  // bf16: the tensor cores
  if (((uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v | (uintptr_t)a.dout |
       (uintptr_t)a.dq | (uintptr_t)a.dk | (uintptr_t)a.dv) & 15)
    return (int)cudaErrorMisalignedAddress;
  if ((long long)a.sq * (a.h / a.kvh) > INT_MAX - 128)
    return (int)cudaErrorInvalidValue;
  const int err = launch_delta<bf16>(a);
  if (err != 0) return err;
  switch (tc::head_template(a.d)) {
    case 64: return launch_tc<64>(a);
    case 80: return launch_tc<80>(a);
    case 128: return launch_tc<128>(a);
    default: return launch_tc<256>(a);
  }
}

}  // namespace

extern "C" {

// q / o / dout / dq [b, sq, h, d], k / v / dk / dv [b, sk, kvh, d],
// contiguous, all of one dtype (0 = float32, 1 = bfloat16); lse [b, h, sq]
// f32 from the forward (striped_attention.cu); delta [b, h, sq] f32
// scratch; q_pos [sq] and k_pos [sk] int32 in any order.  causal, window
// and softcap as in repro_striped_attention.  Requires d % 8 == 0, d <=
// 256, h % kvh == 0, h / kvh <= 64, b <= 65535 and sq, sk >= 1; for
// bfloat16 also 16-byte-aligned q, k, v, dout, dq, dk and dv.  Writes dq,
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
      h / kvh > 64 || b < 1 || b > 65535 || sq < 1 || sk < 1 || h > 65535 ||
      (dtype != 0 && dtype != 1))
    return (int)cudaErrorInvalidValue;
  const Args a{q, k, v, o, dout, lse, q_pos, k_pos, dq, dk, dv, delta, b, sq,
               sk, h, kvh, d, causal, window, softcap, scale,
               static_cast<cudaStream_t>(stream)};
  return launch_all(a, dtype);
}

const char* repro_striped_attention_bwd_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

}  // extern "C"
