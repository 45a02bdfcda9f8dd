// Split-K decode core for Hopper (sm_90a), shared by K2 (paged_decode.cu)
// and K5 (flash_decode.cu).
//
// Replaces the loop of the Pallas TPU kernels
// src/repro/kernels/paged_flash_decode.py::paged_flash_decode_partial (K2)
// and src/repro/kernels/flash_decode.py::flash_decode_partial (K5): one
// query token per row attends the row's valid keys, and the kernel returns
// the UNNORMALIZED partial (o, m, l) in f32.  The two kernels differ only in
// how key j of row b is addressed — the `Rows` policy each source defines
// (`range` of a row's valid keys, `base` row, `kTable`): K2 goes through the
// block table into the paged pool and tests the window per slot, K5 reads
// row b * S + j of a dense shard.
//
// Bound on this card: bytes.  Every valid key is read once per KV head (K
// and V, 2 * D * sizeof(kv) bytes) for 4 * q_per_kv * D FLOPs: at most 4
// FLOPs per byte for the served models (q_per_kv <= 4) against the card's
// ~295 for bf16.  The only lever is how many bytes are in flight, on how
// many SMs.
//
// Design.
//   * Split-K.  The host planner (kernels/decode_split.py) cuts each row's
//     key range [lo, hi) into n_splits splits of `chunk` keys (a whole number
//     of 64-key tiles), from shapes alone, so that B x KVH x n_splits CTAs
//     cover the SMs; the grid is (B, KVH x row blocks, n_splits), B on x
//     because the unified step brings thousands of rows.  A CTA whose split
//     starts at or past hi writes the empty partial.  With one split the CTA
//     writes (o, m, l) directly; otherwise it writes its partial into a
//     workspace [n_splits, B, H, D + 2] and merge_kernel folds the splits by
//     log-sum-exp (an online one per warp, then across the warps).  No atomics: the same shapes give the same plan and the
//     same sums, run to run.
//   * Copies.  K and V stages of kSk keys (64; fewer where a key row is
//     wider than 256 bytes, so that a stage holds at most 32 KB) stream
//     through a ring of kStages = 3 in shared memory by 16-byte cp.async:
//     two stages are in flight while the third computes, and keys past the
//     split are zero-filled.  A thread always copies the same 16-byte column
//     of kCpt keys of a stage.  The first copies go out before q is read.
//     K2's block-table entries of stage x + 2 ride in stage x's copy group
//     (4-byte cp.async into shared memory), so no table read ever stalls
//     the ring: at page size 1 every stage needs a new cache line of them.
//   * Scores.  A key row is covered by kLg lanes (a "group"); each lane
//     holds its 16-byte slice of every q row in registers, and a score is
//     the slices' dot products reduced by __shfl_xor_sync across the group.
//     Shared memory is read only as 16-byte vectors.  The 256 / kLg groups
//     of a CTA (8 warps) take interleaved keys of each stage.
//   * Softmax and P V.  Each group keeps its own online-softmax state (m, l
//     and its slices of o, per q row) in registers, rescaled once per kKb
//     keys; at the end the CTA merges its groups in shared memory.
//   * No tensor cores: at q_per_kv <= 4 the fp32 FMAs have room to spare.
//     A CTA carries one or two q rows of a GQA group; a wider group runs in
//     row blocks of two, each copying the K/V tiles again (from L2 for all
//     but the first, whose CTA is launched next to it).  Measured on the
//     H100 (tools/decode_probe.py): at q_per_kv = 4, two blocks of two rows
//     beat one of four, whose 149 registers and serial shuffle chains left
//     too few warps per SM to hide the latency of its FMAs and shuffles.
//
// The conventions are the reference's: masked scores -1e30, exp() against
// m_safe = max(m, -1e29), the tanh softcap on the scaled score, and a row
// with no valid key gives m = -inf, l = 0 and o = 0.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "common.cuh"

namespace repro {
namespace decode {
namespace {

constexpr int kThreads = 256;
constexpr int kTile = 64;           // keys per planning tile; a split is a multiple
constexpr int kStages = 3;          // ring depth: two stages in flight, one computing
constexpr int kStageBytes = 32768;  // K + V bytes of one stage, at most

// Launch arguments of pass 1.
struct Params {
  const void* q;          // [b, h, d], f32 or bf16 (q_bf16)
  const void* k;          // K5: [b, s, kvh, d]; K2: [n_pages * page_size, kvh, d]
  const void* v;
  const int* lengths;     // [b]
  const int* table;       // K2: [b, max_pages]
  const int* page_pos;    // K2, windowed: [n_pages * page_size]
  const int* query_pos;   // K2, windowed: [b]
  float* o;               // [b, h, d]
  float* m;               // [b, h]
  float* l;               // [b, h]
  float* ws;              // [n_splits, b, h, d + 2] when n_splits > 1
  int b, h, kvh, d, qpk;  // qpk = h / kvh
  int s, offset;          // K5: shard length, global position of its first key
  int page_size, max_pages;  // K2
  int window;             // <= 0: none
  int chunk, n_splits;    // keys per split (a multiple of kTile), splits per row
  int q_bf16;
  float softcap, scale;   // softcap <= 0: none
};

// Shape of the work for a KV dtype and head-size template DP (32, 64, 128
// or 256; the real head size d <= DP, d % 8 == 0).
template <typename TKV, int DP>
struct Shape {
  static constexpr int kVec = 16 / (int)sizeof(TKV);   // elements per 16-byte copy
  static constexpr int kNvp = DP / kVec;               // 16-byte columns of a DP row
  static constexpr int kLg = kNvp < 32 ? kNvp : 32;    // lanes per key row (a group)
  static constexpr int kNv = kNvp / kLg;               // columns per lane
  static constexpr int kE = kNv * kVec;                // elements per lane
  static constexpr int kGroups = kThreads / kLg;       // key rows in flight per CTA
  static constexpr int kSkFit = kStageBytes / (2 * DP * (int)sizeof(TKV));
  static constexpr int kSk = kSkFit < kTile ? kSkFit : kTile;  // keys per stage
  static constexpr int kKpg = kSk / kGroups;           // keys per group per stage
  static constexpr int kCpt = kSk * kNvp / kThreads;   // copies per thread, tensor, stage
  static constexpr int kKeyStride = kThreads / kNvp;   // keys between a thread's copies
  static constexpr int kTabLen = kSk + 1;              // block-table entries a stage spans
  static_assert(kKpg >= 1 && kCpt >= 1 && kTile % kSk == 0, "stage shape");
};

// 16 bytes of shared memory, widened to f32
__device__ __forceinline__ void widen16(const float* src, float* dst) {
  const float4 x = *reinterpret_cast<const float4*>(src);
  dst[0] = x.x;
  dst[1] = x.y;
  dst[2] = x.z;
  dst[3] = x.w;
}
__device__ __forceinline__ void widen16(const __nv_bfloat16* src, float* dst) {
  const uint4 x = *reinterpret_cast<const uint4*>(src);
  const uint32_t w[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {  // element 2i is the low half of word i
    dst[2 * i] = __uint_as_float(w[i] << 16);
    dst[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// this lane's columns of one key row (zeros past the real head size)
template <class S, typename TKV>
__device__ __forceinline__ void load_cols(const TKV* row, int lane_g, int nvr,
                                          float (&out)[S::kE]) {
#pragma unroll
  for (int j = 0; j < S::kNv; ++j) {
    const int col = lane_g + j * S::kLg;
    if (col < nvr) {
      widen16(row + col * S::kVec, out + j * S::kVec);
    } else {
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) out[j * S::kVec + e] = 0.f;
    }
  }
}

// sum over the LG lanes of a group; every lane gets the same bits
template <int LG>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int w = LG / 2; w > 0; w >>= 1) x += __shfl_xor_sync(0xffffffffu, x, w);
  return x;
}

// Pass 1: the partial of rows row0 .. row0 + RQ - 1 of KV head g of row b
// over split blockIdx.z of the row's keys.
template <class Rows, typename TKV, int DP, int RQ>
__global__ void __launch_bounds__(kThreads) split_kernel(const Params p) {
  using S = Shape<TKV, DP>;
  constexpr int kKb = S::kKpg < 16 / RQ ? S::kKpg : 16 / RQ;  // keys per softmax update
  extern __shared__ __align__(16) unsigned char dec_smem[];

  const int b = blockIdx.x, split = blockIdx.z, tid = threadIdx.x;
  const int n_rb = (p.qpk + RQ - 1) / RQ;
  const int g = blockIdx.y / n_rb;            // KV head
  const int row0 = (blockIdx.y % n_rb) * RQ;  // first q row of its GQA group
  const int d = p.d, nvr = d / S::kVec;       // real 16-byte columns of a row
  const size_t head0 = (size_t)b * p.h + (size_t)g * p.qpk + row0;

  // where the partial goes: the outputs, or this split's workspace slice
  const bool direct = p.n_splits == 1;
  const int ostride = direct ? d : d + 2, mlstride = direct ? 1 : d + 2;
  float* o_dst = direct ? p.o : p.ws + (size_t)split * p.b * p.h * (d + 2);
  float* m_dst = direct ? p.m : o_dst + d;
  float* l_dst = direct ? p.l : o_dst + d + 1;

  int lo, hi;
  Rows::range(p, b, lo, hi);
  const int s_lo = lo + split * p.chunk;
  const int s_hi = min(hi, s_lo + p.chunk);
  if (s_lo >= s_hi) {  // no key of this row in this split: the empty partial
    for (int idx = tid; idx < RQ * d; idx += kThreads) {
      const int r = idx / d;
      if (row0 + r < p.qpk) o_dst[(head0 + r) * ostride + idx % d] = 0.f;
    }
    if (tid < RQ && row0 + tid < p.qpk) {
      m_dst[(head0 + tid) * mlstride] = neg_inf();
      l_dst[(head0 + tid) * mlstride] = 0.f;
    }
    return;
  }
  const int nst = (s_hi - s_lo + S::kSk - 1) / S::kSk;  // stages of this split

  // shared memory: the ring of n_alloc stages (stage x: its K tile, then its
  // V tile, rows of d elements); then, K2 windowed, the page positions of
  // each stage's keys; then, K2, the block-table entries of kStages stages
  const int n_alloc = min(kStages, p.chunk / S::kSk);
  const int tile_elems = S::kSk * d;
  const bool slot_window = Rows::kTable && p.window > 0;
  TKV* ring = reinterpret_cast<TKV*>(dec_smem);
  int* s_pos = reinterpret_cast<int*>(ring + (size_t)n_alloc * 2 * tile_elems);
  int* s_tab = s_pos + (slot_window ? n_alloc * S::kSk : 0);
  const int* trow = Rows::kTable ? p.table + (size_t)b * p.max_pages : nullptr;

  // copies: this thread's 16-byte column vc of keys c0 + i * kKeyStride
  const int vc = tid % S::kNvp, c0 = tid / S::kNvp;
  const size_t rbase = Rows::base(p, b), row_elems = (size_t)p.kvh * d;
  const TKV* kg = static_cast<const TKV*>(p.k) + (size_t)g * d + vc * S::kVec;
  const TKV* vg = static_cast<const TKV*>(p.v) + (size_t)g * d + vc * S::kVec;

  // rows of this thread's keys of stage x, -1 past the split.  K2: pool
  // slots through the block table — read from global memory for the first
  // stages, afterwards from the entries that stage x - 2's copy group
  // brought into s_tab (x % kStages).
  auto rows_of = [&](int x, bool from_global, int (&rows)[S::kCpt]) {
    const int j0 = s_lo + x * S::kSk;
    const int e0 = Rows::kTable ? j0 / p.page_size : 0;  // first entry of the stage
    const int* tab = s_tab + (x % kStages) * S::kTabLen;
#pragma unroll
    for (int i = 0; i < S::kCpt; ++i) {
      const int j = j0 + c0 + i * S::kKeyStride;
      if (!Rows::kTable || j >= s_hi) {
        rows[i] = j < s_hi ? j : -1;
      } else if (p.page_size == 1) {
        rows[i] = from_global ? __ldg(trow + j) : tab[j - e0];
      } else {
        const int e = j / p.page_size;
        rows[i] = (from_global ? __ldg(trow + e) : tab[e - e0]) * p.page_size +
                  j % p.page_size;
      }
    }
  };
  auto issue = [&](int x, const int (&rows)[S::kCpt]) {
    if (x >= nst) return;
    const int slot = x % kStages;
    TKV* kt = ring + (size_t)slot * 2 * tile_elems;
    TKV* vt = kt + tile_elems;
#pragma unroll
    for (int i = 0; i < S::kCpt; ++i) {
      const int c = c0 + i * S::kKeyStride;
      const bool ok = rows[i] >= 0;
      const size_t off = (rbase + (ok ? rows[i] : 0)) * row_elems;
      if (vc < nvr) {
        cp_async16(smem_u32(kt + c * d + vc * S::kVec), kg + off, ok);
        cp_async16(smem_u32(vt + c * d + vc * S::kVec), vg + off, ok);
      }
      if (slot_window && vc == 0)
        cp_async4(smem_u32(s_pos + slot * S::kSk + c), p.page_pos + (ok ? rows[i] : 0), ok);
    }
    if (Rows::kTable && x + kStages - 1 < nst) {  // the table entries of stage x + 2
      const int y = x + kStages - 1;
      const int e0 = (s_lo + y * S::kSk) / p.page_size;
      const int n_e = (min(s_hi, s_lo + (y + 1) * S::kSk) - 1) / p.page_size - e0 + 1;
      if (tid < n_e)
        cp_async4(smem_u32(s_tab + (y % kStages) * S::kTabLen + tid), trow + e0 + tid, true);
    }
  };

  // the first stages' copies go out before anything else is read
  {
    int rows[kStages - 1][S::kCpt];
#pragma unroll
    for (int x = 0; x < kStages - 1; ++x) rows_of(x, true, rows[x]);
#pragma unroll
    for (int x = 0; x < kStages - 1; ++x) {
      issue(x, rows[x]);
      cp_async_commit();
    }
  }
  const int qp = slot_window ? p.query_pos[b] : 0;

  // the q rows scaled by 1 / sqrt(d), this lane's columns, in registers
  const int lane_g = tid % S::kLg, grp = tid / S::kLg;
  float qr[RQ][S::kE], acc[RQ][S::kE], mrow[RQ], lrow[RQ];
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
#pragma unroll
    for (int j = 0; j < S::kNv; ++j) {
      const int col = lane_g + j * S::kLg;
#pragma unroll
      for (int e = 0; e < S::kVec; ++e) {
        float x = 0.f;
        if (col < nvr && row0 + r < p.qpk) {
          const size_t qi = (head0 + r) * d + col * S::kVec + e;
          x = p.scale * (p.q_bf16 ? to_f32(static_cast<const __nv_bfloat16*>(p.q)[qi])
                                  : static_cast<const float*>(p.q)[qi]);
        }
        qr[r][j * S::kVec + e] = x;
        acc[r][j * S::kVec + e] = 0.f;
      }
    }
    mrow[r] = neg_inf();
    lrow[r] = 0.f;
  }

  auto compute = [&](int x) {
    const int slot = x % kStages;
    const TKV* kt = ring + (size_t)slot * 2 * tile_elems;
    const TKV* vt = kt + tile_elems;
    const int n_valid = min(S::kSk, s_hi - (s_lo + x * S::kSk));
#pragma unroll
    for (int u = 0; u < S::kKpg; u += kKb) {
      float sc[RQ][kKb];
      bool any = false;  // the same in every lane of the group
#pragma unroll
      for (int kb = 0; kb < kKb; ++kb) {
        const int c = grp + (u + kb) * S::kGroups;
        float kf[S::kE];
        load_cols<S>(kt + c * d, lane_g, nvr, kf);
        bool ok = c < n_valid;
        if (slot_window) ok = ok && qp - s_pos[slot * S::kSk + c] < p.window;
        any |= ok;
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
          float part = 0.f;
#pragma unroll
          for (int e = 0; e < S::kE; ++e) part = fmaf(qr[r][e], kf[e], part);
          float s = group_sum<S::kLg>(part);
          if (p.softcap > 0.f) s = p.softcap * tanhf(s / p.softcap);
          sc[r][kb] = ok ? s : kNegInf;
        }
      }
      if (!any) continue;
      float pr[RQ][kKb];
#pragma unroll
      for (int r = 0; r < RQ; ++r) {
        float mb = sc[r][0];
#pragma unroll
        for (int kb = 1; kb < kKb; ++kb) mb = fmaxf(mb, sc[r][kb]);
        const float mn = fmaxf(mrow[r], mb);
        const float ms = fmaxf(mn, -1e29f);
        const float alpha = ex2((mrow[r] - ms) * kLog2e);  // 0 while the row is empty
        const float ms2 = ms * kLog2e;
        lrow[r] *= alpha;
#pragma unroll
        for (int e = 0; e < S::kE; ++e) acc[r][e] *= alpha;
#pragma unroll
        for (int kb = 0; kb < kKb; ++kb) {
          pr[r][kb] = ex2(fmaf(sc[r][kb], kLog2e, -ms2));  // a masked key: exactly 0
          lrow[r] += pr[r][kb];
        }
        mrow[r] = mn;
      }
#pragma unroll
      for (int kb = 0; kb < kKb; ++kb) {
        float vf[S::kE];
        load_cols<S>(vt + (grp + (u + kb) * S::kGroups) * d, lane_g, nvr, vf);
#pragma unroll
        for (int r = 0; r < RQ; ++r) {
#pragma unroll
          for (int e = 0; e < S::kE; ++e) acc[r][e] = fmaf(pr[r][kb], vf[e], acc[r][e]);
        }
      }
    }
  };

  // the ring: stage t computes while stages t + 1 and t + 2 are in flight
  for (int t = 0; t < nst; ++t) {
    cp_async_wait<kStages - 2>();  // this thread's copies of stage t landed
    __syncthreads();               // everyone's; and stage t - 1 is consumed
    {
      int rows[S::kCpt];
      rows_of(t + kStages - 1, false, rows);
      issue(t + kStages - 1, rows);  // into the slot stage t - 1 used
    }
    cp_async_commit();
    compute(t);
  }
  cp_async_wait<0>();
  __syncthreads();  // the ring is free: merge the groups in its place

  float* s_acc = reinterpret_cast<float*>(dec_smem);  // [kGroups][RQ][d]
  float* s_ml = s_acc + S::kGroups * RQ * d;          // [kGroups][RQ] (m, l)
  float* s_w = s_ml + 2 * S::kGroups * RQ;            // [RQ][kGroups] weights
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
#pragma unroll
    for (int j = 0; j < S::kNv; ++j) {
      const int col = lane_g + j * S::kLg;
      if (col < nvr) {
#pragma unroll
        for (int e = 0; e < S::kVec; ++e)
          s_acc[(grp * RQ + r) * d + col * S::kVec + e] = acc[r][j * S::kVec + e];
      }
    }
    if (lane_g == 0) {
      s_ml[2 * (grp * RQ + r)] = mrow[r];
      s_ml[2 * (grp * RQ + r) + 1] = lrow[r];
    }
  }
  __syncthreads();
  if (tid < RQ) {
    const int r = tid;
    float mx = neg_inf();
    for (int gg = 0; gg < S::kGroups; ++gg) mx = fmaxf(mx, s_ml[2 * (gg * RQ + r)]);
    const float ms = fmaxf(mx, -1e29f);
    float lsum = 0.f;
    for (int gg = 0; gg < S::kGroups; ++gg) {
      const float w = expf(s_ml[2 * (gg * RQ + r)] - ms);  // an empty group: 0
      s_w[r * S::kGroups + gg] = w;
      lsum = fmaf(w, s_ml[2 * (gg * RQ + r) + 1], lsum);
    }
    if (row0 + r < p.qpk) {
      m_dst[(head0 + r) * mlstride] = mx == neg_inf() ? mx : ms;
      l_dst[(head0 + r) * mlstride] = lsum;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < RQ * d; idx += kThreads) {
    const int r = idx / d, dd = idx % d;
    if (row0 + r >= p.qpk) continue;
    float a = 0.f;
    for (int gg = 0; gg < S::kGroups; ++gg)
      a = fmaf(s_w[r * S::kGroups + gg], s_acc[(gg * RQ + r) * d + dd], a);
    o_dst[(head0 + r) * ostride + dd] = a;
  }
}

// Pass 2: fold the n_splits partials of row (blockIdx.x, head blockIdx.y)
// by log-sum-exp.  Warp w walks splits w, w + 8, ... with an online
// log-sum-exp of its own (m, l and the head-size columns lane + 32 j), so
// every load of a split is independent of the others; then the 8 warps'
// states are folded in shared memory in a fixed order (the same bits run to
// run): m = max_w m_w, a_w = exp(m_w - max(m, -1e29)), l = sum a_w l_w,
// o = sum a_w o_w.  All splits empty gives m = -inf, l = 0, o = 0.
constexpr int kMergeWarps = 8;

__global__ void __launch_bounds__(32 * kMergeWarps) merge_kernel(
    const float* __restrict__ ws, float* __restrict__ o, float* __restrict__ m,
    float* __restrict__ l, int b, int h, int d, int n_splits) {
  extern __shared__ __align__(16) unsigned char dec_smem[];
  float* s_o = reinterpret_cast<float*>(dec_smem);  // [kMergeWarps][d]
  float* s_ml = s_o + kMergeWarps * d;               // [kMergeWarps] (m, l)
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const size_t row = (size_t)blockIdx.x * h + blockIdx.y;
  const size_t sstride = (size_t)b * h * (d + 2);
  const float* src = ws + row * (d + 2);
  float mw = neg_inf(), lw = 0.f, acc[8];  // columns lane + 32 j (d <= 256)
#pragma unroll
  for (int j = 0; j < 8; ++j) acc[j] = 0.f;
#pragma unroll 4
  for (int i = warp; i < n_splits; i += kMergeWarps) {
    const float* s = src + i * sstride;
    const float mi = s[d], li = s[d + 1];
    float oi[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) oi[j] = lane + 32 * j < d ? s[lane + 32 * j] : 0.f;
    if (mi == neg_inf()) continue;  // an empty split adds nothing
    const float mn = fmaxf(mw, mi);
    const float a = expf(mw - mn), w = expf(mi - mn);  // a = 0 while empty
    lw = fmaf(lw, a, w * li);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = fmaf(acc[j], a, w * oi[j]);
    mw = mn;
  }
#pragma unroll
  for (int j = 0; j < 8; ++j)
    if (lane + 32 * j < d) s_o[warp * d + lane + 32 * j] = acc[j];
  if (lane == 0) {
    s_ml[2 * warp] = mw;
    s_ml[2 * warp + 1] = lw;
  }
  __syncthreads();
  float mx = neg_inf();
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) mx = fmaxf(mx, s_ml[2 * w]);
  const float ms = fmaxf(mx, -1e29f);
  float wt[kMergeWarps];
#pragma unroll
  for (int w = 0; w < kMergeWarps; ++w) wt[w] = expf(s_ml[2 * w] - ms);
  for (int dd = tid; dd < d; dd += 32 * kMergeWarps) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) a = fmaf(wt[w], s_o[w * d + dd], a);
    o[row * d + dd] = a;
  }
  if (tid == 0) {
    float ls = 0.f;
#pragma unroll
    for (int w = 0; w < kMergeWarps; ++w) ls = fmaf(wt[w], s_ml[2 * w + 1], ls);
    m[row] = mx == neg_inf() ? mx : ms;
    l[row] = ls;
  }
}

template <class Rows, typename TKV, int DP, int RQ>
int launch_split(const Params& p, cudaStream_t st) {
  using S = Shape<TKV, DP>;
  const int n_alloc = p.chunk / S::kSk < kStages ? p.chunk / S::kSk : kStages;
  const bool pos = Rows::kTable && p.window > 0;
  const size_t ring = (size_t)n_alloc * S::kSk *
                          (2 * (size_t)p.d * sizeof(TKV) + (pos ? sizeof(int) : 0)) +
                      (Rows::kTable ? sizeof(int) * kStages * S::kTabLen : 0);
  const size_t scratch = sizeof(float) * (size_t)S::kGroups * RQ * (p.d + 3);
  const size_t smem = ring > scratch ? ring : scratch;
  auto kern = split_kernel<Rows, TKV, DP, RQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.b, p.kvh * ((p.qpk + RQ - 1) / RQ), p.n_splits);
  kern<<<grid, kThreads, smem, st>>>(p);
  return (int)cudaGetLastError();
}

template <class Rows, typename TKV, int DP>
int launch_rq(const Params& p, int rq, cudaStream_t st) {
  return rq == 1 ? launch_split<Rows, TKV, DP, 1>(p, st)
                 : launch_split<Rows, TKV, DP, 2>(p, st);
}

template <class Rows, typename TKV>
int launch_dp(const Params& p, int rq, cudaStream_t st) {
  if (p.d <= 32) return launch_rq<Rows, TKV, 32>(p, rq, st);
  if (p.d <= 64) return launch_rq<Rows, TKV, 64>(p, rq, st);
  if (p.d <= 128) return launch_rq<Rows, TKV, 128>(p, rq, st);
  return launch_rq<Rows, TKV, 256>(p, rq, st);
}

// Check what pass 1 takes and launch it: rq q rows per CTA (1 or 2),
// KV bf16 or f32; k and v must be 16-byte aligned (the copies are).
template <class Rows>
int launch(const Params& p, int kv_bf16, int rq, cudaStream_t st) {
  const uintptr_t addr = reinterpret_cast<uintptr_t>(p.k) | reinterpret_cast<uintptr_t>(p.v);
  if (p.b < 1 || p.kvh < 1 || p.h != p.kvh * p.qpk || p.qpk < 1 || p.qpk > 64 ||
      p.d < 8 || p.d > 256 || p.d % 8 != 0 || p.chunk < kTile || p.chunk % kTile != 0 ||
      p.n_splits < 1 || (p.n_splits > 1 && p.ws == nullptr) ||
      (rq != 1 && rq != 2) || (addr & 15) != 0 || kv_bf16 < 0 || kv_bf16 > 1 ||
      p.q_bf16 < 0 || p.q_bf16 > 1)
    return (int)cudaErrorInvalidValue;
  return kv_bf16 ? launch_dp<Rows, __nv_bfloat16>(p, rq, st)
                 : launch_dp<Rows, float>(p, rq, st);
}

int launch_merge(const float* ws, float* o, float* m, float* l, int b, int h,
                 int d, int n_splits, cudaStream_t st) {
  if (ws == nullptr || b < 1 || h < 1 || d < 1 || d > 256 || n_splits < 2)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * (size_t)kMergeWarps * (d + 2);
  merge_kernel<<<dim3(b, h), 32 * kMergeWarps, smem, st>>>(ws, o, m, l, b, h, d,
                                                          n_splits);
  return (int)cudaGetLastError();
}

}  // namespace
}  // namespace decode
}  // namespace repro
