// Tensor-core attention core for Hopper (sm_90a), shared by K4
// (striped_attention.cu) and the K1/K3 body (flash_prefill.cu) when their
// operands are bf16.  Their f32 instantiations keep the fp32-FMA bodies:
// tensor cores would round f32 operands to TF32.
//
// One CTA is two or three warpgroups (Cta<DP>) that own 64 rows each: the
// q_per_kv q heads of one KV head for consecutive tokens, so every K/V tile
// is shared across the GQA group and by all warpgroups; each warpgroup runs
// wgmma (M = 64) on its own rows.  Copying K/V tiles from L2, not the
// products or the softmax, set the time of a one-warpgroup CTA on the
// H100, so more warpgroups per CTA mean fewer K/V bytes per FLOP.
//
//   * Q is staged once into shared memory as bf16.  K/V tiles of kBK = 64
//     keys stream through a ring of kStages = 2 stages filled with 16-byte
//     cp.async copies (zero-filled past the last key and past the head size):
//     the next tile's copy is in flight while the current one computes.
//     The copies write the no-swizzle layout below directly; TMA would need
//     the 128-byte swizzled layout instead.
//   * S = Q K^T is wgmma m64n64k16 with both operands read from shared
//     memory (K-major) into f32 registers.  The scale, the tanh softcap and
//     the online softmax run on the accumulator fragment: a row lives in
//     the four threads of a quad, so row reductions are two xor-shuffles.
//     The mask is applied only on tiles the caller flags as boundary tiles.
//   * O += P V is wgmma m64nDPk16 with P rounded to bf16 in registers (the
//     accumulator fragment of S is the A fragment of the next product) and
//     V read MN-major (transposed) from shared memory.  The row sum l is
//     taken from the f32 P, so only P V sees the bf16 rounding.
//
// Shared-memory tiles use wgmma's layout without swizzle: a tile of R rows x
// DP columns is DP / 8 column blocks of R rows x 16 bytes, element (row, c)
// at byte (c / 8) * R * 16 + row * 16 + (c % 8) * 2.  Each 8 x 16-byte core
// matrix is 128 contiguous bytes, so wgmma reads it without bank conflicts
// and the K and V tiles share one layout: K is read K-major (core matrices
// 128 bytes apart along keys, R * 16 along the head dim), V MN-major (the
// same offsets with the roles of the two strides swapped).
//
// The softmax gives the reference's results: a masked score's weight is
// exactly 0 (the score is set to -inf before the exponent where the
// reference uses -1e30), exp() is taken against m_safe = max(m, -1e29), and
// a row that sees no key keeps m = -inf, l = 0 and o = 0.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

#include "common.cuh"

namespace repro {
namespace tc {

using bf16 = __nv_bfloat16;

constexpr int kBK = 64;     // keys per K/V tile: the S product's N
constexpr int kStages = 2;  // K/V tiles resident: one computes, one loads

// CTA shape for head-size template DP.  Every warpgroup of a CTA shares its
// K/V tiles, so the shape that keeps the most rows resident per SM copies
// the fewest K/V bytes per FLOP.  A thread needs about DP / 2 + 100
// registers: at DP <= 80 two CTAs of two warpgroups fit an SM (256 rows), at
// DP = 128 one CTA of three (192), at DP = 256 one of two (128).
template <int DP>
struct Cta {
  static constexpr int kWarpgroups = DP == 128 ? 3 : 2;
  static constexpr int kRows = 64 * kWarpgroups;  // (q token, q head) rows
  static constexpr int kThreads = 128 * kWarpgroups;
  // CTAs per SM that the kernels' registers must allow (__launch_bounds__)
  static constexpr int kMinBlocks = DP <= 80 ? 2 : 1;
};

// dynamic shared memory of one CTA for head-size template DP
template <int DP>
struct Smem {
  static_assert(DP % 16 == 0 && DP <= 256, "DP: a multiple of 16 up to 256");
  static constexpr int kQ = Cta<DP>::kRows * DP * 2;
  static constexpr int kTile = kBK * DP * 2;
  static constexpr int kStage = 2 * kTile;  // the K tile, then the V tile
  static constexpr int kBytes = kQ + kStages * kStage;
};

// the head-size template a bf16 launch runs for head size d
__host__ __device__ constexpr int head_template(int d) {
  return d <= 64 ? 64 : d <= 80 ? 80 : d <= 128 ? 128 : 256;
}

// ---------------------------------------------------------------- PTX

// make this thread's generic-proxy shared-memory writes (cp.async) visible
// to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keep the compiler from moving accumulator accesses across an async wgmma
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

// shared-memory matrix descriptor, no swizzle: start address, leading byte
// offset (between core matrices adjacent along K) and stride byte offset
// (between core matrices adjacent along M or N), in 16-byte units
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// smem_u32, cp_async16, cp_async_commit, cp_async_wait, kLog2e and ex2:
// common.cuh

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// ---------------------------------------------------------------- wgmma

// m64nNk16 with f32 accumulators d[0 .. N/2 - 1] and bf16 operands.  ss: A
// and B both K-major in shared memory; `accumulate` == 0 overwrites D.  rs:
// A from registers (the four 32-bit registers of the m16n8k16 A fragment of
// the thread's warp, passed as two 64-bit pairs), B from shared memory read
// MN-major (transposed), D accumulated.  Both forms put three operands first
// (%0 - %2), so the accumulators are %3 .. %(N / 2 + 2) for every N, eight
// per row of this table: row k holds those of d[8k .. 8k + 7].
#define REPRO_R0 "%3, %4, %5, %6, %7, %8, %9, %10"
#define REPRO_R1 "%11, %12, %13, %14, %15, %16, %17, %18"
#define REPRO_R2 "%19, %20, %21, %22, %23, %24, %25, %26"
#define REPRO_R3 "%27, %28, %29, %30, %31, %32, %33, %34"
#define REPRO_R4 "%35, %36, %37, %38, %39, %40, %41, %42"
#define REPRO_R5 "%43, %44, %45, %46, %47, %48, %49, %50"
#define REPRO_R6 "%51, %52, %53, %54, %55, %56, %57, %58"
#define REPRO_R7 "%59, %60, %61, %62, %63, %64, %65, %66"
#define REPRO_R8 "%67, %68, %69, %70, %71, %72, %73, %74"
#define REPRO_R9 "%75, %76, %77, %78, %79, %80, %81, %82"
#define REPRO_R10 "%83, %84, %85, %86, %87, %88, %89, %90"
#define REPRO_R11 "%91, %92, %93, %94, %95, %96, %97, %98"
#define REPRO_R12 "%99, %100, %101, %102, %103, %104, %105, %106"
#define REPRO_R13 "%107, %108, %109, %110, %111, %112, %113, %114"
#define REPRO_R14 "%115, %116, %117, %118, %119, %120, %121, %122"
#define REPRO_R15 "%123, %124, %125, %126, %127, %128, %129, %130"
#define REPRO_REGS4 REPRO_R0 ", " REPRO_R1 ", " REPRO_R2 ", " REPRO_R3
#define REPRO_REGS5 REPRO_REGS4 ", " REPRO_R4
#define REPRO_REGS8 REPRO_REGS5 ", " REPRO_R5 ", " REPRO_R6 ", " REPRO_R7
#define REPRO_REGS16 REPRO_REGS8 ", " REPRO_R8 ", " REPRO_R9 ", " REPRO_R10 ", " \
    REPRO_R11 ", " REPRO_R12 ", " REPRO_R13 ", " REPRO_R14 ", " REPRO_R15
// the accumulator operands d[i] .. d[i + 7], and those of G rows of eight
#define REPRO_ACC8(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]), \
    "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])
#define REPRO_ACCS4 REPRO_ACC8(0), REPRO_ACC8(8), REPRO_ACC8(16), REPRO_ACC8(24)
#define REPRO_ACCS5 REPRO_ACCS4, REPRO_ACC8(32)
#define REPRO_ACCS8 REPRO_ACCS5, REPRO_ACC8(40), REPRO_ACC8(48), REPRO_ACC8(56)
#define REPRO_ACCS16 REPRO_ACCS8, REPRO_ACC8(64), REPRO_ACC8(72), REPRO_ACC8(80), \
    REPRO_ACC8(88), REPRO_ACC8(96), REPRO_ACC8(104), REPRO_ACC8(112), REPRO_ACC8(120)

template <int N> struct Wgmma;
// Wgmma<N> for G = N / 16 rows of eight accumulators
#define REPRO_WGMMA(N, G)                                                      \
  template <> struct Wgmma<N> {                                                \
    /* D[64 x N] (+)= A[64 x 16] B[N x 16]^T, A and B K-major in shared      \
       memory */                                                               \
    static __device__ __forceinline__ void ss(float (&d)[N / 2], uint64_t a,   \
                                              uint64_t b, int accumulate) {    \
      asm volatile(                                                            \
          "{\n.reg .pred p;\nsetp.ne.b32 p, %2, 0;\n"                          \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
          REPRO_REGS##G "}, %0, %1, p, 1, 1, 0, 0;\n}\n"                       \
          : "+l"(a), "+l"(b), "+r"(accumulate), REPRO_ACCS##G);                \
    }                                                                          \
    /* D[64 x N] += A[64 x 16] B[16 x N], A (bf16 pairs) in registers, B      \
       from shared memory, read MN-major */                                    \
    static __device__ __forceinline__ void rs(float (&d)[N / 2],               \
                                              const uint32_t (&a)[4],          \
                                              uint64_t b) {                    \
      uint64_t a01 = a[0] | static_cast<uint64_t>(a[1]) << 32;                 \
      uint64_t a23 = a[2] | static_cast<uint64_t>(a[3]) << 32;                 \
      asm volatile(                                                            \
          "{\n.reg .pred p;\n.reg .b32 a0, a1, a2, a3, one;\n"                 \
          "mov.b32 one, 1;\nsetp.ne.b32 p, one, 0;\n"                          \
          "mov.b64 {a0, a1}, %0;\nmov.b64 {a2, a3}, %1;\n"                     \
          "wgmma.mma_async.sync.aligned.m64n" #N "k16.f32.bf16.bf16 {"         \
          REPRO_REGS##G "}, {a0, a1, a2, a3}, %2, p, 1, 1, 1;\n}\n"            \
          : "+l"(a01), "+l"(a23), "+l"(b), REPRO_ACCS##G);                     \
    }                                                                          \
  };
REPRO_WGMMA(64, 4)
REPRO_WGMMA(80, 5)
REPRO_WGMMA(128, 8)
REPRO_WGMMA(256, 16)
#undef REPRO_WGMMA

// ---------------------------------------------------------------- tiles

// Copy R rows x DP bf16 into the layout above at dst.  row_src(row) is the
// row's first element in global memory, or nullptr for a row of zeros;
// 16-byte chunks at or past the head size d are zero-filled.  A warp copies
// 4 chunks of 8 consecutive rows: 64 contiguous bytes of each global row,
// 512 contiguous bytes of shared memory.  `any` is a valid global address
// handed to the zero-filling copies.
template <int R, int DP, class RowSrc>
__device__ __forceinline__ void load_tile(uint32_t dst, RowSrc row_src, int d,
                                          const void* any) {
  constexpr int kCh = DP / 8;
  constexpr int kThreads = Cta<DP>::kThreads;
  static_assert((R * kCh) % kThreads == 0, "whole chunks per thread");
#pragma unroll
  for (int it = 0; it < R * kCh / kThreads; ++it) {
    const int idx = it * kThreads + threadIdx.x;
    const int row = (idx / (8 * kCh)) * 8 + (idx & 7);
    const int ch = (idx >> 3) % kCh;
    const bf16* src = row_src(row);
    const bool ok = src != nullptr && ch * 8 < d;
    cp_async16(dst + ch * (R * 16) + row * 16,
               ok ? static_cast<const void*>(src + ch * 8) : any, ok);
  }
}

// Copy key rows kt .. kt + kBK - 1 of one head (row j at src + j * stride)
// into the layout above at dst, zero-filling rows at or past n_keys and
// chunks at or past d.  Same copy pattern as load_tile (a warp copies 4
// chunks of 8 consecutive rows), but each thread's rows are its first row
// plus multiples of 8, so a copy costs a pointer step, a compare and the
// cp.async itself.
template <int DP>
__device__ __forceinline__ void load_kv_tile(uint32_t dst, const bf16* src,
                                             long long stride, int kt,
                                             int n_keys, int d) {
  constexpr int kCh = DP / 8;
  constexpr int kGroups = Cta<DP>::kThreads / 8;  // (8 rows x 1 chunk) copies per pass
  constexpr int kCopies = kBK / 8 * kCh;     // of the whole tile
  constexpr int kPasses = (kCopies + kGroups - 1) / kGroups;
  const int row8 = threadIdx.x & 7, cg = threadIdx.x >> 3;  // cg < kGroups
  const int first = kt + row8;
  const bf16* row0 = src + first * stride;
#pragma unroll
  for (int it = 0; it < kPasses; ++it) {
    int ch, rb;  // chunk and 8-row block of copy (it, cg)
    if constexpr (kCopies % kGroups != 0)  // the last pass is partial
      if (it * kGroups + cg >= kCopies) break;
    if constexpr (kCh % kGroups == 0) {
      ch = (it * kGroups) % kCh + cg;
      rb = it * kGroups / kCh;
    } else if constexpr (kGroups % kCh == 0) {
      ch = cg % kCh;
      rb = it * (kGroups / kCh) + cg / kCh;
    } else {
      ch = (it * kGroups + cg) % kCh;
      rb = (it * kGroups + cg) / kCh;
    }
    const bool ok = first + rb * 8 < n_keys && ch * 8 < d;
    cp_async16(dst + ch * (kBK * 16) + (rb * 8 + row8) * 16,
               ok ? static_cast<const void*>(row0 + rb * 8 * stride + ch * 8) : src, ok);
  }
}

// ---------------------------------------------------------------- core

// The accumulator fragment of wgmma m64nN (f32): register i of thread t of
// a warpgroup holds row 16 * (t / 32) + (t % 32) / 4 + 8 * ((i / 2) % 2) of
// the warpgroup's 64 and column 8 * (i / 4) + 2 * (t % 4) + i % 2.  So each
// thread owns two rows ("slot" 0 and 1, eight apart); row state is kept per
// slot.  Warpgroup w owns CTA rows 64 w .. 64 w + 63.
__device__ __forceinline__ int frag_row(int slot) {
  return 16 * (threadIdx.x >> 5) + ((threadIdx.x & 31) >> 2) + 8 * slot;
}
__device__ __forceinline__ int frag_col(int i) {
  return 8 * (i >> 2) + 2 * (threadIdx.x & 3) + (i & 1);
}

// running flash state of the thread's two rows: unnormalized o, max m and
// denominator l
template <int DP>
struct Acc {
  float o[DP / 2];
  float m[2], l[2];

  __device__ __forceinline__ void clear() {
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) o[i] = 0.f;
    m[0] = m[1] = neg_inf();
    l[0] = l[1] = 0.f;
  }
};

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Fold every key tile the mask visits into acc.  All kThreads threads call
// it with the same arguments.
//   q_src(row)  global address of Q row `row` (0 .. kRows - 1), or nullptr;
//   k, v        key 0 of this KV head; key j's row is at k + j * kv_stride;
//   n_keys      keys that exist (the last tile is zero-filled past them);
//   mask        mask.next(kt): start of the next tile to visit after the one
//               at kt (kt = -kBK asks for the first), or -1 when done;
//               mask.interior(kt): no (row, key) of that tile is masked and
//               every key exists, so the per-element mask is skipped;
//               mask.ok(slot, mask.key(j)): the thread's row `slot` may
//               attend key j (boundary tiles only).
// The branches on interior() and next() are uniform across the CTA, as
// wgmma's .sync.aligned form needs.
template <int DP, class QSrc, class Mask>
__device__ __forceinline__ void attend(char* smem, QSrc q_src, const bf16* k,
                                       const bf16* v, long long kv_stride,
                                       int n_keys, int d, float scale,
                                       float softcap, const Mask& mask,
                                       Acc<DP>& acc) {
  using L = Smem<DP>;
  const uint32_t s_q = smem_u32(smem);
  const uint32_t s_qw = s_q + (threadIdx.x >> 7) * 64 * 16;  // this warpgroup's rows
  const uint32_t s_kv = s_q + L::kQ;
  auto load_kv = [&](int stage, int kt) {
    const uint32_t dst = s_kv + stage * L::kStage;
    load_kv_tile<DP>(dst, k, kv_stride, kt, n_keys, d);
    load_kv_tile<DP>(dst + L::kTile, v, kv_stride, kt, n_keys, d);
  };
  // scores stay unscaled until the exponent: p = 2^(s * c - m_safe * log2 e)
  // with c = scale * log2 e is one FFMA and one EX2 per score.  With a
  // softcap the capped, scaled score replaces s and c = log2 e.
  const float mul = softcap > 0.f ? 1.f : scale;
  const float c = mul * kLog2e;

  constexpr int kRows = Cta<DP>::kRows;
  load_tile<kRows, DP>(s_q, q_src, d, k);
  int kt = mask.next(-kBK);
  if (kt >= 0) load_kv(0, kt);
  cp_async_commit();  // group 0: Q and the first tile
  int stage = 0;
  while (kt >= 0) {
    const int nxt = mask.next(kt);
    if (nxt >= 0) load_kv(stage ^ 1, nxt);
    cp_async_commit();
    cp_async_wait<1>();  // everything but the tile just issued has landed
    fence_async_smem();
    __syncthreads();
    const uint32_t s_k = s_kv + stage * L::kStage;
    const uint32_t s_v = s_k + L::kTile;

    // S = Q K^T over DP / 16 steps of 16 head dims
    float s[kBK / 2];
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < DP / 16; ++ks)
      Wgmma<kBK>::ss(s, desc(s_qw + ks * 2 * kRows * 16, kRows * 16, 128),
                     desc(s_k + ks * 2 * kBK * 16, kBK * 16, 128), ks);
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(s);

    // softcap, mask (boundary tiles only; a masked score becomes -inf, so
    // its weight is exactly 0 as with the reference's -1e30), online softmax
    if (softcap > 0.f) {
#pragma unroll
      for (int i = 0; i < kBK / 2; ++i) s[i] = softcap * tanhf(s[i] * scale / softcap);
    }
    if (!mask.interior(kt)) {
#pragma unroll
      for (int i = 0; i < kBK / 2; i += 4) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const auto key = mask.key(kt + frag_col(i + e));
          if (!mask.ok(0, key)) s[i + e] = neg_inf();
          if (!mask.ok(1, key)) s[i + 2 + e] = neg_inf();
        }
      }
    }
    float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
    float alpha[2], mc[2], rsum[2] = {0.f, 0.f};
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) {
      const float m_blk = quad_max(mx[sl]) * mul;  // mul > 0 keeps the max
      const float m_new = fmaxf(acc.m[sl], m_blk);
      const float m_safe = fmaxf(m_new, -1e29f);
      alpha[sl] = acc.m[sl] <= kNegInf / 2 ? 0.f : ex2((acc.m[sl] - m_safe) * kLog2e);
      if (m_blk > kNegInf / 2) acc.m[sl] = m_new;
      mc[sl] = m_safe * kLog2e;
    }
#pragma unroll
    for (int i = 0; i < kBK / 2; ++i) {
      s[i] = ex2(fmaf(s[i], c, -mc[(i >> 1) & 1]));
      rsum[(i >> 1) & 1] += s[i];
    }
#pragma unroll
    for (int sl = 0; sl < 2; ++sl) acc.l[sl] = alpha[sl] * acc.l[sl] + quad_sum(rsum[sl]);
#pragma unroll
    for (int i = 0; i < DP / 2; ++i) acc.o[i] *= alpha[(i >> 1) & 1];

    // P (bf16) as the A fragment: k-step ks covers keys 16 ks .. 16 ks + 15
    uint32_t p[kBK / 16][4];
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
#pragma unroll
      for (int r = 0; r < 4; ++r) p[ks][r] = pack_bf16(s[8 * ks + 2 * r], s[8 * ks + 2 * r + 1]);

    // O += P V, V read MN-major: 8-key core matrices 128 bytes apart (K),
    // 8-column blocks kBK * 16 bytes apart (N)
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks)
      Wgmma<DP>::rs(acc.o, p[ks], desc(s_v + ks * 16 * 16, 128, kBK * 16));
    wgmma_commit();
    wgmma_wait_all();
    fence_regs(acc.o);
    __syncthreads();  // this stage is free for the copy issued next
    stage ^= 1;
    kt = nxt;
  }
  cp_async_wait<0>();
}

// Write o row by row with 16-byte stores: a shuffle between quad neighbours
// hands each thread four consecutive columns of one row.  For 8-column
// block j, thread q = t % 4 ends with row frag_row(q & 1) and columns
// 8 j + 4 (q / 2) .. + 3, passed to store(row, col, float4).
template <int DP, class Store>
__device__ __forceinline__ void store_rows(const float (&o)[DP / 2], Store store) {
  const int q4 = threadIdx.x & 3;
  const bool odd = q4 & 1;
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const float a0 = o[4 * j], a1 = o[4 * j + 1];      // row slot 0
    const float b0 = o[4 * j + 2], b1 = o[4 * j + 3];  // row slot 1
    const float x0 = __shfl_xor_sync(0xffffffffu, odd ? a0 : b0, 1);
    const float x1 = __shfl_xor_sync(0xffffffffu, odd ? a1 : b1, 1);
    store(frag_row(odd ? 1 : 0), 8 * j + 4 * (q4 >> 1),
          odd ? make_float4(x0, x1, b0, b1) : make_float4(a0, a1, x0, x1));
  }
}

}  // namespace tc
}  // namespace repro
