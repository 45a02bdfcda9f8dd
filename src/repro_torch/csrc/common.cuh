// Helpers shared by the attention kernels: operand widening, typed stores,
// the reference's masking constants and the cp.async copies of the
// tensor-core core (attn_tc.cuh) and the split-K decode core
// (decode_splitk.cuh).  kernels/_build.py hashes this header together with
// every source that includes it, so a change here rebuilds them.
#pragma once

#include <cstdint>

#include <cuda_bf16.h>

namespace repro {

// masked score (the reference's NEG_INF); -inf itself marks an empty row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the special-function unit (relative error 2^-22; 2^-inf = 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// log-sum-exp of a row's softmax from its running max m and denominator l
// (l is taken against max(m, -1e29), as in every kernel here); +inf for a
// row with no key, so that exp(t - lse) is 0 for it in the backward
__device__ __forceinline__ float row_lse(float m, float l) {
  return l > 0.f ? fmaxf(m, -1e29f) + logf(l) : __int_as_float(0x7f800000);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

__device__ __forceinline__ int warp_min(int x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = min(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

__device__ __forceinline__ int warp_max(int x) {
#pragma unroll
  for (int w = 16; w > 0; w >>= 1) x = max(x, __shfl_xor_sync(0xffffffffu, x, w));
  return x;
}

// ------------------------------------------------------ asynchronous copies

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy (L2 only); valid == false zero-fills the 16
// bytes and reads nothing
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0) : "memory");
}
// 4-byte global -> shared copy; valid == false zero-fills
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               ::"r"(dst), "l"(src), "r"(valid ? 4 : 0) : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
// wait until at most N of this thread's committed copy groups are pending
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

}  // namespace repro
