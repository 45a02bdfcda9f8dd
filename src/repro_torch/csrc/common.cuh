// Helpers shared by the attention kernels in striped_attention.cu (K4) and
// flash_decode.cu (K5): operand widening, typed stores and the reference's
// masking constants.  kernels/_build.py hashes this header together with
// every source that includes it, so a change here rebuilds them.
#pragma once

#include <cuda_bf16.h>

namespace repro {

// masked score (the reference's NEG_INF); -inf itself marks an empty row
constexpr float kNegInf = -1e30f;

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

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

}  // namespace repro
