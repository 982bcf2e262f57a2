// Helpers shared by the port's kernels: warp reductions, and loads and
// stores of four consecutive elements of fp32 or bf16 arrays as a float4
// (bf16 to fp32 is exact; fp32 to bf16 rounds to nearest even, as
// `.to(torch.bfloat16)` and JAX's `astype` round).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace digat {

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// four elements from 16-byte (fp32) or 8-byte (bf16) aligned memory,
// through the read-only path
__device__ __forceinline__ float4 load4(const float* p) {
  return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float bf16_bits_to_float(uint32_t bits16) {
  return __uint_as_float(bits16 << 16);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = __ldg(reinterpret_cast<const uint2*>(p));
  return make_float4(bf16_bits_to_float(u.x & 0xffffu), bf16_bits_to_float(u.x >> 16),
                     bf16_bits_to_float(u.y & 0xffffu), bf16_bits_to_float(u.y >> 16));
}

__device__ __forceinline__ void store4(float* p, const float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ void store4(__nv_bfloat16* p, const float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const uint32_t*>(&lo);
  u.y = *reinterpret_cast<const uint32_t*>(&hi);
  *reinterpret_cast<uint2*>(p) = u;
}

// two consecutive elements (8-byte or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, const float2 v) {
  *reinterpret_cast<float2*>(p) = v;
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, const float2 v) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(v.x, v.y);
}

}  // namespace digat
