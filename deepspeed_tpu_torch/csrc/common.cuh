// Shared helpers for the hand-written Hopper kernels of deepspeed_tpu_torch.
//
// Every entry point is a plain C function: pointers and the stream arrive as
// void*, the dtype as one of the DType codes below (the Python wrappers use
// the same numbers), and the function returns cudaGetLastError() so that a
// refused launch is raised by the wrapper instead of passing silently.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace dst {

enum DType : int { kFloat32 = 0, kBFloat16 = 1, kFloat16 = 2 };

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);  // round to nearest even, as torch's .to(bfloat16)
}
template <>
__device__ __forceinline__ __half from_float<__half>(float x) {
  // round to nearest even, as torch's .to(float16): +-inf past 65504, never
  // clamped, so an fp16 overflow stays visible to the loss scaler
  return __float2half_rn(x);
}

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

}  // namespace dst
