// Helpers shared by the port's CUDA kernels. Each kernel source is built on
// its own into a shared library with a plain C interface (loaded with ctypes,
// conzic_torch/kernels/build.py), so every library exports its own copy of
// conzic_error_string.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#define CONZIC_EXPORT extern "C" __attribute__((visibility("default")))

namespace conzic {

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

}  // namespace conzic

CONZIC_EXPORT const char* conzic_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
