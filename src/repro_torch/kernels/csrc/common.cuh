// Shared helpers of the port's CUDA kernels (sm_90a, plain C entry points
// loaded with ctypes).  Element types are passed as an integer code that
// the Python wrappers map from torch dtypes.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

enum ElemType { kF32 = 0, kBF16 = 1 };

// Finite stand-in for -inf in online-softmax state, as the Pallas kernels
// use: exp(NEG_INF - m) is exactly 0 for any real m, and two dead states
// combine without NaNs.
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
