// Shared helpers of the port's CUDA kernels: element types, conversions to
// and from f32, and the C entry that names a CUDA error for the Python side.
// Every library is built with nvcc for sm_90a, bound with ctypes; each C
// entry returns cudaGetLastError() right after its launches.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

// Element-type codes passed from Python (see kernels/_build.py users).
enum DType : int { kF32 = 0, kBF16 = 1, kI8 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(int8_t x) { return static_cast<float>(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
// round to nearest even, as torch's float -> bfloat16 cast
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// The finite mask value of the reference kernels (NEG_INF = -2**30).
constexpr float kNegInf = -1073741824.0f;

}  // namespace rt

extern "C" const char* rt_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
