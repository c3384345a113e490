// Shared device helpers for the mmvae_torch CUDA kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mmvae {

// dtype codes passed from the Python wrappers.
enum DType : int { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ float to_f(T v);
template <> __device__ __forceinline__ float to_f<float>(float v) { return v; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as torch's .to(bfloat16)
}

// Value of v after a round trip through T (identity for float).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f<T>(from_f<T>(v));
}

}  // namespace mmvae
