// Shared helpers of the port's kernels: float/bf16 conversion and the
// 16-byte vector width of each element type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace mxt {

// dtype codes passed from Python (cuda_ops wrappers)
enum DType : int { kF32 = 0, kBF16 = 1 };

// the mask value of the TPU kernels (flash_attention.py / paged_attention.py
// _NEG): masked scores are REPLACED by it, and it is finite so a row whose
// every key is masked degrades to a uniform average instead of NaN
constexpr float kNeg = -1e30f;

template <typename T> __device__ __forceinline__ float to_f(T x);
template <> __device__ __forceinline__ float to_f<float>(float x) { return x; }
template <> __device__ __forceinline__ float to_f<__nv_bfloat16>(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// elements of T in one 16-byte load
template <typename T> struct Vec { static constexpr int n = 16 / sizeof(T); };

// Load one 16-byte vector of T at src and widen it to float in dst.
template <typename T>
__device__ __forceinline__ void load_vec_f32(float* dst, const T* src) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) dst[i] = to_f<T>(e[i]);
}

}  // namespace mxt
