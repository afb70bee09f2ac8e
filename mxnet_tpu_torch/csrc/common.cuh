// Shared helpers of the port's kernels: float/bf16 conversion, the 16-byte
// vector width of each element type, cp.async copies, and the opt-in to
// more than 48 KB of dynamic shared memory.
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

// the shared-memory address of a generic pointer into shared memory
__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// bf16 pair (lo, hi) packed into one 32-bit register, round to nearest
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Load one 16-byte vector of T at src and widen it to float in dst.
template <typename T>
__device__ __forceinline__ void load_vec_f32(float* dst, const T* src) {
  uint4 u = *reinterpret_cast<const uint4*>(src);
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < Vec<T>::n; ++i) dst[i] = to_f<T>(e[i]);
}

// cp.async: copy src_bytes (16 or 0) global bytes into 16 shared bytes,
// zero-filling the rest
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// the same for 4 bytes (src_bytes 4 or 0)
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until at most N of this thread's committed groups are in flight;
// what landed is visible to this thread
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// opt a kernel into more than 48 KB of dynamic shared memory, once
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, int bytes, bool& configured) {
  if (configured) return cudaSuccess;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (e == cudaSuccess) configured = true;
  return e;
}

}  // namespace mxt
