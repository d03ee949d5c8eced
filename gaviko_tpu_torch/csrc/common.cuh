// Shared helpers for the port's hand-written Hopper kernels.
//
// Every kernel library is built on its own by nvcc with a plain C interface
// and loaded with ctypes (gaviko_tpu_torch/ops/_build.py). Each C entry point
// launches on the stream it is given and returns cudaGetLastError(); the
// Python wrapper raises when that is not cudaSuccess.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace gaviko {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__host__ __device__ constexpr bool is_bf16() { return std::is_same<T, __nv_bfloat16>::value; }

// Dropout keep bit of element (row, col) of plane `salt`: the coordinate
// hash of gaviko_tpu_torch/ops/hash_dropout.py (and of the JAX package),
// in uint32 arithmetic (signed overflow is undefined in C++), read as int32
// only for the signed compare against the threshold the wrapper computes.
__device__ __forceinline__ bool keep_bit(uint32_t row, uint32_t col, uint32_t salt,
                                         uint32_t seed, int32_t threshold) {
  uint32_t h = row * 0x9E3779B9u + seed + salt * 0x5851F42Du + col * 0x7FEB352Du;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  return static_cast<int32_t>(h) >= threshold;
}

// Opt a kernel in to more than 48 KB of dynamic shared memory when needed.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              static_cast<int>(bytes));
}

}  // namespace gaviko

extern "C" const char* gaviko_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
