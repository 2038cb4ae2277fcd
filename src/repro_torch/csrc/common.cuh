// Shared helpers for the hand-written kernels: element conversion and
// 16-byte vector loads/stores for the two element types the wrappers
// accept (float32 = dtype code 0, bfloat16 = dtype code 1).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace repro {

enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

template <typename T>
__device__ __forceinline__ float to_float(T v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __bfloat162float(v);
  }
}

template <typename T>
__device__ __forceinline__ T from_float(float v) {
  if constexpr (std::is_same_v<T, float>) {
    return v;
  } else {
    return __float2bfloat16_rn(v);
  }
}

// Elements of T in one 16-byte vector.
template <typename T>
constexpr int kVec = 16 / sizeof(T);

// Unpack a 16-byte vector of T into kVec<T> floats.
template <typename T>
__device__ __forceinline__ void unpack(const uint4& u, float* f) {
  const T* e = reinterpret_cast<const T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) f[i] = to_float<T>(e[i]);
}

// Pack kVec<T> floats into a 16-byte vector of T.
template <typename T>
__device__ __forceinline__ uint4 pack(const float* f) {
  uint4 u;
  T* e = reinterpret_cast<T*>(&u);
#pragma unroll
  for (int i = 0; i < kVec<T>; ++i) e[i] = from_float<T>(f[i]);
  return u;
}

// Two floats rounded to one bf16 pair (lo in the low half), as 32 bits.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

}  // namespace repro
