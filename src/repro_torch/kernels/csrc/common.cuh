// Shared helpers of the port's Hopper kernels: dtype conversion, 16-byte
// vector loads/stores, warp reductions.  Every kernel computes in f32
// whatever its storage type (float or bf16), as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

// Storage type codes shared with the Python wrappers (kernels/cuda.py).
enum ReproDtype { REPRO_F32 = 0, REPRO_BF16 = 1 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// Elements of T in one 16-byte vector.
template <typename T> struct Vec16 {
  static constexpr int N = 16 / sizeof(T);
};

// Load 16 bytes (p must be 16-byte aligned) and widen to f32.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float (&out)[Vec16<T>::N]) {
  uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) out[i] = to_f32(v[i]);
}

// Narrow f32 to T (round to nearest even) and store 16 bytes.
template <typename T>
__device__ __forceinline__ void store16(T* p, const float (&in)[Vec16<T>::N]) {
  uint4 raw;
  T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int i = 0; i < Vec16<T>::N; ++i) v[i] = from_f32<T>(in[i]);
  *reinterpret_cast<uint4*>(p) = raw;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__host__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15u) == 0;
}
