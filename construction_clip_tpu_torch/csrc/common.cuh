// Shared helpers for the port's hand-written Hopper kernels (sm_90a).
//
// Every kernel is templated on its storage type T (float or __nv_bfloat16)
// and accumulates in fp32. `round_to<T>` reproduces the JAX package's
// rounding points: a value the reference holds in T is rounded through T
// here too, even when it is then used in fp32.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cct {

// kInt8 is a storage type only (K8's quantized table), never a compute type;
// kFloat16 is taken by the embedding backward alone.
enum DType : int { kFloat32 = 0, kBFloat16 = 1, kInt8 = 2, kFloat16 = 3 };

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);  // round to nearest even, as XLA's convert
}

template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

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

// Element e (0..3) of a float4 (e a compile-time constant after unrolling).
__device__ __forceinline__ float f32_lane(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

inline bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

// Largest dynamic shared memory one block may ask for on Hopper.
constexpr size_t kMaxSmemBytes = 232448;

}  // namespace cct
