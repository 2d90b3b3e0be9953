// Shared helpers for the port's CUDA kernels: element conversion,
// 16-byte loads and stores, and warp reductions. Every kernel reads and
// writes float32, bfloat16 or float16 and computes in float32.
#pragma once

#include <stdint.h>

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace progen {

enum DTypeCode { kF32 = 0, kBF16 = 1, kF16 = 2 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

// Round to nearest even, as a dtype cast does in PyTorch and JAX.
template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <>
__device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

// x rounded to T and widened back.
template <typename T>
__device__ __forceinline__ float round_to(float x) {
  return to_f32(from_f32<T>(x));
}

// 16 bytes of T at p (16-byte aligned), widened: 16 / sizeof(T) values.
template <typename T>
__device__ __forceinline__ void load16(const T* p, float* v) {
  const uint4 raw = *reinterpret_cast<const uint4*>(p);
  const T* t = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) v[e] = to_f32(t[e]);
}

// 16 / sizeof(T) values rounded to T, stored as 16 bytes at p (aligned).
template <typename T>
__device__ __forceinline__ void store16(T* p, const float* v) {
  uint4 raw;
  T* t = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int e = 0; e < (int)(16 / sizeof(T)); ++e) t[e] = from_f32<T>(v[e]);
  *reinterpret_cast<uint4*>(p) = raw;
}

// True for a pointer on the 16-byte grid (or none), which 16-byte loads
// and stores need.
inline bool aligned16(const void* p) {
  return p == nullptr || reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Scale-only LayerNorm statistics of one row as flax computes them:
// mean, and 1/sqrt(max(0, E[x^2] - E[x]^2) + eps).
__device__ __forceinline__ void norm_stats(float sum, float sumsq, int d,
                                           float eps, float* mean,
                                           float* rstd) {
  const float mu = sum / d;
  const float mu2 = sumsq / d;
  const float var = fmaxf(0.f, mu2 - mu * mu);
  *mean = mu;
  *rstd = 1.f / sqrtf(var + eps);
}

}  // namespace progen

// Run BODY with T bound to the element type named by a DTypeCode.
#define PROGEN_DISPATCH_DTYPE(code, ...)        \
  switch (code) {                               \
    case progen::kF32: {                        \
      using T = float;                          \
      __VA_ARGS__;                              \
      break;                                    \
    }                                           \
    case progen::kBF16: {                       \
      using T = __nv_bfloat16;                  \
      __VA_ARGS__;                              \
      break;                                    \
    }                                           \
    case progen::kF16: {                        \
      using T = __half;                         \
      __VA_ARGS__;                              \
      break;                                    \
    }                                           \
    default:                                    \
      return (int)cudaErrorInvalidValue;        \
  }
