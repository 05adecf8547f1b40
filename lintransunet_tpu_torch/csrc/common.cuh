// Device helpers shared by the port's CUDA kernels (csrc/*.cu).
//
// Each kernel source is built into its own shared library; this header is
// included by all of them, so kernels/build.py hashes it together with each
// source.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>

namespace ltu {

constexpr unsigned kFullMask = 0xffffffffu;

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

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

// x rounded to T and back: what a value stored in T reads as.
template <typename T>
__device__ __forceinline__ float round_to(float x) { return to_f32(from_f32<T>(x)); }

// Butterfly reductions over a warp: every lane gets the result, and the
// order of the sums is fixed, so the result is deterministic.
__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFullMask, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFullMask, x, o);
  return x;
}

__host__ __device__ constexpr size_t align_up(size_t x, size_t a) { return (x + a - 1) / a * a; }

}  // namespace ltu
