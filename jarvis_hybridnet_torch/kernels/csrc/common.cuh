// Shared helpers for the port's kernels: element loads/stores as float for
// the two working types (float32 = 0, bfloat16 = 1) and the launch-error
// return that every C entry point ends with.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define DTYPE_F32 0
#define DTYPE_BF16 1

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round a float to the working type and back: the JAX reference rounds the
// output of each op to its dtype, so a fused kernel rounds where it did.
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }

static inline int launch_status() { return (int)cudaGetLastError(); }
