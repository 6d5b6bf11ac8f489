// Shared helpers for the port's kernels: element loads/stores as float for
// the two working types (float32 = 0, bfloat16 = 1), the launch-error
// return that every C entry point ends with, a last-block ticket (K8, K10) and
// block sums in a fixed order (K6, K7).
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

// A ticket taken by one thread: atomically adds 1 and returns the old
// value, with release semantics for the thread's earlier writes and acquire
// semantics for what the holders of earlier tickets wrote (device scope).
__device__ __forceinline__ unsigned int ticket_add(unsigned int* p) {
  unsigned int old;
  asm volatile("atom.add.acq_rel.gpu.u32 %0, [%1], 1;" : "=r"(old) : "l"(p) : "memory");
  return old;
}

// out[o] for o < outs: the sum over t < terms of src[first(o) + t * stride],
// in an order fixed whatever the scheduling: threads take (o, slice) pairs,
// slice s sums terms s, s + slices, ... in order into tmp (max(outs,
// blockDim.x) floats), then each output its slices in order. A thread
// issues its loads kBatch at a time, so a slice waits on one round trip per
// kBatch terms. kL2: src was written by other blocks of this launch, so it
// is read through L2. Ends with the block synchronized.
template <bool kL2, typename F>
__device__ __forceinline__ void ordered_sums(const float* src, int outs, int terms, int stride,
                                             F first, float* tmp, float* out) {
  constexpr int kBatch = 16;
  const int slices = max(1, min(terms, (int)blockDim.x / outs));
  for (int i = threadIdx.x; i < outs * slices; i += blockDim.x) {
    const float* p = src + first(i % outs);
    float s = 0.f;
    for (int t0 = i / outs; t0 < terms; t0 += kBatch * slices) {
      float v[kBatch];
#pragma unroll
      for (int u = 0; u < kBatch; ++u) {
        const int t = t0 + u * slices;
        v[u] = t >= terms ? 0.f : kL2 ? __ldcg(p + (size_t)t * stride) : p[(size_t)t * stride];
      }
#pragma unroll
      for (int u = 0; u < kBatch; ++u) s += v[u];
    }
    tmp[i] = s;
  }
  __syncthreads();
  for (int o = threadIdx.x; o < outs; o += blockDim.x) {
    float s = 0.f;
    for (int sl = 0; sl < slices; ++sl) s += tmp[sl * outs + o];
    out[o] = s;
  }
  __syncthreads();
}
