// K16 crop_normalize: the S x S windows of frames at their crop centers,
// ImageNet-normalized, in the network's input type.
//
// Replaces: the crop and normalize of
// jarvis_hybridnet_tpu/prediction/predictor3d.py:136-143 and
// predictor2d.py:106-113: jax.lax.dynamic_slice of (bbox, bbox, 3) at (cy -
// bbox/2, cx - bbox/2) (a negative start counted from the end, then
// clamped to [0, extent - bbox], as dynamic_slice places it),
// x.astype(float32) / value_scale, then normalize_imagenet
// (ops/image.py:127) and the cast to the inference dtype; in the port an
// indexed gather (index_elementwise_kernel), four float32 passes and the
// stem convolution's cast.
//
// Bound on the H100: bytes. 96 crops of 256^2 read 18.9 MB of uint8 and
// write 37.7 MB of bf16.
//
// Design: a window row is 3 S contiguous values of the frame and of the
// output, so a thread takes V consecutive values of one output row (V = 8
// where 3 S allows it: one 16-byte bf16 store, two float32 ones), reads them
// from the frame's row at the window's corner and computes, in float32 with
// one IEEE operation each, (x / 255 - mean[c]) / std[c] for uint8 frames and
// (x - mean[c]) / std[c] for float32 frames in [0, 1] (x / 1 is x), c the
// value's channel, rounded once to the output type: the plain version's
// (and JAX's) float32 operations in their order, so the two are bit-equal.
#include <type_traits>

#include "common.cuh"

constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) OutVec {
  T v[V];
};

// dynamic_slice's start: a negative one counts from the end, then clamped
__device__ __forceinline__ int window_start(int s, int extent, int size) {
  return min(max(s < 0 ? s + extent : s, 0), extent - size);
}

template <typename In, typename T, int V>
__global__ void __launch_bounds__(kThreads)
    crop_norm(const In* __restrict__ x, const int* __restrict__ centers, T* __restrict__ out,
              long long groups, int H, int W, int S, float m0, float m1, float m2, float s0,
              float s1, float s2) {
  const long long gi = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (gi >= groups) return;
  const int G = 3 * S / V;  // vectors a row
  const int j = (int)(gi % G) * V;
  const long long row = gi / G;
  const int r = (int)(row % S);
  const long long n = row / S;
  int x0 = 0, y0 = 0;
  if (centers != nullptr) {
    x0 = window_start(centers[2 * n] - S / 2, W, S);
    y0 = window_start(centers[2 * n + 1] - S / 2, H, S);
  }
  const In* src = x + ((n * H + y0 + r) * W + x0) * 3 + j;
  const float mean[3] = {m0, m1, m2}, stdv[3] = {s0, s1, s2};
  OutVec<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float val = (float)src[v];
    if constexpr (std::is_same<In, uint8_t>::value) val = __fdiv_rn(val, 255.f);
    const int c = (j + v) % 3;
    o.v[v] = from_f<T>(__fdiv_rn(__fsub_rn(val, mean[c]), stdv[c]));
  }
  *reinterpret_cast<OutVec<T, V>*>(out + row * 3 * S + j) = o;
}

template <typename In, typename T, int V>
static int launch(const void* x, const void* centers, void* out, int N, int H, int W, int S,
                  const float* m, const float* s, cudaStream_t st) {
  const long long groups = (long long)N * S * (3 * S / V);
  const unsigned blocks = (unsigned)((groups + kThreads - 1) / kThreads);
  crop_norm<In, T, V><<<blocks, kThreads, 0, st>>>((const In*)x, (const int*)centers, (T*)out,
                                                   groups, H, W, S, m[0], m[1], m[2], s[0],
                                                   s[1], s[2]);
  return launch_status();
}

template <typename In, typename T>
static int by_width(const void* x, const void* centers, void* out, int N, int H, int W, int S,
                    int V, const float* m, const float* s, cudaStream_t st) {
  switch (V) {
    case 8: return launch<In, T, 8>(x, centers, out, N, H, W, S, m, s, st);
    case 4: return launch<In, T, 4>(x, centers, out, N, H, W, S, m, s, st);
    case 2: return launch<In, T, 2>(x, centers, out, N, H, W, S, m, s, st);
    case 1: return launch<In, T, 1>(x, centers, out, N, H, W, S, m, s, st);
  }
  return (int)cudaErrorInvalidValue;
}

// x: (N, H, W, 3) uint8 (in_float 0) or float32 (in_float 1), contiguous;
// centers: (N, 2) int32 (cx, cy) or null (the window at (0, 0)); out: (N,
// S, S, 3) float32 or bf16 (dtype), contiguous; S <= H, W; V values a
// thread, 3 S % V == 0, out aligned to V elements.
extern "C" int crop_normalize(const void* x, const void* centers, void* out, int N, int H, int W,
                              int S, int V, float m0, float m1, float m2, float s0, float s1,
                              float s2, int dtype, int in_float, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const float m[3] = {m0, m1, m2}, s[3] = {s0, s1, s2};
  if (in_float) {
    if (dtype == DTYPE_BF16)
      return by_width<float, __nv_bfloat16>(x, centers, out, N, H, W, S, V, m, s, st);
    if (dtype == DTYPE_F32) return by_width<float, float>(x, centers, out, N, H, W, S, V, m, s, st);
  } else {
    if (dtype == DTYPE_BF16)
      return by_width<uint8_t, __nv_bfloat16>(x, centers, out, N, H, W, S, V, m, s, st);
    if (dtype == DTYPE_F32)
      return by_width<uint8_t, float>(x, centers, out, N, H, W, S, V, m, s, st);
  }
  return (int)cudaErrorInvalidValue;
}
