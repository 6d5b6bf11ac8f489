// K13 weighted_fuse: a BiFPN fusion, or EfficientTrack's merge, in one pass.
//
// Replaces: jarvis_hybridnet_tpu/models/bifpn.py::_FusionWeights (:20-30)
// with the fusions at :78-118 (ReLU-ed weights normalized to sum one plus
// 1e-4, the weighted sum of 2 or 3 maps, SiLU), and the softplus-weighted
// merge of models/efficienttrack.py:62-69 (no SiLU). XLA fuses each into
// one loop; the port's plain chain (kernels/weighted_fuse.py) takes about 17
// launches a fusion: the weights, a float32 copy per input, the upsample's
// two repeat_interleave, a multiply and an add per term, five SiLU pieces.
//
// Bound on the H100: bytes. Per output element it does a few flops (and an
// exp and a division for SiLU) on 2-3 inputs of 2 or 4 bytes; the least
// traffic is one read of every input (a pooled input's four source pixels,
// an upsampled input's source pixel once) and one write of the output.
//
// Design: one thread per (output pixel, vector of V channels), channels
// contiguous (NHWC memory), V channels a 16-byte load where C allows it
// (C = 56: 7 bf16 vectors of 8). Each input is read in place in its mode:
// the same pixel, the source pixel of a nearest x2 / x4 upsample (h >> 1,
// h >> 2), or the 2x2 window of a floor-mode max pool (scan order, NaN
// kept, as torch's max_pool2d), so no upsampled or pooled map is ever
// written. Every thread normalizes the 2-3 raw float32 weights itself, in
// torch's order: clamp_min(w, 0) (the merge: softplus, clamp_min(w, 0) +
// log1p(exp(-|w|))), the sum as torch's CUDA reduction takes it for 2 or 3
// values ((w0 + w2) + w1 for three), + 1e-4, and a division each. The
// weighted sum ((w0 x0) + w1 x1) + w2 x2 and SiLU's x * (1 / (1 + exp(-x)))
// are float32, every operation rounded on its own (__f*_rn: no FMA
// contraction; expf and log1pf are libdevice's, as torch's exp and log1p),
// so the result is the plain chain's float32 value, rounded once to the
// output type.
#include "common.cuh"

#define MODE_SAME 0
#define MODE_UP2 1
#define MODE_UP4 2
#define MODE_POOL 3

constexpr int kMaxInputs = 3;
constexpr int kThreads = 256;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

struct Args {
  const void* x[kMaxInputs];
  int h[kMaxInputs], w[kMaxInputs], mode[kMaxInputs];
  const float* weight;  // the raw parameter, n floats
  void* out;
  long long items;  // N * H * W * C / V
  int n, H, W, C, merge;
};

// torch's clamp_min(w, 0): NaN kept
__device__ __forceinline__ float relu_weight(float r) { return isnan(r) ? r : fmaxf(r, 0.f); }

// The weights of kernels/weighted_fuse.py::fusion_weights.
__device__ __forceinline__ void normalized_weights(const Args& a, float* wn) {
  float v[kMaxInputs] = {0.f, 0.f, 0.f};
#pragma unroll
  for (int i = 0; i < kMaxInputs; ++i) {
    if (i >= a.n) break;
    const float r = a.weight[i];
    v[i] = a.merge ? __fadd_rn(relu_weight(r), log1pf(expf(-fabsf(r)))) : relu_weight(r);
  }
  // torch's sum of 2 or 3 contiguous floats on the card: two lanes, the
  // first holding elements 0 and 2, then one shuffle
  const float s = a.n == 3 ? __fadd_rn(__fadd_rn(v[0], v[2]), v[1]) : __fadd_rn(v[0], v[1]);
  const float d = __fadd_rn(s, 1e-4f);
#pragma unroll
  for (int i = 0; i < kMaxInputs; ++i) wn[i] = __fdiv_rn(v[i], d);
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// Input i's V channels at output pixel (b, y, x), as float.
template <typename T, int V>
__device__ __forceinline__ void read_input(const Args& a, int i, int b, int y, int x, int c0,
                                           float* out) {
  const T* base = reinterpret_cast<const T*>(a.x[i]);
  const int hi = a.h[i], wi = a.w[i], C = a.C;
  if (a.mode[i] == MODE_POOL) {
    const T* p = base + (((size_t)b * hi + 2 * y) * wi + 2 * x) * C + c0;
    const Vec<T, V> q[4] = {load<T, V>(p), load<T, V>(p + C), load<T, V>(p + (size_t)wi * C),
                            load<T, V>(p + (size_t)wi * C + C)};
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float m = -__int_as_float(0x7f800000);  // -inf
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const float e = to_f(q[k].v[v]);
        if (e > m || isnan(e)) m = e;
      }
      out[v] = m;
    }
    return;
  }
  const int sh = a.mode[i] == MODE_UP2 ? 1 : a.mode[i] == MODE_UP4 ? 2 : 0;
  const Vec<T, V> q = load<T, V>(base + (((size_t)b * hi + (y >> sh)) * wi + (x >> sh)) * C + c0);
#pragma unroll
  for (int v = 0; v < V; ++v) out[v] = to_f(q.v[v]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) weighted_fuse_k(const Args a) {
  float wn[kMaxInputs];
  normalized_weights(a, wn);
  const int G = a.C / V;
  for (long long item = (long long)blockIdx.x * blockDim.x + threadIdx.x; item < a.items;
       item += (long long)gridDim.x * blockDim.x) {
    const int c0 = (int)(item % G) * V;
    const long long pix = item / G;
    const int x = (int)(pix % a.W);
    const int y = (int)((pix / a.W) % a.H);
    const int b = (int)(pix / ((long long)a.W * a.H));
    float acc[V], v[V];
    read_input<T, V>(a, 0, b, y, x, c0, v);
#pragma unroll
    for (int k = 0; k < V; ++k) acc[k] = __fmul_rn(wn[0], v[k]);
#pragma unroll
    for (int i = 1; i < kMaxInputs; ++i) {
      if (i >= a.n) break;
      read_input<T, V>(a, i, b, y, x, c0, v);
#pragma unroll
      for (int k = 0; k < V; ++k) acc[k] = __fadd_rn(acc[k], __fmul_rn(wn[i], v[k]));
    }
    Vec<T, V> o;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      float r = acc[k];
      if (!a.merge) {  // layers.silu: x * (1 / (1 + exp(-x))), float32
        const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-r)));
        r = __fmul_rn(r, sig);
      }
      o.v[k] = from_f<T>(r);
    }
    *reinterpret_cast<Vec<T, V>*>(reinterpret_cast<T*>(a.out) + pix * a.C + c0) = o;
  }
}

template <typename T, int V>
static int launch(const Args& a, int blocks, cudaStream_t st) {
  weighted_fuse_k<T, V><<<blocks, kThreads, 0, st>>>(a);
  return launch_status();
}

// x0..x2: (N, h_i, w_i, C) contiguous in the input type (x2 null for two
// inputs), modes 0 same / 1 up2 / 2 up4 / 3 pool; weight: the n raw float32
// weights; out: (N, H, W, C) in the input type. V channels a vector (bf16:
// 8, 4, 2, 1; float32: 4, 2, 1), C % V == 0 and every pointer aligned to V
// elements; blocks: the grid (a grid-stride loop covers the rest).
extern "C" int weighted_fuse(const void* x0, const void* x1, const void* x2, const void* weight,
                             void* out, int h0, int w0, int m0, int h1, int w1, int m1, int h2,
                             int w2, int m2, int n, int N, int H, int W, int C, int V, int merge,
                             int dtype, int blocks, void* stream) {
  Args a{};
  a.x[0] = x0, a.x[1] = x1, a.x[2] = x2;
  a.h[0] = h0, a.h[1] = h1, a.h[2] = h2;
  a.w[0] = w0, a.w[1] = w1, a.w[2] = w2;
  a.mode[0] = m0, a.mode[1] = m1, a.mode[2] = m2;
  a.weight = (const float*)weight;
  a.out = out;
  a.items = (long long)N * H * W * (C / V);
  a.n = n, a.H = H, a.W = W, a.C = C, a.merge = merge;
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    switch (V) {
      case 8: return launch<__nv_bfloat16, 8>(a, blocks, st);
      case 4: return launch<__nv_bfloat16, 4>(a, blocks, st);
      case 2: return launch<__nv_bfloat16, 2>(a, blocks, st);
      case 1: return launch<__nv_bfloat16, 1>(a, blocks, st);
    }
  } else if (dtype == DTYPE_F32) {
    switch (V) {
      case 4: return launch<float, 4>(a, blocks, st);
      case 2: return launch<float, 2>(a, blocks, st);
      case 1: return launch<float, 1>(a, blocks, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
