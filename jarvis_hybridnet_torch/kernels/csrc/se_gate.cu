// K14 se_gate: x * sigmoid(g), g one value per (sample, channel) broadcast
// over x's spatial positions.
//
// Replaces: the squeeze-and-excitation gate of
// jarvis_hybridnet_tpu/models/efficientnet.py:171-175 (jax.nn.sigmoid(se) *
// x) and jax.nn.silu (models/layers.py:46) between the gate's two 1x1
// convolutions, as se_gate(r, r); XLA fuses both into their neighbours. In
// the port's plain chain (kernels/se_gate.py) a gate is five launches
// (neg, exp, add, reciprocal, the scalar multiply) on the small gate tensor
// and a broadcast multiply over the whole map.
//
// Bound on the H100: bytes. One multiply per element of x on 2 or 4 bytes
// read and as many written; the gate is N * C values.
//
// Design: x is (N, S, C) with channels contiguous (NHWC memory). A block is
// (row lanes x C / V channel vectors) of one sample, V channels a 16-byte
// load where C allows it; each thread computes the sigmoid of its V gate
// values once, as layers.sigmoid evaluates it, 1 / (1 + exp(-g)) rounded to
// the working type after each op (exp rounded, 1 + e rounded, the
// reciprocal rounded; libdevice's expf as torch's exp), then walks its lane's
// rows of the block's span and writes x * sigmoid(g) rounded once.
#include "common.cuh"

constexpr int kMaxThreads = 1024;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads) se_gate_k(const T* __restrict__ x,
                                                         const T* __restrict__ g,
                                                         T* __restrict__ out, int S, int C,
                                                         int span) {
  const int G = C / V;
  const int L = (int)blockDim.x / G;
  const int lane = (int)threadIdx.x / G, c0 = ((int)threadIdx.x % G) * V;
  if (lane >= L) return;
  const size_t n = blockIdx.y;
  float sig[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    const float e = round_to<T>(expf(-to_f(g[n * C + c0 + v])));
    sig[v] = round_to<T>(__fdiv_rn(1.f, round_to<T>(__fadd_rn(1.f, e))));
  }
  const int lo = blockIdx.x * span, hi = min(S, lo + span);
  for (int r = lo + lane; r < hi; r += L) {
    const size_t i = (n * S + r) * C + c0;
    const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(x + i);
    Vec<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) o.v[v] = from_f<T>(__fmul_rn(sig[v], to_f(a.v[v])));
    *reinterpret_cast<Vec<T, V>*>(out + i) = o;
  }
}

template <typename T, int V>
static int launch(const void* x, const void* g, void* out, int N, int S, int C, int threads,
                  int blocks, int span, cudaStream_t st) {
  se_gate_k<T, V><<<dim3(blocks, N), threads, 0, st>>>((const T*)x, (const T*)g, (T*)out, S, C,
                                                      span);
  return launch_status();
}

// x, out: (N, S, C) contiguous; g: (N, C) contiguous, all in one type. V
// channels a vector (bf16: 8, 4, 2, 1; float32: 4, 2, 1), C % V == 0, x and
// out aligned to V elements; threads: a multiple of C / V, at most 1024;
// the grid is (blocks, N), block b taking rows [b * span, (b + 1) * span).
extern "C" int se_gate(const void* x, const void* g, void* out, int N, int S, int C, int V,
                       int threads, int blocks, int span, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16) {
    switch (V) {
      case 8: return launch<__nv_bfloat16, 8>(x, g, out, N, S, C, threads, blocks, span, st);
      case 4: return launch<__nv_bfloat16, 4>(x, g, out, N, S, C, threads, blocks, span, st);
      case 2: return launch<__nv_bfloat16, 2>(x, g, out, N, S, C, threads, blocks, span, st);
      case 1: return launch<__nv_bfloat16, 1>(x, g, out, N, S, C, threads, blocks, span, st);
    }
  } else if (dtype == DTYPE_F32) {
    switch (V) {
      case 4: return launch<float, 4>(x, g, out, N, S, C, threads, blocks, span, st);
      case 2: return launch<float, 2>(x, g, out, N, S, C, threads, blocks, span, st);
      case 1: return launch<float, 1>(x, g, out, N, S, C, threads, blocks, span, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}
