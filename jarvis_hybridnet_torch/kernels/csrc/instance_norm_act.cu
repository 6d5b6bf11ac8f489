// K1 instance_norm_act: InstanceNorm (eps, no affine, biased variance,
// float32 statistics) fused with the op that follows it.
//
// Replaces: tools/fused_norm_bench.py::_kernel / instance_norm_silu_fused
// (the repo's one Pallas kernel) and models/layers.py::instance_norm with
// its consumers: SiLU (efficientnet.py:165-166,220), ReLU (v2v.py:93,107,125)
// and the residual add + ReLU (v2v.py:112-113).
//
// Bound on the H100: bytes. Per element it does ~10 flops on 2 or 4 bytes,
// far below the card's ~20 flops/byte balance point for float32 CUDA cores.
// The least traffic is one read of x (and skip) and one write of the output;
// this design reads x twice (statistics, then normalize).
//
// Design: the input is (N, S, C), channels contiguous (NHWC / NDHWC memory).
// Each thread loads V consecutive channels at once (up to 16 bytes, V set by
// the wrapper from C and the pointers' alignment). A block owns a channel
// tile and a chunk of rows; its threads are laid out (row lanes x channel
// vectors), so one step of the block reads a contiguous span of whole rows.
// Blocks run in no order, so the statistics are two kernels:
//   in_stats  — per (sample, tile, chunk): every thread runs Welford over its
//               rows, the block merges its threads' (mean, M2) pairwise in a
//               fixed tree (Chan et al.), one (mean, M2) per channel and chunk
//               is stored;
//   in_apply  — per (sample, tile, chunk): merges the chunks' pairs in order,
//               then normalizes its chunk and applies the epilogue, rounding
//               to the working type where the JAX code rounds (after the norm,
//               after the residual add, per op inside SiLU).
// Chunking gives enough blocks to fill the card even at N = 8 (V2V).
// The variance is mean((x - mean)^2) through these merges, never
// E[x^2] - mean^2.
#include "common.cuh"

#define ACT_NONE 0
#define ACT_SILU 1
#define ACT_RELU 2
#define ACT_ADD_RELU 3

constexpr int kThreads = 256;
constexpr int kMaxV = 8;

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

struct Layout {
  int cv;    // channel vectors in this block's tile
  int rl;    // row lanes: kThreads / cv
  int c;     // first channel of this thread's vector
  int r;     // this thread's row lane
  bool on;   // thread maps to a real (row lane, channel vector)
  int s0, s1;
};

__device__ __forceinline__ Layout layout(int C, int V, int tile_c, int rows_per_chunk, int S) {
  Layout L;
  L.cv = min(C, tile_c) / V;
  L.rl = kThreads / L.cv;
  L.r = threadIdx.x / L.cv;
  L.c = blockIdx.y * tile_c + (threadIdx.x % L.cv) * V;
  L.on = (L.r < L.rl) && (L.c < C);
  L.s0 = blockIdx.x * rows_per_chunk;
  L.s1 = min(S, L.s0 + rows_per_chunk);
  return L;
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) in_stats(
    const T* __restrict__ x, float2* __restrict__ part, int S, int C, int tile_c,
    int rows_per_chunk, int chunks) {
  __shared__ float sm_mean[kThreads * V];
  __shared__ float sm_m2[kThreads * V];
  __shared__ float sm_n[kThreads];
  const Layout L = layout(C, V, tile_c, rows_per_chunk, S);
  const T* xs = x + (size_t)blockIdx.z * S * C;

  float mean[V], m2[V], cnt = 0.f;
#pragma unroll
  for (int v = 0; v < V; ++v) mean[v] = m2[v] = 0.f;
  if (L.on) {
    for (int s = L.s0 + L.r; s < L.s1; s += L.rl) {
      const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(xs + (size_t)s * C + L.c);
      cnt += 1.f;
      const float inv = 1.f / cnt;
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float xv = to_f(a.v[v]);
        const float d = xv - mean[v];
        mean[v] += d * inv;
        m2[v] += d * (xv - mean[v]);
      }
    }
  }
#pragma unroll
  for (int v = 0; v < V; ++v) {
    sm_mean[threadIdx.x * V + v] = mean[v];
    sm_m2[threadIdx.x * V + v] = m2[v];
  }
  sm_n[threadIdx.x] = cnt;
  __syncthreads();
  // merge the row lanes of each channel vector pairwise, in a fixed tree
  for (int off = 1; off < L.rl; off <<= 1) {
    if (L.on && L.r % (2 * off) == 0 && L.r + off < L.rl) {
      const int a = threadIdx.x, b = threadIdx.x + off * L.cv;
      const float n_a = sm_n[a], n_b = sm_n[b];
      if (n_b > 0.f) {
        const float n_ab = n_a + n_b;
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float delta = sm_mean[b * V + v] - sm_mean[a * V + v];
          sm_mean[a * V + v] += delta * (n_b / n_ab);
          sm_m2[a * V + v] += sm_m2[b * V + v] + delta * delta * (n_a * n_b / n_ab);
        }
        sm_n[a] = n_ab;
      }
    }
    __syncthreads();
  }
  if (L.r != 0 || !L.on) return;
#pragma unroll
  for (int v = 0; v < V; ++v)
    part[((size_t)blockIdx.z * chunks + blockIdx.x) * C + L.c + v] =
        make_float2(sm_mean[threadIdx.x * V + v], sm_m2[threadIdx.x * V + v]);
}

template <typename T, int V>
__global__ void __launch_bounds__(kThreads) in_apply(
    const T* __restrict__ x, const T* __restrict__ skip, T* __restrict__ out,
    const float2* __restrict__ part, int S, int C, int tile_c, int rows_per_chunk,
    int chunks, float eps, int act) {
  __shared__ float mean_s[kThreads * kMaxV];
  __shared__ float rstd_s[kThreads * kMaxV];
  const Layout L = layout(C, V, tile_c, rows_per_chunk, S);
  const size_t base = (size_t)blockIdx.z * S * C;
  const int cl = threadIdx.x % L.cv;  // channel vector within the tile

  if (L.r == 0 && L.on) {
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float n_a = 0.f, mean = 0.f, m2 = 0.f;
      for (int k = 0; k < chunks; ++k) {
        const float n_b = (float)(min(S, (k + 1) * rows_per_chunk) - k * rows_per_chunk);
        const float2 p = part[((size_t)blockIdx.z * chunks + k) * C + L.c + v];
        const float n_ab = n_a + n_b;
        const float delta = p.x - mean;
        mean += delta * (n_b / n_ab);
        m2 += p.y + delta * delta * (n_a * n_b / n_ab);
        n_a = n_ab;
      }
      mean_s[cl * V + v] = mean;
      rstd_s[cl * V + v] = 1.f / sqrtf(m2 / (float)S + eps);
    }
  }
  __syncthreads();
  if (!L.on) return;

  float m[V], rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = mean_s[cl * V + v];
    rstd[v] = rstd_s[cl * V + v];
  }
  for (int s = L.s0 + L.r; s < L.s1; s += L.rl) {
    const size_t i = base + (size_t)s * C + L.c;
    const Vec<T, V> a = *reinterpret_cast<const Vec<T, V>*>(x + i);
    Vec<T, V> b;
    if (act == ACT_ADD_RELU) b = *reinterpret_cast<const Vec<T, V>*>(skip + i);
    Vec<T, V> o;
#pragma unroll
    for (int v = 0; v < V; ++v) {
      float y = round_to<T>((to_f(a.v[v]) - m[v]) * rstd[v]);
      if (act == ACT_SILU) {  // y * 1/(1 + exp(-y)), rounded per op as XLA does in bf16
        const float e = round_to<T>(expf(-y));
        const float sig = round_to<T>(1.f / round_to<T>(1.f + e));
        y = y * sig;
      } else if (act == ACT_RELU) {
        y = fmaxf(y, 0.f);
      } else if (act == ACT_ADD_RELU) {
        y = fmaxf(round_to<T>(y + to_f(b.v[v])), 0.f);
      }
      o.v[v] = from_f<T>(y);
    }
    *reinterpret_cast<Vec<T, V>*>(out + i) = o;
  }
}

template <typename T, int V>
static int run(const void* x, const void* skip, void* out, void* part, int N, int S, int C,
               int tile_c, int rows_per_chunk, int chunks, float eps, int act,
               cudaStream_t stream) {
  const dim3 grid(chunks, (C + tile_c - 1) / tile_c, N);
  in_stats<T, V><<<grid, kThreads, 0, stream>>>((const T*)x, (float2*)part, S, C, tile_c,
                                                rows_per_chunk, chunks);
  in_apply<T, V><<<grid, kThreads, 0, stream>>>((const T*)x, (const T*)skip, (T*)out,
                                                (const float2*)part, S, C, tile_c,
                                                rows_per_chunk, chunks, eps, act);
  return launch_status();
}

template <typename T>
static int run_v(int V, const void* x, const void* skip, void* out, void* part, int N, int S,
                 int C, int tile_c, int rows_per_chunk, int chunks, float eps, int act,
                 cudaStream_t st) {
  switch (V) {
    case 8:
      return run<T, 8>(x, skip, out, part, N, S, C, tile_c, rows_per_chunk, chunks, eps, act, st);
    case 4:
      return run<T, 4>(x, skip, out, part, N, S, C, tile_c, rows_per_chunk, chunks, eps, act, st);
    case 2:
      return run<T, 2>(x, skip, out, part, N, S, C, tile_c, rows_per_chunk, chunks, eps, act, st);
    case 1:
      return run<T, 1>(x, skip, out, part, N, S, C, tile_c, rows_per_chunk, chunks, eps, act, st);
  }
  return (int)cudaErrorInvalidValue;
}

// x, skip, out: (N, S, C) contiguous; part: float32 scratch (N, chunks, C, 2).
// V (1, 2, 4 or 8; at most 16 bytes) divides C and the pointers' alignment;
// tile_c = min(C, 256 * V) is a multiple of V; rows_per_chunk * chunks >= S.
extern "C" int instance_norm_act(const void* x, const void* skip, void* out, void* part,
                                 int N, int S, int C, int V, int tile_c, int rows_per_chunk,
                                 int chunks, float eps, int act, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return run_v<__nv_bfloat16>(V, x, skip, out, part, N, S, C, tile_c, rows_per_chunk,
                                chunks, eps, act, st);
  if (V > 4) return (int)cudaErrorInvalidValue;
  return run_v<float>(V, x, skip, out, part, N, S, C, tile_c, rows_per_chunk, chunks, eps,
                      act, st);
}
