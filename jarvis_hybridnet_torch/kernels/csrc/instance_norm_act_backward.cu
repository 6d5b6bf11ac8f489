// K6 instance_norm_act_backward: the gradient of K1 (InstanceNorm over S of
// (N, S, C), eps, no affine, biased variance, then none / silu / relu /
// add_relu) with respect to its input, and to the residual for add_relu.
//
// Replaces: the VJP that jax.value_and_grad builds through
// models/layers.py::instance_norm and the activation after it (v2v.py:93,
// 107, 112-113, 125; efficientnet.py:165-166, 220 for SiLU) inside the
// jitted train step (trainer3d.py:171-180). The Pallas kernel it pairs with
// (tools/fused_norm_bench.py::_kernel) has no backward.
//
// Per (n, c), with xhat = (x - mean) * rstd and g = dy * act'(.):
//   dx = rstd * (g - mean_S(g) - xhat * mean_S(g * xhat)),  dskip = g.
// act' is 1 (none), the mask y > 0 of the forward output y (relu, add_relu:
// y = relu(IN(x) + skip)), or silu'(v) = s * (1 + v * (1 - s)), s = 1 / (1 +
// exp(-v)), at v = IN(x) rounded to the working type as the forward rounds
// it. The statistics are recomputed from x (one more read of x), so K1 keeps
// its C interface and its launch plan.
//
// Bound on the H100: bytes. The least traffic is one read of x, dy and y
// (none of them for every act) and one write of dx (and dskip). A sample of
// V2V's largest shape (36^3 rows of 46 float32 channels, 8.6 MB a tensor)
// does not fit in a cluster's shared memory, so the kernel runs three
// passes, each a grid of (chunks, N) blocks, the later ones mostly from the
// 50 MB L2:
//   1. k6_stats: per chunk of rows, the mean and then the sum of squared
//      deviations from it (two passes over the chunk, never E[x^2] -
//      mean^2), written as partials.
//   2. k6_sums: every block merges all chunks' partials of its sample in
//      chunk order (Chan et al.), so all blocks hold the same mean and rstd;
//      then it sums g and g * xhat over its chunk into partials. The blocks
//      of chunk 0 write the statistics for pass 3.
//   3. k6_apply: sums the g partials in chunk order and writes dx (and
//      dskip), element by element.
// Threads are laid out (row lanes x channels): one step of a block reads
// whole rows, neighbouring threads on neighbouring channels; lanes are
// reduced in lane order, so the result does not depend on scheduling.
#include "common.cuh"

#define ACT_NONE 0
#define ACT_SILU 1
#define ACT_RELU 2
#define ACT_ADD_RELU 3

struct Layout {
  int tpr;    // threads per row: min(C, blockDim)
  int lanes;  // rows in flight
  int lane;
  int c0;
  __device__ Layout(int C) {
    tpr = min(C, (int)blockDim.x);
    lanes = blockDim.x / tpr;
    lane = threadIdx.x / tpr;
    c0 = threadIdx.x % tpr;
  }
};

// Sum of lanes * C per-lane values in shared memory, lane by lane, into red[c].
__device__ __forceinline__ void reduce_lanes(const float* lane_sum, float* red, int lanes, int C) {
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int l = 0; l < lanes; ++l) s += lane_sum[l * C + c];
    red[c] = s;
  }
}

template <typename T>
__global__ void k6_stats(const T* __restrict__ x, float* __restrict__ part, int S, int C,
                         int chunk, int nchunk) {
  extern __shared__ float sh[];
  const Layout L(C);
  float* lane_sum = sh;                   // lanes * C
  float* mean = sh + L.lanes * C;         // C
  const int k = blockIdx.x, n = blockIdx.y;
  const int r0 = k * chunk, r1 = min(S, r0 + chunk);
  const float cnt = (float)(r1 - r0);
  const T* xs = x + (size_t)n * S * C;
  if (L.lane < L.lanes) {
    for (int c = L.c0; c < C; c += L.tpr) {
      float acc = 0.f;
      for (int r = r0 + L.lane; r < r1; r += L.lanes) acc += to_f(xs[(size_t)r * C + c]);
      lane_sum[L.lane * C + c] = acc;
    }
  }
  __syncthreads();
  reduce_lanes(lane_sum, mean, L.lanes, C);
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += blockDim.x) mean[c] /= cnt;
  __syncthreads();
  if (L.lane < L.lanes) {
    for (int c = L.c0; c < C; c += L.tpr) {
      const float m = mean[c];
      float acc = 0.f;
      for (int r = r0 + L.lane; r < r1; r += L.lanes) {
        const float d = to_f(xs[(size_t)r * C + c]) - m;
        acc += d * d;
      }
      lane_sum[L.lane * C + c] = acc;
    }
  }
  __syncthreads();
  float* out = part + ((size_t)n * nchunk + k) * C * 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float s = 0.f;
    for (int l = 0; l < L.lanes; ++l) s += lane_sum[l * C + c];
    out[2 * c] = mean[c];
    out[2 * c + 1] = s;
  }
}

// g = dy * act'(.) at one element.
template <typename T>
__device__ __forceinline__ float grad_in(float dy, float xhat, float y, int act) {
  if (act == ACT_SILU) {
    const float v = round_to<T>(xhat);
    const float s = 1.f / (1.f + expf(-v));
    return dy * (s * (1.f + v * (1.f - s)));
  }
  if (act == ACT_RELU || act == ACT_ADD_RELU) return y > 0.f ? dy : 0.f;
  return dy;
}

template <typename T>
__global__ void k6_sums(const T* __restrict__ x, const T* __restrict__ dy,
                        const T* __restrict__ y, const float* __restrict__ part,
                        float* __restrict__ gpart, float* __restrict__ stats, int S, int C,
                        int chunk, int nchunk, float eps, int act) {
  extern __shared__ float sh[];
  const Layout L(C);
  float* lane_g = sh;                       // lanes * C
  float* lane_gx = sh + L.lanes * C;        // lanes * C
  float* mean = sh + 2 * L.lanes * C;       // C
  float* rstd = mean + C;                   // C
  const int k = blockIdx.x, n = blockIdx.y;
  // the sample's statistics: chunks merged in chunk order (Chan et al.)
  const float* p = part + (size_t)n * nchunk * C * 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float na = 0.f, m = 0.f, m2 = 0.f;
    for (int j = 0; j < nchunk; ++j) {
      const float nb = (float)(min(S, (j + 1) * chunk) - j * chunk);
      const float mb = p[((size_t)j * C + c) * 2], qb = p[((size_t)j * C + c) * 2 + 1];
      const float nab = na + nb;
      const float delta = mb - m;
      m = m + delta * (nb / nab);
      m2 = m2 + qb + delta * delta * (na * nb / nab);
      na = nab;
    }
    mean[c] = m;
    rstd[c] = rsqrtf(m2 / (float)S + eps);
    if (k == 0) {
      stats[((size_t)n * C + c) * 2] = m;
      stats[((size_t)n * C + c) * 2 + 1] = rstd[c];
    }
  }
  __syncthreads();
  const int r0 = k * chunk, r1 = min(S, r0 + chunk);
  const size_t base = (size_t)n * S * C;
  if (L.lane < L.lanes) {
    for (int c = L.c0; c < C; c += L.tpr) {
      const float m = mean[c], rs = rstd[c];
      float sg = 0.f, sgx = 0.f;
      for (int r = r0 + L.lane; r < r1; r += L.lanes) {
        const size_t i = base + (size_t)r * C + c;
        const float xhat = (to_f(x[i]) - m) * rs;
        const float g = grad_in<T>(to_f(dy[i]), xhat, y ? to_f(y[i]) : 0.f, act);
        sg += g;
        sgx += g * xhat;
      }
      lane_g[L.lane * C + c] = sg;
      lane_gx[L.lane * C + c] = sgx;
    }
  }
  __syncthreads();
  float* out = gpart + ((size_t)n * nchunk + k) * C * 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int l = 0; l < L.lanes; ++l) {
      a += lane_g[l * C + c];
      b += lane_gx[l * C + c];
    }
    out[2 * c] = a;
    out[2 * c + 1] = b;
  }
}

template <typename T>
__global__ void k6_apply(const T* __restrict__ x, const T* __restrict__ dy,
                         const T* __restrict__ y, const float* __restrict__ gpart,
                         const float* __restrict__ stats, T* __restrict__ dx,
                         T* __restrict__ dskip, int S, int C, int chunk, int nchunk, int act) {
  extern __shared__ float sh[];
  const Layout L(C);
  float* mean = sh;
  float* rstd = sh + C;
  float* mg = sh + 2 * C;
  float* mgx = sh + 3 * C;
  const int k = blockIdx.x, n = blockIdx.y;
  const float* p = gpart + (size_t)n * nchunk * C * 2;
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float a = 0.f, b = 0.f;
    for (int j = 0; j < nchunk; ++j) {
      a += p[((size_t)j * C + c) * 2];
      b += p[((size_t)j * C + c) * 2 + 1];
    }
    mg[c] = a / (float)S;
    mgx[c] = b / (float)S;
    mean[c] = stats[((size_t)n * C + c) * 2];
    rstd[c] = stats[((size_t)n * C + c) * 2 + 1];
  }
  __syncthreads();
  if (L.lane >= L.lanes) return;
  const int r0 = k * chunk, r1 = min(S, r0 + chunk);
  const size_t base = (size_t)n * S * C;
  for (int c = L.c0; c < C; c += L.tpr) {
    const float m = mean[c], rs = rstd[c], a = mg[c], b = mgx[c];
    for (int r = r0 + L.lane; r < r1; r += L.lanes) {
      const size_t i = base + (size_t)r * C + c;
      const float xhat = (to_f(x[i]) - m) * rs;
      const float g = grad_in<T>(to_f(dy[i]), xhat, y ? to_f(y[i]) : 0.f, act);
      dx[i] = from_f<T>(rs * (g - a - xhat * b));
      if (dskip) dskip[i] = from_f<T>(g);
    }
  }
}

template <typename T>
static int launch(const void* x, const void* dy, const void* y, void* dx, void* dskip,
                  float* scratch, int N, int S, int C, int chunk, int nchunk, int threads,
                  float eps, int act, cudaStream_t st) {
  const int tpr = C < threads ? C : threads;
  const int lanes = threads / tpr;
  float* part = scratch;
  float* gpart = part + (size_t)N * nchunk * C * 2;
  float* stats = gpart + (size_t)N * nchunk * C * 2;
  const dim3 grid(nchunk, N);
  const T* xt = (const T*)x;
  const T* dyt = (const T*)dy;
  const T* yt = (act == ACT_RELU || act == ACT_ADD_RELU) ? (const T*)y : nullptr;
  k6_stats<T><<<grid, threads, (lanes + 1) * C * sizeof(float), st>>>(xt, part, S, C, chunk,
                                                                      nchunk);
  int err = launch_status();
  if (err) return err;
  k6_sums<T><<<grid, threads, (2 * lanes + 2) * C * sizeof(float), st>>>(
      xt, dyt, yt, part, gpart, stats, S, C, chunk, nchunk, eps, act);
  err = launch_status();
  if (err) return err;
  k6_apply<T><<<grid, threads, 4 * C * sizeof(float), st>>>(
      xt, dyt, yt, gpart, stats, (T*)dx, (T*)dskip, S, C, chunk, nchunk, act);
  return launch_status();
}

// x, dy, y, dx (and dskip for add_relu): (N, S, C) contiguous, of dtype;
// y, the forward output, is read for relu and add_relu only. scratch holds
// 4 * N * nchunk * C + 2 * N * C floats. Chunks of `chunk` rows, nchunk of
// them per sample, blocks of `threads` threads. Three launches on `stream`.
extern "C" int instance_norm_act_backward(const void* x, const void* dy, const void* y,
                                          void* dx, void* dskip, void* scratch, int N, int S,
                                          int C, int chunk, int nchunk, int threads, float eps,
                                          int act, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if ((size_t)(2 * (threads / (C < threads ? C : threads)) + 2) * C * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  if (dtype == DTYPE_F32)
    return launch<float>(x, dy, y, dx, dskip, (float*)scratch, N, S, C, chunk, nchunk, threads,
                         eps, act, st);
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(x, dy, y, dx, dskip, (float*)scratch, N, S, C, chunk, nchunk,
                                 threads, eps, act, st);
  return (int)cudaErrorInvalidValue;
}
