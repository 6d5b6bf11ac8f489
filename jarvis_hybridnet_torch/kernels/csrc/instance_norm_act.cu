// K1 instance_norm_act: InstanceNorm (eps, no affine, biased variance,
// float32 statistics) fused with the op that follows it, in one launch.
//
// Replaces: tools/fused_norm_bench.py::_kernel / instance_norm_silu_fused
// (the repo's one Pallas kernel) and models/layers.py::instance_norm with
// its consumers: SiLU (efficientnet.py:165-166,220), ReLU (v2v.py:93,107,125)
// and the residual add + ReLU (v2v.py:112-113).
//
// Bound on the H100: bytes. Per element it does ~10 flops on 2 or 4 bytes
// (~40 with SiLU), below the card's flops-per-byte balance point. The least
// traffic is one read of x (and skip) and one write of the output.
//
// Design: the input is (N, S, C), channels contiguous (NHWC / NDHWC memory),
// so a span of rows of one sample is one contiguous byte range. One thread
// block cluster owns one sample (all C channels); its CTAs split the S rows
// into contiguous spans (the launch plan, kernels/instance_norm.py, picks
// the cluster size, the block size, the span and what stays resident).
//   1. Load once: one thread brings the first `resident` rows of the CTA's
//      span into shared memory with 1-D bulk TMA copies (cp.async.bulk), in
//      stages that complete on mbarriers. Where a span is larger than shared
//      memory, the other rows stream through a small ring of stages, also by
//      bulk copies, once per pass (the second and third time from L2); the
//      skip input of add_relu then streams through the ring too. Every copy
//      is a 16-byte aligned multiple of 16 bytes. A sample that does not
//      start on 16 bytes (S * C * itemsize % 16 != 0) takes plain loads.
//   2. Per-CTA statistics by two passes: the mean, then sum((x - mean)^2);
//      the variance is never E[x^2] - mean^2. Threads are laid out (row lanes
//      x channel vectors of V), so one step of the block reads a contiguous
//      run of whole rows; lanes are reduced in lane order.
//   3. The partials (mean, M2) stay in shared memory; after cluster.sync()
//      every CTA reads all ranks' partials through distributed shared memory
//      and merges them (Chan et al.) in rank order, so every CTA holds the
//      same statistics bit for bit. A second cluster.sync() keeps each CTA's
//      shared memory alive until all ranks have read it.
//   4. Normalize and apply the epilogue, rounding to the working type where
//      the JAX code rounds (after the norm, after the residual add, per op
//      inside SiLU).
// Optionally a per-channel bias is added to every element as it is read,
// rounded to the working type (the value of the separate `conv + bias` that
// flax's bf16 nn.Conv rounds before the norm), so the convolution before the
// norm need not add it in a launch of its own.
// Optionally (the training step's forward) rank 0 of each cluster writes the
// (mean, rstd) the epilogue used, float32 (N, C, 2): K6, the backward,
// starts from them and recomputes nothing.
// Needs sm_90 (clusters, distributed shared memory, bulk TMA, mbarriers) and
// the cluster launch API (cudaLaunchKernelEx).
#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

#define ACT_NONE 0
#define ACT_SILU 1
#define ACT_RELU 2
#define ACT_ADD_RELU 3

constexpr int kMaxThreads = 1024;
constexpr int kStages = 4;  // bulk copies that bring in the resident rows
constexpr int kRing = 4;    // stages of the ring that streams the other rows
constexpr int kPasses = 3;  // mean, squared deviations, normalize
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
constexpr int kAuxOffset = 256;  // below it: kStages + kPasses * 2 * kRing mbarriers

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

// rows a thread loads before it uses them: at least 16 bytes, at most 4 rows
template <typename T, int V>
__host__ __device__ constexpr int unroll() {
  return sizeof(T) * V >= 16 ? 1 : 16 / (sizeof(T) * V) > 4 ? 4 : 16 / (sizeof(T) * V);
}

// Rows [lo, hi) of rank's span, the same arithmetic as the launch plan.
__device__ __forceinline__ int span_lo(int rank, int span, int S) { return min(S, rank * span); }
__device__ __forceinline__ int span_hi(int rank, int span, int S) {
  return min(S, (rank + 1) * span);
}

// Element k of a thread's vector as read: x, or with kBias x + bias[k]
// rounded to T (bias: the thread's channels of the bias).
template <typename T, bool kBias>
__device__ __forceinline__ float biased(T v, const float* bias, int k) {
  if constexpr (kBias) return round_to<T>(__fadd_rn(to_f(v), bias[k]));
  return to_f(v);
}

template <typename T, int V, bool kBias>
__device__ __forceinline__ Vec<T, V> epilogue(const Vec<T, V>& a, const Vec<T, V>& b,
                                              const float* m, const float* rstd,
                                              const float* bias, int act) {
  Vec<T, V> o;
#pragma unroll
  for (int v = 0; v < V; ++v) {
    float y = round_to<T>((biased<T, kBias>(a.v[v], bias, v) - m[v]) * rstd[v]);
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
  return o;
}

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// One thread's share of the block: row lane `lane` of L, channels c0..c0+V.
// The row pointers given to it point at row 0 of the span, in whatever
// memory holds the rows it is asked for (shared or global).
template <typename T, int V, bool kBias>
struct Lane {
  int lane, L, C, c0;
  bool on;
  float bias[V];  // with kBias, the bias of channels c0..c0+V

  // sums (kSquares false) or squared deviations from m of rows [lo, hi),
  // each element with its bias added (kBias)
  template <bool kSquares>
  __device__ __forceinline__ void accumulate(const T* x, int lo, int hi, const float* m,
                                             float* acc) const {
    if (!on) return;
    constexpr int U = unroll<T, V>();
    int r = lo + lane;
    for (; r + (U - 1) * L < hi; r += U * L) {
      Vec<T, V> a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) a[u] = load<T, V>(x + (size_t)(r + u * L) * C + c0);
#pragma unroll
      for (int u = 0; u < U; ++u)
#pragma unroll
        for (int v = 0; v < V; ++v) {
          const float d = biased<T, kBias>(a[u].v[v], bias, v) - (kSquares ? m[v] : 0.f);
          acc[v] += kSquares ? d * d : d;
        }
    }
    for (; r < hi; r += L) {
      const Vec<T, V> a = load<T, V>(x + (size_t)r * C + c0);
#pragma unroll
      for (int v = 0; v < V; ++v) {
        const float d = biased<T, kBias>(a.v[v], bias, v) - (kSquares ? m[v] : 0.f);
        acc[v] += kSquares ? d * d : d;
      }
    }
  }

  // the epilogue of rows [lo, hi) into out (global, row 0 of the span)
  __device__ __forceinline__ void apply(const T* x, const T* skip, T* out, int lo, int hi,
                                        const float* m, const float* rstd, int act) const {
    if (!on) return;
    constexpr int U = unroll<T, V>();
    Vec<T, V> b[U];
    int r = lo + lane;
    for (; r + (U - 1) * L < hi; r += U * L) {
      Vec<T, V> a[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const size_t i = (size_t)(r + u * L) * C + c0;
        a[u] = load<T, V>(x + i);
        if (act == ACT_ADD_RELU) b[u] = load<T, V>(skip + i);
      }
#pragma unroll
      for (int u = 0; u < U; ++u)
        *reinterpret_cast<Vec<T, V>*>(out + (size_t)(r + u * L) * C + c0) =
            epilogue<T, V, kBias>(a[u], b[u], m, rstd, bias, act);
    }
    for (; r < hi; r += L) {
      const size_t i = (size_t)r * C + c0;
      if (act == ACT_ADD_RELU) b[0] = load<T, V>(skip + i);
      *reinterpret_cast<Vec<T, V>*>(out + i) =
          epilogue<T, V, kBias>(load<T, V>(x + i), b[0], m, rstd, bias, act);
    }
  }
};

// The ring: kRing stages of `rows` rows of x and as many of skip. A pass
// without skip uses the skip half as kRing more stages of x. Chunk i of rows
// [lo, hi) goes to stage i % n, n the pass's stage count; each pass has its
// own 2 * kRing mbarriers, so a stage's phase parity is (i / n) & 1. Every
// thread consumes every chunk and the block synchronizes before thread 0
// refills the stage.
template <typename T>
struct Ring {
  T* buf;  // 2 * kRing stages of rows * C elements
  uint64_t* bar;
  int rows, C;

  __device__ __forceinline__ int chunks(int lo, int hi) const {
    return (hi - lo + rows - 1) / rows;
  }

  __device__ __forceinline__ static int stages(const T* sg) {
    return sg != nullptr ? kRing : 2 * kRing;
  }

  // chunk i's rows of x (those at or past x_lo) and of skip (sg null: none);
  // with skip, stage s holds x at s and skip at kRing + s
  __device__ __forceinline__ void issue(int pass, int i, int lo, int hi, int x_lo, const T* xg,
                                        const T* sg) const {
    const int a = lo + i * rows, b = min(hi, a + rows), s = i % stages(sg);
    const bool want_x = a >= x_lo;
    const uint32_t bytes = (uint32_t)(b - a) * C * sizeof(T);
    uint64_t* br = &bar[pass * 2 * kRing + s];
    mbar_expect_tx(br, bytes * ((int)want_x + (int)(sg != nullptr)));
    if (want_x) bulk_load(buf + (size_t)s * rows * C, xg + (size_t)a * C, bytes, br);
    if (sg != nullptr)
      bulk_load(buf + (size_t)(kRing + s) * rows * C, sg + (size_t)a * C, bytes, br);
  }

  // thread 0 starts the first chunks of a pass
  __device__ __forceinline__ void start(int pass, int lo, int hi, int x_lo, const T* xg,
                                        const T* sg) const {
    if (threadIdx.x != 0) return;
    const int n = min(chunks(lo, hi), stages(sg));
    for (int i = 0; i < n; ++i) issue(pass, i, lo, hi, x_lo, xg, sg);
  }

  // consume(a, b, x, skip) for each chunk, rows [a, b), the pointers at
  // row 0 of the span in the chunk's stage
  template <typename F>
  __device__ __forceinline__ void run(int pass, int lo, int hi, int x_lo, const T* xg,
                                      const T* sg, F consume) const {
    const int n = chunks(lo, hi), ns = stages(sg);
    for (int i = 0; i < n; ++i) {
      const int a = lo + i * rows, b = min(hi, a + rows), s = i % ns;
      mbar_wait(&bar[pass * 2 * kRing + s], (i / ns) & 1);
      const size_t back = (size_t)s * rows * C - (size_t)a * C;
      consume(a, b, buf + back, buf + back + (size_t)kRing * rows * C);
      __syncthreads();
      if (threadIdx.x == 0 && i + ns < n) issue(pass, i + ns, lo, hi, x_lo, xg, sg);
    }
  }
};

// grid (cluster, N), cluster (cluster, 1, 1); block rank = span index;
// blockDim.x threads, laid out (row lanes x C / V channel vectors).
// span: rows per rank. resident: most rows a CTA keeps in shared memory, a
// multiple of q (the rows in 16 bytes). ring_rows: rows per ring stage (a
// multiple of q), or 0: then every span is resident, or resident is 0 and
// the rows take plain loads. data_off, ring_off: byte offsets of the
// resident rows and of the ring in dynamic shared memory.
template <typename T, int V, bool kBias>
__global__ void __launch_bounds__(kMaxThreads, 1)
    in_fused(const T* __restrict__ x, const T* __restrict__ skip,
             const T* __restrict__ bias_in, T* __restrict__ out, float* __restrict__ stats,
             int S, int C, int span, int resident, int ring_rows, int q, int data_off,
             int ring_off, float eps, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();

  const int G = C / V;  // channel vectors per row
  const int L = (int)blockDim.x / G;
  Lane<T, V, kBias> me{(int)threadIdx.x / G, L, C, ((int)threadIdx.x % G) * V,
                       (int)threadIdx.x < L * G};
  if constexpr (kBias) {
#pragma unroll
    for (int v = 0; v < V; ++v) me.bias[v] = me.on ? to_f(bias_in[me.c0 + v]) : 0.f;
  }
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem);  // kStages, then the ring's
  float* lane_part = reinterpret_cast<float*>(smem + kAuxOffset);  // [L][C]
  float* cta_mean = lane_part + L * C;                             // [C], read by the cluster
  float* cta_m2 = cta_mean + C;                                    // [C], read by the cluster
  float* st_mean = cta_m2 + C;                                     // [C]
  float* st_rstd = st_mean + C;                                    // [C]
  T* data = reinterpret_cast<T*>(smem + data_off);
  const Ring<T> ring{reinterpret_cast<T*>(smem + ring_off), bar + kStages, ring_rows, C};

  const int r0 = span_lo(rank, span, S), r1 = span_hi(rank, span, S);
  const int rows = r1 - r0;
  const bool streamed = ring_rows > 0;  // rows [res, rows) come through the ring
  int res = min(resident, rows);
  res -= res % (streamed ? ring_rows : q);
  const int st_rows = ((res + kStages - 1) / kStages + q - 1) / q * q;
  const size_t row0 = (size_t)blockIdx.y * S + r0;  // first row of the span
  const T* xs = x + row0 * C;
  const T* ks = skip == nullptr ? nullptr : skip + row0 * C;
  T* os = out + row0 * C;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages + kPasses * 2 * kRing; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) {
      const int a = min(res, i * st_rows), b = min(res, (i + 1) * st_rows);
      if (b > a) {
        const uint32_t bytes = (uint32_t)(b - a) * C * sizeof(T);
        mbar_expect_tx(&bar[i], bytes);
        bulk_load(data + (size_t)a * C, xs + (size_t)a * C, bytes, &bar[i]);
      }
    }
  }
  if (streamed) ring.start(0, res, rows, res, xs, nullptr);

  // the lanes' partials of one pass, reduced per channel in lane order
  auto reduce = [&](const float* acc, float* dst, bool mean) {
    if (me.on) {
#pragma unroll
      for (int v = 0; v < V; ++v) lane_part[me.lane * C + me.c0 + v] = acc[v];
    }
    __syncthreads();
    for (int c = threadIdx.x; c < C; c += blockDim.x) {
      float s = 0.f;
      for (int l = 0; l < L; ++l) s += lane_part[l * C + c];
      dst[c] = !mean ? s : rows > 0 ? s / (float)rows : 0.f;
    }
  };

  // pass 1: the span's sums
  float acc[V], m[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = m[v] = 0.f;
  for (int i = 0; i < kStages; ++i) {
    const int a = min(res, i * st_rows), b = min(res, (i + 1) * st_rows);
    if (b <= a) break;
    mbar_wait(&bar[i], 0);
    me.template accumulate<false>(data, a, b, m, acc);
  }
  if (streamed)
    ring.run(0, res, rows, res, xs, nullptr, [&](int a, int b, const T* xr, const T*) {
      me.template accumulate<false>(xr, a, b, m, acc);
    });
  else
    me.template accumulate<false>(xs, res, rows, m, acc);
  reduce(acc, cta_mean, true);
  if (streamed) ring.start(1, res, rows, res, xs, nullptr);
  __syncthreads();

  // pass 2: squared deviations from the span's mean
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = me.on ? cta_mean[me.c0 + v] : 0.f;
    acc[v] = 0.f;
  }
  me.template accumulate<true>(data, 0, res, m, acc);
  if (streamed)
    ring.run(1, res, rows, res, xs, nullptr, [&](int a, int b, const T* xr, const T*) {
      me.template accumulate<true>(xr, a, b, m, acc);
    });
  else
    me.template accumulate<true>(xs, res, rows, m, acc);
  reduce(acc, cta_m2, false);
  // the normalize pass streams the rows past res, and with add_relu the
  // skip of the whole span
  const int apply_lo = act == ACT_ADD_RELU ? 0 : res;
  if (streamed) ring.start(2, apply_lo, rows, res, xs, ks);

  // merge the ranks' partials in rank order through distributed shared memory
  cluster.sync();
  for (int c = threadIdx.x; c < C; c += blockDim.x) {
    float n_a = 0.f, mean = 0.f, m2 = 0.f;
    for (int i = 0; i < cs; ++i) {
      const float n_b = (float)(span_hi(i, span, S) - span_lo(i, span, S));
      if (n_b == 0.f) continue;
      const float mb = cluster.map_shared_rank(cta_mean, i)[c];
      const float qb = cluster.map_shared_rank(cta_m2, i)[c];
      const float n_ab = n_a + n_b;
      const float delta = mb - mean;
      mean += delta * (n_b / n_ab);
      m2 += qb + delta * delta * (n_a * n_b / n_ab);
      n_a = n_ab;
    }
    st_mean[c] = mean;
    st_rstd[c] = 1.f / sqrtf(m2 / (float)S + eps);
    if (stats != nullptr && rank == 0) {
      stats[((size_t)blockIdx.y * C + c) * 2] = mean;
      stats[((size_t)blockIdx.y * C + c) * 2 + 1] = st_rstd[c];
    }
  }
  cluster.sync();  // no rank's partials are read after this; st_* are visible

  float rstd[V];
#pragma unroll
  for (int v = 0; v < V; ++v) {
    m[v] = me.on ? st_mean[me.c0 + v] : 0.f;
    rstd[v] = me.on ? st_rstd[me.c0 + v] : 0.f;
  }
  if (streamed) {
    if (apply_lo == res) me.apply(data, ks, os, 0, res, m, rstd, act);
    ring.run(2, apply_lo, rows, res, xs, ks, [&](int a, int b, const T* xr, const T* sr) {
      me.apply(a < res ? data : xr, sr, os, a, b, m, rstd, act);
    });
  } else {
    me.apply(data, ks, os, 0, res, m, rstd, act);
    me.apply(xs, ks, os, res, rows, m, rstd, act);
  }
}

template <typename T, int V, bool kBias>
static cudaError_t prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
                           int threads, int N, int smem, cudaStream_t st) {
  static bool ready = false;  // function attributes, set once per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(in_fused<T, V, kBias>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    // clusters of 9-16 are measured by kernel_sweep.py; the plan uses <= 8
    e = cudaFuncSetAttribute(in_fused<T, V, kBias>, cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, N, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

struct Args {
  const void *x, *skip, *bias;
  void *out, *stats;
  int N, S, C, cluster, threads, span, resident, ring_rows, q, data_off, ring_off, smem;
  float eps;
  int act;
};

template <typename T, int V, bool kBias>
static int launch(const Args& a, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare<T, V, kBias>(&cfg, &attr, a.cluster, a.threads, a.N, a.smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, in_fused<T, V, kBias>, (const T*)a.x, (const T*)a.skip,
                         (const T*)a.bias, (T*)a.out, (float*)a.stats, a.S, a.C, a.span,
                         a.resident, a.ring_rows, a.q, a.data_off, a.ring_off, a.eps, a.act);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

template <typename T, int V, bool kBias>
static int max_clusters(int cluster, int threads, int smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = prepare<T, V, kBias>(&cfg, &attr, cluster, threads, 1, smem, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(n, in_fused<T, V, kBias>, &cfg);
}

// the fewer clusters of the two instantiations, with and without a bias
template <typename T, int V>
static int max_clusters_any(int cluster, int threads, int smem, int* n) {
  int with_bias = 0;
  int e = max_clusters<T, V, false>(cluster, threads, smem, n);
  if (e == 0) e = max_clusters<T, V, true>(cluster, threads, smem, &with_bias);
  if (e == 0 && with_bias < *n) *n = with_bias;
  return e;
}

// V channels per vector load (bf16: 8, 4, 2, 1; f32: 4, 2, 1); every other
// combination is refused.
#define DISPATCH(dtype, V, CALL)               \
  do {                                         \
    if ((dtype) == DTYPE_BF16) {               \
      switch (V) {                             \
        case 8: return CALL(__nv_bfloat16, 8); \
        case 4: return CALL(__nv_bfloat16, 4); \
        case 2: return CALL(__nv_bfloat16, 2); \
        case 1: return CALL(__nv_bfloat16, 1); \
      }                                        \
    } else if ((dtype) == DTYPE_F32) {         \
      switch (V) {                             \
        case 4: return CALL(float, 4);         \
        case 2: return CALL(float, 2);         \
        case 1: return CALL(float, 1);         \
      }                                        \
    }                                          \
    return (int)cudaErrorInvalidValue;         \
  } while (0)

// x, skip, out: (N, S, C) contiguous, 16-byte aligned; skip may be null
// unless act is add_relu. bias: (C,) in x's type, added to x as it is read,
// or null. stats: float32 (N, C, 2), (mean, rstd) per
// channel, or null. The plan (V, cluster, threads, span, resident,
// ring_rows, q, data_off, ring_off, smem) comes from
// kernels/instance_norm.py::launch_plan.
extern "C" int instance_norm_act(const void* x, const void* skip, const void* bias, void* out,
                                 void* stats, int N, int S, int C, int V, int cluster,
                                 int threads, int span, int resident, int ring_rows, int q,
                                 int data_off, int ring_off, int smem, float eps, int act,
                                 int dtype, void* stream) {
  const Args a{x,    skip,     bias,      out, stats,    N,        S,    C,   cluster,
               threads, span, resident, ring_rows, q, data_off, ring_off, smem, eps, act};
  const cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(T, V) \
  (bias != nullptr ? launch<T, V, true>(a, st) : launch<T, V, false>(a, st))
  DISPATCH(dtype, V, LAUNCH);
#undef LAUNCH
}

// How many clusters of this plan the card can hold at once (0: none), with
// a bias operand or without.
extern "C" int instance_norm_act_max_clusters(int V, int cluster, int threads, int smem,
                                              int dtype, int* n) {
#define QUERY(T, V) max_clusters_any<T, V>(cluster, threads, smem, n)
  DISPATCH(dtype, V, QUERY);
#undef QUERY
}
