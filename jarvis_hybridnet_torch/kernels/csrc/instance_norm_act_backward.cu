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
// mean and rstd are the forward's own (K1's stats output), so xhat is the
// forward's value bit for bit. act' is 1 (none); for relu the mask v > 0 of
// v = xhat rounded to the working type, which is the forward's y > 0
// (chip_smoke.py holds the two equal); for add_relu the mask y > 0 of the
// forward output y = relu(v + skip); for silu silu'(v) = s * (1 + v * (1 -
// s)), s = 1 / (1 + exp(-v)).
//
// Bound on the H100: bytes. The least traffic is one read of x and dy (and
// y for add_relu) and one write of dx (and dskip).
//
// Design: one launch, a persistent grid of co-resident blocks (about two per
// SM; a cooperative launch, so the runtime refuses a grid that cannot be
// co-resident). Each sample's rows are cut into `parts` contiguous spans,
// one per block (the launch plan, kernels/instance_norm.py::backward_plan):
//   1. Each block bulk-copies (TMA, in stages on mbarriers) the first
//      `res` rows of its span of x, dy (and y) into shared memory, 16-byte
//      copies over the flat element index; at V2V's largest training shape
//      every row of every tensor is read from HBM once and held. Threads
//      are laid out over groups of q rows, q * C elements, a whole number
//      W of 16-byte vectors: thread w of a lane always holds the same V
//      channels, (w * V + k) mod C, so its sums of g and g * xhat stay in
//      registers; lanes are reduced in lane order.
//   2. The partials are merged once per (n, c), in a fixed order: each rank
//      writes its sums into rank 0 of its thread block cluster (distributed
//      shared memory), rank 0 sums them in rank order, writes the cluster's
//      sums and arrives at one grid-wide barrier (one arrival a cluster);
//      once it completes every block sums the clusters' sums of its sample
//      in cluster order. Two calls are bit-equal whatever the scheduling.
//   3. Each block writes dx (and dskip) of its span from the rows it holds
//      (rows past `res`, where a span does not fit, are read again).
// Where the grid holds fewer blocks than samples (many small samples) a
// block walks whole samples, one after another, and needs no barrier. The
// grid barrier's word is left as found but for one bit, so a call captured
// in a CUDA graph replays. Needs sm_90 (clusters, distributed shared
// memory, bulk TMA, mbarriers) and cudaLaunchKernelEx.
#include <cooperative_groups.h>

#include "common.cuh"
#include "tma.cuh"

namespace cg = cooperative_groups;

#define ACT_NONE 0
#define ACT_SILU 1
#define ACT_RELU 2
#define ACT_ADD_RELU 3

constexpr int kMaxThreads = 512;
constexpr int kStages = 4;         // bulk copies that bring in a span's rows
constexpr int kSmemMax = 232448;   // dynamic shared memory a block may use
constexpr int kUnroll = 2;         // groups a thread loads before it uses them

// The launch plan (kernels/instance_norm.py::BackwardPlan), in its order.
struct Plan {
  int N, S, C;
  int W;         // 16-byte vectors (V elements) in a group of q rows
  int q;         // rows in a group
  int parts;     // spans per sample; 1: a block walks whole samples
  int cluster;   // CTAs per cluster (divides parts)
  int span;      // rows per span, a multiple of q
  int res;       // rows of a span held in shared memory, a multiple of q
  int st_rows;   // rows per bulk-copy stage, a multiple of q
  int red_off, part_off, tot_off, data_off;  // byte offsets in shared memory
};

template <typename T, int V>
struct alignas(sizeof(T) * V) Vec {
  T v[V];
};

template <typename T, int V>
__device__ __forceinline__ Vec<T, V> load(const T* p) {
  return *reinterpret_cast<const Vec<T, V>*>(p);
}

// g = dy * act'(.) at one element.
template <typename T>
__device__ __forceinline__ float grad_in(float dy, float xhat, float y, int act) {
  if (act == ACT_SILU) {
    const float v = round_to<T>(xhat);
    const float s = 1.f / (1.f + expf(-v));
    return dy * (s * (1.f + v * (1.f - s)));
  }
  if (act == ACT_RELU) return round_to<T>(xhat) > 0.f ? dy : 0.f;
  if (act == ACT_ADD_RELU) return y > 0.f ? dy : 0.f;
  return dy;
}

__device__ __forceinline__ uint32_t ld_acquire(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}

// The grid barrier on the word *bar (0 before the first call). Each of the
// `arrivals` arriving blocks adds 1 with release semantics, one of them
// (the leader) 2^31 - (arrivals - 1): bit 31 flips when the last one
// arrives, and the low bits are back at 0, ready for the next call. Any
// block waits by reading the word once before the barrier can complete
// (`before`) and then until bit 31 differs from it. A wait that never ends
// traps. Thread 0 calls these.
__device__ __forceinline__ void barrier_arrive(uint32_t* bar, uint32_t arrivals, bool leader) {
  const uint32_t inc = leader ? 0x80000000u - (arrivals - 1) : 1u;
  asm volatile("red.release.gpu.global.add.u32 [%0], %1;" ::"l"(bar), "r"(inc) : "memory");
}

__device__ __forceinline__ void barrier_wait(const uint32_t* bar, uint32_t before) {
  for (long long spins = 0; ((ld_acquire(bar) ^ before) & 0x80000000u) == 0; ++spins)
    if (spins == (1ll << 24)) __trap();
}

// One thread's share of a span: groups lane, lane + lanes, ... of q rows;
// in each, the V elements at w * V (channels ch[k]).
template <typename T, int V>
struct Lane {
  int lane, lanes, ge, off;  // off = w * V
  bool on;
  float m[V], rs[V];  // the channels' mean and rstd

  // sums of g and g * xhat over groups [g0, g1) of the rows at x, dy, y
  __device__ __forceinline__ void sums(const T* x, const T* dy, const T* y, int g0, int g1,
                                       int act, float* sg, float* sgx) const {
    if (!on) return;
    int gi = g0 + lane;
    for (; gi + (kUnroll - 1) * lanes < g1; gi += kUnroll * lanes) {
      Vec<T, V> a[kUnroll], d[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = (size_t)(gi + u * lanes) * ge + off;
        a[u] = load<T, V>(x + i);
        d[u] = load<T, V>(dy + i);
        if (act == ACT_ADD_RELU) b[u] = load<T, V>(y + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) add(a[u], d[u], b[u], act, sg, sgx);
    }
    for (; gi < g1; gi += lanes) {
      const size_t i = (size_t)gi * ge + off;
      Vec<T, V> b;
      if (act == ACT_ADD_RELU) b = load<T, V>(y + i);
      add(load<T, V>(x + i), load<T, V>(dy + i), b, act, sg, sgx);
    }
  }

  __device__ __forceinline__ void add(const Vec<T, V>& a, const Vec<T, V>& d,
                                      const Vec<T, V>& b, int act, float* sg, float* sgx) const {
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (to_f(a.v[k]) - m[k]) * rs[k];
      const float g = grad_in<T>(to_f(d.v[k]), xh, act == ACT_ADD_RELU ? to_f(b.v[k]) : 0.f, act);
      sg[k] += g;
      sgx[k] += g * xh;
    }
  }

  // dx (and dskip) of groups [g0, g1): rows read at x, dy, y, written at
  // dx, ds (global), with the means of g (mg) and g * xhat (mgx)
  __device__ __forceinline__ void apply(const T* x, const T* dy, const T* y, T* dx, T* ds,
                                        int g0, int g1, int act, const float* mg,
                                        const float* mgx) const {
    if (!on) return;
    int gi = g0 + lane;
    for (; gi + (kUnroll - 1) * lanes < g1; gi += kUnroll * lanes) {
      Vec<T, V> a[kUnroll], d[kUnroll], b[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const size_t i = (size_t)(gi + u * lanes) * ge + off;
        a[u] = load<T, V>(x + i);
        d[u] = load<T, V>(dy + i);
        if (act == ACT_ADD_RELU) b[u] = load<T, V>(y + i);
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        put(a[u], d[u], b[u], dx, ds, (size_t)(gi + u * lanes) * ge + off, act, mg, mgx);
    }
    for (; gi < g1; gi += lanes) {
      const size_t i = (size_t)gi * ge + off;
      Vec<T, V> b;
      if (act == ACT_ADD_RELU) b = load<T, V>(y + i);
      put(load<T, V>(x + i), load<T, V>(dy + i), b, dx, ds, i, act, mg, mgx);
    }
  }

  __device__ __forceinline__ void put(const Vec<T, V>& a, const Vec<T, V>& d,
                                      const Vec<T, V>& b, T* dx, T* ds, size_t i, int act,
                                      const float* mg, const float* mgx) const {
    Vec<T, V> o, s;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float xh = (to_f(a.v[k]) - m[k]) * rs[k];
      const float g = grad_in<T>(to_f(d.v[k]), xh, act == ACT_ADD_RELU ? to_f(b.v[k]) : 0.f, act);
      o.v[k] = from_f<T>(rs[k] * (g - mg[k] - xh * mgx[k]));
      s.v[k] = from_f<T>(g);
    }
    *reinterpret_cast<Vec<T, V>*>(dx + i) = o;
    if (ds != nullptr) *reinterpret_cast<Vec<T, V>*>(ds + i) = s;
  }
};

// grid: gridDim.x blocks in clusters of p.cluster; block b takes items b,
// b + gridDim.x, ... of the N * parts (sample, span) items (parts > 1: one
// item a block, gridDim.x = N * parts). clsum: N * (parts / cluster) * 2 *
// C floats of cluster sums; bar: the grid barrier's word.
template <typename T, int V>
__global__ void __launch_bounds__(kMaxThreads)
    k6_backward(const T* __restrict__ x, const T* __restrict__ dy, const T* __restrict__ y,
                const float* __restrict__ stats, T* __restrict__ dx, T* __restrict__ dskip,
                float* __restrict__ clsum, uint32_t* __restrict__ bar, const Plan p, int act) {
  extern __shared__ __align__(128) unsigned char smem[];
  uint64_t* mbar = reinterpret_cast<uint64_t*>(smem);                 // kStages
  float* red = reinterpret_cast<float*>(smem + p.red_off);            // 2 * lanes * ge
  // the block's sums (2 * C); in rank 0 of a cluster every rank's, rank r's
  // at r * 2 * C, written there by rank r
  float* part = reinterpret_cast<float*>(smem + p.part_off);
  float* tot = reinterpret_cast<float*>(smem + p.tot_off);            // 2 * C
  float* tmp = tot + 2 * p.C;  // max(2 * C, blockDim.x): the ordered sums' slices
  T* data = reinterpret_cast<T*>(smem + p.data_off);                  // x, dy, y: res * C each
  const int C = p.C, S = p.S;
  const int ge = p.W * V;  // elements in a group
  const int lanes = (int)blockDim.x / p.W;
  Lane<T, V> me;
  me.lane = (int)threadIdx.x / p.W;
  me.lanes = lanes;
  me.ge = ge;
  me.off = ((int)threadIdx.x % p.W) * V;
  me.on = me.lane < lanes;
  int ch[V];
#pragma unroll
  for (int k = 0; k < V; ++k) ch[k] = (me.off + k) % C;
  const size_t region = (size_t)p.res * C;  // elements of one tensor's resident rows
  const T* yy = act == ACT_ADD_RELU ? y : nullptr;
  const int ntens = yy != nullptr ? 3 : 2;

  if (threadIdx.x == 0) {
    for (int i = 0; i < kStages; ++i) mbar_init(&mbar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  uint32_t phase = 0;  // the parity each stage's mbarrier waits for next
  const int items = p.N * p.parts;
  for (int item = blockIdx.x; item < items; item += gridDim.x) {
    const int n = item / p.parts, sp = item % p.parts;
    const int lo = min(S, sp * p.span), hi = min(S, (sp + 1) * p.span);
    const int res = min(p.res, hi - lo);  // rows are whole groups: see the plan
    const size_t base = ((size_t)n * S + lo) * C;
    // the barrier word before this block's cluster can arrive
    const uint32_t before = threadIdx.x == 0 && p.parts > 1 ? ld_acquire(bar) : 0u;
    if (threadIdx.x == 0) {
      for (int k = 0; k < kStages; ++k) {
        const int a = min(res, k * p.st_rows), b = min(res, (k + 1) * p.st_rows);
        if (b <= a) break;
        const uint32_t bytes = (uint32_t)(b - a) * C * sizeof(T);
        mbar_expect_tx(&mbar[k], bytes * ntens);
        bulk_load(data + (size_t)a * C, x + base + (size_t)a * C, bytes, &mbar[k]);
        bulk_load(data + region + (size_t)a * C, dy + base + (size_t)a * C, bytes, &mbar[k]);
        if (yy != nullptr)
          bulk_load(data + 2 * region + (size_t)a * C, yy + base + (size_t)a * C, bytes, &mbar[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < V; ++k) {
      me.m[k] = stats[((size_t)n * C + ch[k]) * 2];
      me.rs[k] = stats[((size_t)n * C + ch[k]) * 2 + 1];
    }

    // 1. sums of g and g * xhat over the span: the resident rows stage by
    // stage, then the rest from global memory
    float sg[V], sgx[V];
#pragma unroll
    for (int k = 0; k < V; ++k) sg[k] = sgx[k] = 0.f;
    const int ng = (hi - lo) / p.q, resg = res / p.q, stg = p.st_rows / p.q;
    for (int k = 0; k < kStages; ++k) {
      const int a = min(resg, k * stg), b = min(resg, (k + 1) * stg);
      if (b <= a) break;
      mbar_wait(&mbar[k], (phase >> k) & 1u);
      phase ^= 1u << k;
      me.sums(data, data + region, data + 2 * region, a, b, act, sg, sgx);
    }
    me.sums(x + base, dy + base, yy == nullptr ? nullptr : yy + base, resg, ng, act, sg, sgx);
    if (me.on) {
#pragma unroll
      for (int k = 0; k < V; ++k) {
        red[me.lane * ge + me.off + k] = sg[k];
        red[(lanes + me.lane) * ge + me.off + k] = sgx[k];
      }
    }
    __syncthreads();
    // per channel: the lanes in order, and in each the q rows of its group
    // (red[which][lane * q + row][c]), into this block's slot of part in
    // rank 0 of its cluster
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = p.parts > 1 && p.cluster > 1 ? (int)cluster.block_rank() : 0;
    ordered_sums<false>(
        red, 2 * C, lanes * p.q, C, [&](int o) { return (o / C) * lanes * ge + o % C; }, tmp,
        rank == 0 ? part : cluster.map_shared_rank(part, 0) + rank * 2 * C);

    // 2. the sample's sums: the cluster's in rank order (rank 0 writes them
    // and alone arrives at the grid barrier), then, after every block has
    // seen the barrier complete, the clusters' in cluster order
    const float* sums = part;
    if (p.parts > 1) {
      const int ncl = p.parts / p.cluster;
      if (p.cluster > 1) cluster.sync();  // every rank's sums are in rank 0
      if (rank == 0) {
        float* mine = clsum + ((size_t)n * ncl + sp / p.cluster) * 2 * C;
        for (int i = threadIdx.x; i < 2 * C; i += blockDim.x) {
          float s = 0.f;
          for (int r = 0; r < p.cluster; ++r) s += part[r * 2 * C + i];
          mine[i] = s;
        }
        __syncthreads();
        if (threadIdx.x == 0) barrier_arrive(bar, gridDim.x / p.cluster, blockIdx.x == 0);
      }
      if (threadIdx.x == 0) barrier_wait(bar, before);
      __syncthreads();
      const float* all = clsum + (size_t)n * ncl * 2 * C;
      ordered_sums<true>(all, 2 * C, ncl, 2 * C, [](int o) { return o; }, tmp, tot);
      sums = tot;
    }

    // 3. dx (and dskip) of the span
    float mg[V], mgx[V];
#pragma unroll
    for (int k = 0; k < V; ++k) {
      mg[k] = sums[ch[k]] / (float)S;
      mgx[k] = sums[C + ch[k]] / (float)S;
    }
    T* ds = dskip == nullptr ? nullptr : dskip + base;
    me.apply(data, data + region, data + 2 * region, dx + base, ds, 0, resg, act, mg, mgx);
    me.apply(x + base, dy + base, yy == nullptr ? nullptr : yy + base, dx + base, ds, resg, ng,
             act, mg, mgx);
    __syncthreads();  // the next item's copies overwrite the rows and sums
  }
}

template <typename T, int V>
static cudaError_t configure(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int blocks,
                             int cluster, int threads, int smem, cudaStream_t st) {
  static bool ready = false;  // function attributes, set once per instantiation
  if (!ready) {
    const cudaError_t e = cudaFuncSetAttribute(
        k6_backward<T, V>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(blocks, 1, 1);
  cfg->blockDim = dim3(threads, 1, 1);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = st;
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  attr[1].id = cudaLaunchAttributeClusterDimension;
  attr[1].val.clusterDim.x = cluster;
  attr[1].val.clusterDim.y = 1;
  attr[1].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = cluster > 1 ? 2 : 1;  // a plain cooperative grid without clusters
  return cudaSuccess;
}

template <typename T, int V>
static int launch(const void* x, const void* dy, const void* y, const void* stats, void* dx,
                  void* dskip, void* clsum, void* bar, const Plan& p, int blocks, int threads,
                  int smem, int act, cudaStream_t st) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  cudaError_t e = configure<T, V>(&cfg, attr, blocks, p.cluster, threads, smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, k6_backward<T, V>, (const T*)x, (const T*)dy, (const T*)y,
                         (const float*)stats, (T*)dx, (T*)dskip, (float*)clsum, (uint32_t*)bar,
                         p, act);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

template <typename T, int V>
static int max_clusters(int cluster, int threads, int smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr[2];
  const cudaError_t e = configure<T, V>(&cfg, attr, cluster, cluster, threads, smem, 0);
  if (e != cudaSuccess) return (int)e;
  cfg.attrs = attr + 1;  // the occupancy query takes the cluster attribute alone
  cfg.numAttrs = 1;
  return (int)cudaOccupancyMaxActiveClusters(n, k6_backward<T, V>, &cfg);
}

// V elements per vector: 16 bytes, or 1 where a sample does not start on
// 16 bytes; every other combination is refused.
#define DISPATCH(dtype, V, CALL)                                         \
  do {                                                                   \
    if ((dtype) == DTYPE_BF16) {                                         \
      if ((V) == 8) return CALL(__nv_bfloat16, 8);                       \
      if ((V) == 1) return CALL(__nv_bfloat16, 1);                       \
    } else if ((dtype) == DTYPE_F32) {                                   \
      if ((V) == 4) return CALL(float, 4);                               \
      if ((V) == 1) return CALL(float, 1);                               \
    }                                                                    \
    return (int)cudaErrorInvalidValue;                                   \
  } while (0)

// x, dy, y, dx (and dskip for add_relu): (N, S, C) contiguous, 16-byte
// aligned, of dtype; y, the forward output, is read for add_relu only.
// stats: K1's float32 (N, C, 2) (mean, rstd). clsum: the cluster sums,
// N * (parts / cluster) * 2 * C floats (unused when parts is 1). bar: the
// barrier's word, zero before the first call, its low 31 bits left at zero
// by every call. The plan
// (kernels/instance_norm.py::backward_plan) gives V, the grid of `blocks`,
// `threads`, the Plan fields and `smem`. One launch on `stream`.
extern "C" int instance_norm_act_backward(const void* x, const void* dy, const void* y,
                                          const void* stats, void* dx, void* dskip, void* clsum,
                                          void* bar, int N, int S, int C, int V, int W, int q,
                                          int parts, int cluster, int span, int res,
                                          int st_rows, int blocks, int threads, int red_off,
                                          int part_off, int tot_off, int data_off, int smem,
                                          int act, int dtype, void* stream) {
  const Plan p{N, S, C, W, q, parts, cluster, span, res, st_rows,
               red_off, part_off, tot_off, data_off};
  const cudaStream_t st = (cudaStream_t)stream;
  if (threads > kMaxThreads || smem > kSmemMax || W > threads ||
      (parts > 1 && (parts % cluster != 0 || blocks != N * parts)))
    return (int)cudaErrorInvalidValue;
#define LAUNCH(T, VV) \
  launch<T, VV>(x, dy, y, stats, dx, dskip, clsum, bar, p, blocks, threads, smem, act, st)
  DISPATCH(dtype, V, LAUNCH);
#undef LAUNCH
}

// How many clusters of this plan the card holds at once (0: none).
extern "C" int instance_norm_act_backward_max_clusters(int V, int cluster, int threads, int smem,
                                                       int dtype, int* n) {
#define QUERY(T, VV) max_clusters<T, VV>(cluster, threads, smem, n)
  DISPATCH(dtype, V, QUERY);
#undef QUERY
}
