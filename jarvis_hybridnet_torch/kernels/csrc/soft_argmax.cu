// K3 soft_argmax: the HybridNet epilogue, one launch per call.
//
// Replaces: models/hybridnet.py:95-114 — softplus of the V2V output in
// float32, the normalizer and the three coordinate-weighted sums over the
// g^3 grid, world mm = pts * spacing * 2 - cube / 2 + center3d, the
// confidence min(max, 255) / 255 and, when asked, the double-softplus volume
// (heatmap_final, :114).
//
// Bound on the H100: bytes. One read of the (B, g, g, g, J) volume, and with
// the volume output one float32 write of the same element count; the other
// outputs are B * J * 4 floats. softplus costs an exp and a log1p per
// element, still under the card's flops-per-byte balance.
//
// Design: a thread block cluster per frameset (grid (cluster, B)). Rank r
// streams a contiguous span of the frameset's flat (g^3 * J) array: voxels
// [r * span, (r + 1) * span), span a multiple of 8 voxels, so every tile
// starts on 16 bytes (8 J-rows of bf16 are J 16-byte vectors). Tiles of
// `tile` voxels (a multiple of 8) come into a ring of kStages shared-memory
// buffers by 16-byte cp.async copies, kStages - 1 tiles ahead of the one in
// use. The epilogue is bound by instructions per element more than by
// bytes, so a tile is split into one run of `run` consecutive voxels per
// lane, and thread t takes joint t % J of lane t / J's run. Along a run only
// z changes until a row ends: the thread sums softplus and softplus * z over
// the row and adds them, with x and y times the row's sum, to its totals
// where the row or the run ends. Its coordinates advance by carries, with
// no division per element. Without the volume output softplus takes the
// fast intrinsics (__expf, __logf); with it, the accurate expf and log1pf,
// so the volume matches the plain version to float32 ulps. The file is
// built with -ftz=true, which drops the denormal scaling around each MUFU
// operation (an exp(-|x|) below 2^-126 becomes 0). 5 J threads reduce the
// lanes, one (sum, joint) each, in lane order in shared memory; after
// cluster.sync() 5 J threads of rank 0 read every rank's partials (four
// sums and the max) through distributed shared memory and add them in rank
// order, and J of them write the points and confidences, so the result is
// deterministic with no atomics and no global scratch. A second
// cluster.sync() keeps each rank's shared memory alive until rank 0 has
// read it. Needs sm_90 (clusters, distributed shared memory) and
// cudaLaunchKernelEx.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

constexpr int kStages = 4;        // ring buffers of tiles in shared memory
constexpr int kMaxThreads = 1024;
constexpr int kSmemMax = 232448;  // dynamic shared memory a block may use
#define NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float softplus_f(float x) {
  // jax.nn.softplus == logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

// softplus by the fast intrinsics (CUDA's documented bounds: __expf within
// 2 + |1.173 x| ulps, __logf within 2^-21.41 absolute on [1, 2])
__device__ __forceinline__ float softplus_fast(float x) {
  return fmaxf(x, 0.f) + __logf(1.f + __expf(-fabsf(x)));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(
                   (uint32_t)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

// grid (cluster, B), cluster (cluster, 1, 1). span: voxels per rank; run:
// voxels per lane and tile; tile = (blockDim.x / J) * run voxels per ring
// buffer (span and tile multiples of 8). aligned: every frameset starts on
// 16 bytes, so tiles take 16-byte copies (else element copies). kVolume:
// heat is float32 (B, g, g, g, J) for softplus(softplus(x)).
template <typename T, bool kVolume>
__global__ void __launch_bounds__(kMaxThreads)
    sa_cluster(const T* __restrict__ vol, const int* __restrict__ center3d,
               float* __restrict__ points, float* __restrict__ conf, float* __restrict__ heat,
               int g, int J, int span, int run, int aligned, float spacing, float cube) {
  extern __shared__ __align__(128) unsigned char smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks();
  const int rank = (int)cluster.block_rank();
  const int nthr = (int)blockDim.x, tid = (int)threadIdx.x;
  const int lanes = nthr / J, jj = tid % J, lane = tid / J;
  const int tile = lanes * run;
  T* ring = reinterpret_cast<T*>(smem);                                    // [kStages][tile * J]
  float* red = reinterpret_cast<float*>(smem + (size_t)kStages * tile * J * sizeof(T));  // [5][nthr]
  float* part = red + 5 * nthr;  // [5][J], read by rank 0

  const int b = blockIdx.y, nvox = g * g * g;
  const int lo = min(nvox, rank * span), hi = min(nvox, lo + span);
  const int ntiles = (hi - lo + tile - 1) / tile;
  const T* vb = vol + (size_t)b * nvox * J;
  constexpr int kVec = 16 / sizeof(T);

  // tile t of the span into ring buffer t % kStages; always one commit group
  auto fetch = [&](int t) {
    if (t < ntiles) {
      const int a = lo + t * tile;
      const int n = (min(hi, a + tile) - a) * J;
      T* dst = ring + (size_t)(t % kStages) * tile * J;
      const T* src = vb + (size_t)a * J;
      const int nv = aligned ? n / kVec : 0;
      for (int i = tid; i < nv; i += nthr) cp_async16(dst + i * kVec, src + i * kVec);
      for (int i = nv * kVec + tid; i < n; i += nthr) dst[i] = src[i];
    }
    asm volatile("cp.async.commit_group;" ::: "memory");
  };

  const bool on = lane < lanes;
  const float gf = (float)g;
  // the first voxel of the thread's run, advanced by a tile (in base g:
  // tile = tx * g^2 + ty * g + tz) after each tile
  int v0 = lo + lane * run;
  int x0 = v0 / (g * g), y0 = v0 / g % g, z0 = v0 % g;
  const int tz = tile % g, ty = tile / g % g, tx = tile / (g * g);
  float n = 0.f, sx = 0.f, sy = 0.f, sz = 0.f, mx = NEG_INF;
  for (int s = 0; s < kStages - 1; ++s) fetch(s);
  for (int t = 0; t < ntiles; ++t) {
    fetch(t + kStages - 1);
    asm volatile("cp.async.wait_group %0;" ::"n"(kStages - 1) : "memory");
    __syncthreads();
    if (on) {
      const int cnt = min(run, min(hi, lo + (t + 1) * tile) - v0);
      const T* tb = ring + ((size_t)(t % kStages) * tile + lane * run) * J + jj;
      float* hp = kVolume ? heat + ((size_t)b * nvox + v0) * J + jj : nullptr;
      // the row's sums of softplus and softplus * z, added at the row's end
      float nr = 0.f, szr = 0.f, zf = (float)z0;
      int x = x0, y = y0;
      for (int k = 0; k < cnt; ++k) {
        const float in = to_f(tb[k * J]);
        const float sp = kVolume ? softplus_f(in) : softplus_fast(in);
        nr += sp;
        szr = fmaf(sp, zf, szr);
        mx = fmaxf(mx, sp);
        if (kVolume) hp[(size_t)k * J] = softplus_f(sp);
        zf += 1.f;
        if (zf == gf) {
          n += nr;
          sz += szr;
          sy = fmaf((float)y, nr, sy);
          sx = fmaf((float)x, nr, sx);
          nr = szr = zf = 0.f;
          if (++y == g) {
            y = 0;
            ++x;
          }
        }
      }
      n += nr;
      sz += szr;
      sy = fmaf((float)y, nr, sy);
      sx = fmaf((float)x, nr, sx);
    }
    v0 += tile;
    z0 += tz;
    const int cz = z0 >= g;
    z0 -= cz * g;
    y0 += ty + cz;
    const int cy = y0 >= g;
    y0 -= cy * g;
    x0 += tx + cy;
    __syncthreads();
  }

  // the lanes' partials, reduced in lane order: thread (q, j) of 5 J adds
  // sum q of joint j over the lanes (q = 4: the max)
  red[0 * nthr + tid] = n;
  red[1 * nthr + tid] = sx;
  red[2 * nthr + tid] = sy;
  red[3 * nthr + tid] = sz;
  red[4 * nthr + tid] = mx;
  __syncthreads();
  const int q = tid / J;
  if (tid < 5 * J) {
    const float* rq = red + q * nthr + jj;
    float acc = q < 4 ? 0.f : NEG_INF;
#pragma unroll 8
    for (int l = 0; l < lanes; ++l) acc = q < 4 ? acc + rq[l * J] : fmaxf(acc, rq[l * J]);
    part[tid] = acc;  // part[q * J + j]
  }

  // rank 0 adds the ranks' partials in rank order through DSMEM
  cluster.sync();
  if (rank == 0) {
    if (tid < 5 * J) {
      float v[16];
#pragma unroll
      for (int r = 0; r < 16; ++r) v[r] = r < cs ? cluster.map_shared_rank(part, r)[tid] : 0.f;
      float acc = q < 4 ? 0.f : NEG_INF;
#pragma unroll
      for (int r = 0; r < 16; ++r)
        if (r < cs) acc = q < 4 ? acc + v[r] : fmaxf(acc, v[r]);
      red[tid] = acc;  // the lanes' partials are no longer needed
    }
    __syncthreads();
    if (tid < J) {
      const size_t o = (size_t)b * J + tid;
#pragma unroll
      for (int d = 0; d < 3; ++d)
        points[o * 3 + d] = red[(1 + d) * J + tid] / red[tid] * spacing * 2.f - cube / 2.f +
                            (float)center3d[b * 3 + d];
      conf[o] = fminf(red[4 * J + tid], 255.f) / 255.f;
    }
  }
  cluster.sync();  // no rank's partials are read after this
}

template <typename T, bool kVolume>
static cudaError_t prepare(cudaLaunchConfig_t* cfg, cudaLaunchAttribute* attr, int cluster,
                           int threads, int B, int smem, cudaStream_t st) {
  static bool ready = false;  // function attributes, set once per instantiation
  if (!ready) {
    cudaError_t e = cudaFuncSetAttribute(sa_cluster<T, kVolume>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return e;
    // clusters of 9-16 are measured by kernel_sweep.py
    e = cudaFuncSetAttribute(sa_cluster<T, kVolume>,
                             cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return e;
    ready = true;
  }
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3(cluster, B, 1);
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

template <typename T, bool kVolume>
static int launch(const void* vol, const void* center3d, void* points, void* conf, void* heat,
                  int B, int g, int J, int cluster, int threads, int span, int run, int smem,
                  int aligned, float spacing, float cube, cudaStream_t st) {
  if (threads > kMaxThreads || J > threads || smem > kSmemMax || (threads / J * run) % 8 ||
      span % 8 || cluster > 16)
    return (int)cudaErrorInvalidValue;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = prepare<T, kVolume>(&cfg, &attr, cluster, threads, B, smem, st);
  if (e != cudaSuccess) return (int)e;
  e = cudaLaunchKernelEx(&cfg, sa_cluster<T, kVolume>, (const T*)vol, (const int*)center3d,
                         (float*)points, (float*)conf, (float*)heat, g, J, span, run, aligned,
                         spacing, cube);
  if (e != cudaSuccess) return (int)e;
  return launch_status();
}

// vol: (B, g, g, g, J) contiguous; center3d (B, 3) int32; points (B, J, 3)
// and conf (B, J) float32; heat: null or float32 (B, g, g, g, J). The plan
// (cluster, threads, span, run, smem) comes from
// kernels/soft_argmax.py::launch_plan.
extern "C" int soft_argmax(const void* vol, const void* center3d, void* points, void* conf,
                           void* heat, int B, int g, int J, int cluster, int threads, int span,
                           int run, int smem, int aligned, float spacing, float cube, int dtype,
                           void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(T, V)                                                                           \
  launch<T, V>(vol, center3d, points, conf, heat, B, g, J, cluster, threads, span, run, smem, \
               aligned, spacing, cube, st)
  if (dtype == DTYPE_BF16) return heat ? LAUNCH(__nv_bfloat16, true) : LAUNCH(__nv_bfloat16, false);
  return heat ? LAUNCH(float, true) : LAUNCH(float, false);
#undef LAUNCH
}

template <typename T>
static int max_clusters(int cluster, int threads, int smem, int* n) {
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  const cudaError_t e = prepare<T, false>(&cfg, &attr, cluster, threads, 1, smem, 0);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveClusters(n, sa_cluster<T, false>, &cfg);
}

// How many clusters of this plan the card can hold at once (0: none).
extern "C" int soft_argmax_max_clusters(int cluster, int threads, int smem, int dtype, int* n) {
  return dtype == DTYPE_BF16 ? max_clusters<__nv_bfloat16>(cluster, threads, smem, n)
                             : max_clusters<float>(cluster, threads, smem, n);
}
