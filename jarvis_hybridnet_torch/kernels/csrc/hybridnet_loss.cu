// K7 hybridnet_loss: HybridNet's training loss from the V2V output, with
// its 3D Gaussian target built on the fly, forward and backward.
//
// Replaces: the jnp ops the jitted 3D train step builds by hand
// (trainer3d.py:140-180): ops/heatmap.py::gaussian_heatmaps_3d_on_device
// (:113), the double softplus of models/hybridnet.py (:104, :116) and
// models/hybridnet.py::hybridnet_mse_loss (:118), and their VJP.
//
// From out (B, g, g, g, J) float32, kp_vox (B, J, 3) and kp_world (B, J, 3):
//   sp1 = softplus(out), sp2 = softplus(sp1)  (log1p(exp(-|v|)) + max(v, 0))
//   t   = 255 * exp(-0.5 * ((dx^2 + dy^2) + dz^2)), d = (kp_vox - r) / 1.7,
//         0 for a joint whose kp_world row is all zero (unlabeled)
//   mse[b, j] = sum_v (sp2 - t)^2 / g^3,  valid[b, j] = sum_v t > 1
//   loss = sum over valid (b, j) of mse[b, j]
//   dL/dout = dL * (2 / g^3) * (sp2 - t) * sigmoid(sp1) * sigmoid(out) on
//             valid (b, j), 0 elsewhere.
// The target is never stored: each axis's d^2 is a table in shared memory
// (3 * g * J floats), summed in the JAX package's order at every voxel.
// exp, log1p and the sigmoids' divisions take the fast intrinsics (__expf,
// __logf(1 + e), __fdividef): chip_smoke.py holds the loss and gradient to
// 1e-5 and the volume to 1e-6 of the plain version (they read ~2e-7, as
// with the precise functions), and they cut the backward by ~30%.
//
// Bound on the H100: bytes. Per element 3 exp, 2 log and ~30 flops on 4
// bytes read (forward) and 4 read + 4 written (backward); the least traffic
// is one read of out, and one write of the gradient.
//
// Design: one launch each, a grid of (sample, part) blocks, each a
// contiguous run of a sample's flat (voxel, joint) elements. A thread loads
// and stores 16 bytes (V = 4 elements) at a time: the elements are walked in
// groups of lcm(J, 4), W vectors each, so thread w of a lane always meets
// the same four joints, (4 w + k) mod J, and keeps its sums in registers;
// lanes are reduced in lane order. Forward: each block writes its partial
// sums of (sp2 - t)^2 and t per joint; the last block to finish (a ticket
// taken after __threadfence(), which that block sets back to 0) sums every
// block's partials in a fixed order (ordered_sums), decides valid and sums
// the loss in (b, j) order: the loss does not depend on scheduling, and one
// launch does it all.
// It writes the double-softplus volume when asked (the trainer does not).
// Backward: the same walk, elementwise.
#include "common.cuh"

constexpr float kSigmaExp = 1.7f;
constexpr int kUnroll = 2;  // groups a thread loads before it uses them

// The launch plan (kernels/hybridnet_loss.py::LossPlan), in its order.
struct Plan {
  int B, g, J;
  int W;         // V-element vectors in a group of lcm(J, V) elements
  int groups;    // groups in a sample
  int parts;     // blocks per sample
  int per_part;  // groups per block
  int tab_off, red_off, fin_off;  // byte offsets in shared memory
};

template <int V>
struct alignas(4 * V) Vec {
  float v[V];
};

// softplus(v) and sigmoid(v) from e = exp(-|v|)
__device__ __forceinline__ float softplus(float v, float e) {
  return fmaxf(v, 0.f) + __logf(1.f + e);
}
__device__ __forceinline__ float sigmoid(float v, float e) {
  return v >= 0.f ? __fdividef(1.f, 1.f + e) : __fdividef(e, 1.f + e);
}

// The per-axis tables d^2[a][r][j] and the labeled flags of sample b, in
// shared memory at tab (3 * g * J floats, then J flags, then sample b's
// kp_vox, 3 * J floats, brought in first so that the tables wait on one
// round of global loads). Ends with the block synchronized.
__device__ __forceinline__ void tables(const float* kp_vox, const float* kp_world, int b, int g,
                                       int J, float* tab) {
  float* lab = tab + 3 * g * J;
  float* kp = lab + J;
  for (int i = threadIdx.x; i < 3 * J; i += blockDim.x) kp[i] = kp_vox[(size_t)b * J * 3 + i];
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const float* w = kp_world + ((size_t)b * J + j) * 3;
    lab[j] = (w[0] != 0.f || w[1] != 0.f || w[2] != 0.f) ? 1.f : 0.f;
  }
  __syncthreads();
  // thread t: joint t % J of rows (a, r) = t / J, t / J + step, ... of the
  // 3 * g, (a, r) carried from one to the next (no division in the loop)
  const int step = max(1, (int)blockDim.x / J);
  if ((int)threadIdx.x < step * J) {
    const int j = threadIdx.x % J;
    int ar = threadIdx.x / J, a = ar / g, r = ar % g;
    for (; ar < 3 * g; ar += step) {
      const float d = (kp[j * 3 + a] - (float)r) / kSigmaExp;
      tab[ar * J + j] = d * d;
      for (r += step; r >= g; r -= g) ++a;
    }
  }
  __syncthreads();
}

// A thread's place in the walk: groups lane, lane + lanes, ... of its
// block's run; in each, the V elements at off = w * V of joints jj[k] and
// voxels group * (ge / J) + vo[k].
template <int V>
struct Walk {
  int lane, lanes, ge, off, g0, g1, g, J;
  int jj[V], vo[V];
  bool on;

  __device__ __forceinline__ Walk(const Plan& p, int part) {
    g = p.g;
    J = p.J;
    ge = p.W * V;
    lanes = (int)blockDim.x / p.W;
    lane = (int)threadIdx.x / p.W;
    off = ((int)threadIdx.x % p.W) * V;
    on = lane < lanes;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      jj[k] = (off + k) % J;
      vo[k] = (off + k) / J;
    }
    g0 = min(p.groups, part * p.per_part);
    g1 = min(p.groups, g0 + p.per_part);
  }

  // The target at the V elements of group gi: the group's first voxel is
  // split into (x, y, z) once, each element's by carrying its offset.
  __device__ __forceinline__ void targets(const float* tab, const float* lab, int gi,
                                          float* t) const {
    const int v0 = gi * (ge / J);
    const int x0 = v0 / (g * g), r = v0 - x0 * g * g, y0 = r / g, z0 = r - y0 * g;
#pragma unroll
    for (int k = 0; k < V; ++k) {
      int x = x0, y = y0, z = z0 + vo[k];
      for (; z >= g; z -= g) ++y;
      for (; y >= g; y -= g) ++x;
      const int j = jj[k];
      const float d2 = (tab[x * J + j] + tab[(g + y) * J + j]) + tab[(2 * g + z) * J + j];
      t[k] = lab[j] == 0.f ? 0.f : 255.f * __expf(-0.5f * d2);
    }
  }
};

// grid (parts * B): block b * parts + k takes groups [k * per_part, ...) of
// sample b. part: B * parts * 2 * J floats of block sums (squares, then
// targets, per joint); ticket: one word, 0 before the first call and left
// so by every call.
template <int V>
__global__ void __launch_bounds__(512, 2)
    k7_forward(const float* __restrict__ out, const float* __restrict__ kp_vox,
               const float* __restrict__ kp_world, float* __restrict__ vol,
               float* __restrict__ part, unsigned int* __restrict__ ticket,
               float* __restrict__ loss, float* __restrict__ valid, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem + p.tab_off);  // see tables()
  const float* lab = tab + 3 * p.g * p.J;
  float* red = reinterpret_cast<float*>(smem + p.red_off);  // 2 * lanes * ge
  // the block's sums (2 * J, then the ordered sums' slices), later the last
  // block's (2 * B * J, the slices, then B * J)
  float* fin = reinterpret_cast<float*>(smem + p.fin_off);
  __shared__ bool last;
  const int J = p.J, g = p.g;
  const int b = blockIdx.x / p.parts, k0 = blockIdx.x % p.parts;
  tables(kp_vox, kp_world, b, g, J, tab);
  const Walk<V> w(p, k0);
  const size_t base = (size_t)b * p.groups * w.ge;
  float sq[V], ts[V];
#pragma unroll
  for (int k = 0; k < V; ++k) sq[k] = ts[k] = 0.f;
  auto step = [&](const Vec<V>& o, int gi) {
    Vec<V> s2;
    float t[V];
    w.targets(tab, lab, gi, t);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = o.v[k];
      const float sp1 = softplus(v, __expf(-fabsf(v)));
      const float sp2 = softplus(sp1, __expf(-sp1));
      const float d = sp2 - t[k];
      sq[k] += d * d;
      ts[k] += t[k];
      s2.v[k] = sp2;
    }
    if (vol != nullptr) *reinterpret_cast<Vec<V>*>(vol + base + (size_t)gi * w.ge + w.off) = s2;
  };
  if (w.on) {
    int gi = w.g0 + w.lane;
    for (; gi + (kUnroll - 1) * w.lanes < w.g1; gi += kUnroll * w.lanes) {
      Vec<V> o[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        o[u] = *reinterpret_cast<const Vec<V>*>(out + base + (size_t)(gi + u * w.lanes) * w.ge +
                                                w.off);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) step(o[u], gi + u * w.lanes);
    }
    for (; gi < w.g1; gi += w.lanes)
      step(*reinterpret_cast<const Vec<V>*>(out + base + (size_t)gi * w.ge + w.off), gi);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      red[w.lane * w.ge + w.off + k] = sq[k];
      red[(w.lanes + w.lane) * w.ge + w.off + k] = ts[k];
    }
  }
  __syncthreads();
  // the block's sums per joint, squares then targets: the lanes in order,
  // and in each the group's voxels in order (red[which][lane * vpg + u][j])
  ordered_sums<false>(
      red, 2 * J, w.lanes * (w.ge / J), J, [&](int o) { return (o / J) * w.lanes * w.ge + o % J; },
      fin + 2 * J, fin);
  for (int i = threadIdx.x; i < 2 * J; i += blockDim.x)
    part[(size_t)blockIdx.x * 2 * J + i] = fin[i];
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();  // this block's sums before its ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) atomicExch(ticket, 0u);

  // the last block: per (b, j), the sample's blocks in order; valid; the
  // loss in (b, j) order
  const int pairs = p.B * J;
  ordered_sums<true>(
      part, 2 * pairs, p.parts, 2 * J,
      [&](int o) {
        const int pr = o % pairs;
        return ((pr / J) * p.parts * 2 + o / pairs) * J + pr % J;
      },
      fin + 2 * pairs, fin);
  float* mse = fin + 2 * pairs + max(2 * pairs, (int)blockDim.x);
  const float g3 = (float)g * (float)g * (float)g;
  for (int pr = threadIdx.x; pr < pairs; pr += blockDim.x) {
    const float a = fin[pr], c = fin[pairs + pr];
    const float* wd = kp_world + (size_t)pr * 3;
    const bool labeled = wd[0] != 0.f || wd[1] != 0.f || wd[2] != 0.f;
    const bool ok = labeled && c > 1.f;
    valid[pr] = ok ? 1.f : 0.f;
    mse[pr] = ok ? a / g3 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < pairs; ++i) s += mse[i];
    loss[0] = s;
  }
}

template <int V>
__global__ void __launch_bounds__(512, 2)
    k7_backward(const float* __restrict__ out, const float* __restrict__ kp_vox,
                const float* __restrict__ kp_world, const float* __restrict__ valid,
                const float* __restrict__ dloss, float* __restrict__ dout, const Plan p) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* tab = reinterpret_cast<float*>(smem + p.tab_off);
  const float* lab = tab + 3 * p.g * p.J;
  const int J = p.J, g = p.g;
  const int b = blockIdx.x / p.parts;
  tables(kp_vox, kp_world, b, g, J, tab);
  const Walk<V> w(p, blockIdx.x % p.parts);
  if (!w.on) return;
  const size_t base = (size_t)b * p.groups * w.ge;
  const float two = dloss[0] * (2.f / ((float)g * (float)g * (float)g));
  float scale[V];
#pragma unroll
  for (int k = 0; k < V; ++k) scale[k] = valid[(size_t)b * J + w.jj[k]] != 0.f ? two : 0.f;
  auto step = [&](const Vec<V>& o, int gi) {
    Vec<V> d;
    float t[V];
    w.targets(tab, lab, gi, t);
#pragma unroll
    for (int k = 0; k < V; ++k) {
      const float v = o.v[k];
      const float e0 = __expf(-fabsf(v));
      const float sp1 = softplus(v, e0);
      const float e1 = __expf(-sp1);  // sp1 > 0
      const float sp2 = softplus(sp1, e1);
      d.v[k] = scale[k] == 0.f ? 0.f
                               : scale[k] * (sp2 - t[k]) * sigmoid(sp1, e1) * sigmoid(v, e0);
    }
    *reinterpret_cast<Vec<V>*>(dout + base + (size_t)gi * w.ge + w.off) = d;
  };
  int gi = w.g0 + w.lane;
  for (; gi + (kUnroll - 1) * w.lanes < w.g1; gi += kUnroll * w.lanes) {
    Vec<V> o[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      o[u] = *reinterpret_cast<const Vec<V>*>(out + base + (size_t)(gi + u * w.lanes) * w.ge +
                                              w.off);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) step(o[u], gi + u * w.lanes);
  }
  for (; gi < w.g1; gi += w.lanes)
    step(*reinterpret_cast<const Vec<V>*>(out + base + (size_t)gi * w.ge + w.off), gi);
}

template <typename K>
static cudaError_t allow_smem(K kernel, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

#define PLAN_ARGS                                                                            \
  int B, int g, int J, int V, int W, int groups, int parts, int per_part, int threads,       \
      int tab_off, int red_off, int fin_off, int smem, void* stream
#define MAKE_PLAN const Plan p{B, g, J, W, groups, parts, per_part, tab_off, red_off, fin_off}

// out (B, g, g, g, J), kp_vox, kp_world (B, J, 3): float32, contiguous,
// 16-byte aligned. vol: the double-softplus volume, or null. part: B *
// parts * J * 2 floats; ticket: one word, 0 before the first call and left
// so. loss: 1 float; valid: B * J floats (1 or 0), for the backward. The
// plan (kernels/hybridnet_loss.py::loss_plan): V elements a vector (4, or 1
// where a sample's elements are not a multiple of 4), blocks of `threads`,
// B * parts blocks. One launch on `stream`.
extern "C" int hybridnet_loss_forward(const void* out, const void* kp_vox, const void* kp_world,
                                      void* vol, void* part, void* ticket, void* loss,
                                      void* valid, PLAN_ARGS) {
  MAKE_PLAN;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W > threads || threads > 512) return (int)cudaErrorInvalidValue;
#define FWD(VV)                                                                              \
  do {                                                                                       \
    cudaError_t e = allow_smem(k7_forward<VV>, smem);                                        \
    if (e != cudaSuccess) return (int)e;                                                     \
    k7_forward<VV><<<B * parts, threads, smem, st>>>(                                        \
        (const float*)out, (const float*)kp_vox, (const float*)kp_world, (float*)vol,        \
        (float*)part, (unsigned int*)ticket, (float*)loss, (float*)valid, p);                \
    return launch_status();                                                                  \
  } while (0)
  if (V == 4) FWD(4);
  if (V == 1) FWD(1);
#undef FWD
  return (int)cudaErrorInvalidValue;
}

// dloss: 1 float on the card (the incoming gradient of the loss); dout like
// out. One launch on `stream`.
extern "C" int hybridnet_loss_backward(const void* out, const void* kp_vox, const void* kp_world,
                                       const void* valid, const void* dloss, void* dout,
                                       PLAN_ARGS) {
  MAKE_PLAN;
  const cudaStream_t st = (cudaStream_t)stream;
  if (W > threads || threads > 512) return (int)cudaErrorInvalidValue;
#define BWD(VV)                                                                              \
  do {                                                                                       \
    cudaError_t e = allow_smem(k7_backward<VV>, smem);                                       \
    if (e != cudaSuccess) return (int)e;                                                     \
    k7_backward<VV><<<B * parts, threads, smem, st>>>(                                       \
        (const float*)out, (const float*)kp_vox, (const float*)kp_world,                     \
        (const float*)valid, (const float*)dloss, (float*)dout, p);                          \
    return launch_status();                                                                  \
  } while (0)
  if (V == 4) BWD(4);
  if (V == 1) BWD(1);
#undef BWD
  return (int)cudaErrorInvalidValue;
}
