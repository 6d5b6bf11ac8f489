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
//
// Bound on the H100: bytes. Per element ~4 exp / log and ~30 flops on 4
// bytes read (forward) and 4 read + 4 written (backward); the least traffic
// for the pair is one read of out and one write of the gradient.
//
// Design: a grid of (blocks, B); a block of lanes x J threads walks a range
// of voxels, neighbouring threads on neighbouring joints of one voxel, so
// every step reads whole contiguous voxel rows. Forward: each thread sums
// (sp2 - t)^2 and t for its joint over its voxels; the block reduces its
// lanes in lane order into per-block partials; one block of k7_finalize
// sums the partials in block order, decides valid and sums the loss in
// (b, j) order: the loss does not depend on scheduling. The forward writes
// the double-softplus volume when asked (the trainer does not). Backward:
// the same walk, elementwise.
#include "common.cuh"

constexpr float kSigmaExp = 1.7f;

__device__ __forceinline__ float softplus(float v) { return fmaxf(v, 0.f) + log1pf(expf(-fabsf(v))); }
__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

// The per-axis tables d^2[a][r][j] and the labeled flags of sample b.
__device__ __forceinline__ void tables(const float* kp_vox, const float* kp_world, int b, int g,
                                       int J, float* tab, float* lab) {
  for (int i = threadIdx.x; i < 3 * g * J; i += blockDim.x) {
    const int a = i / (g * J), r = (i / J) % g, j = i % J;
    const float d = (kp_vox[((size_t)b * J + j) * 3 + a] - (float)r) / kSigmaExp;
    tab[i] = d * d;
  }
  for (int j = threadIdx.x; j < J; j += blockDim.x) {
    const float* w = kp_world + ((size_t)b * J + j) * 3;
    lab[j] = (w[0] != 0.f || w[1] != 0.f || w[2] != 0.f) ? 1.f : 0.f;
  }
}

__device__ __forceinline__ float target(const float* tab, const float* lab, int v, int g, int J,
                                        int j) {
  if (lab[j] == 0.f) return 0.f;
  const int x = v / (g * g), y = (v / g) % g, z = v % g;
  const float d2 = (tab[x * J + j] + tab[(g + y) * J + j]) + tab[(2 * g + z) * J + j];
  return 255.f * expf(-0.5f * d2);
}

__global__ void k7_forward(const float* __restrict__ out, const float* __restrict__ kp_vox,
                           const float* __restrict__ kp_world, float* __restrict__ vol,
                           float* __restrict__ part, int g, int J, int per_block) {
  extern __shared__ float sh[];
  const int lanes = blockDim.x / J;
  float* tab = sh;                    // 3 * g * J
  float* lab = tab + 3 * g * J;       // J
  float* red = lab + J;               // lanes * J * 2
  const int blk = blockIdx.x, b = blockIdx.y, nblk = gridDim.x;
  tables(kp_vox, kp_world, b, g, J, tab, lab);
  __syncthreads();
  const int lane = threadIdx.x / J, j = threadIdx.x % J;
  const int g3 = g * g * g;
  const int v0 = blk * per_block, v1 = min(g3, v0 + per_block);
  if (lane < lanes) {
    float sq = 0.f, ts = 0.f;
    for (int v = v0 + lane; v < v1; v += lanes) {
      const size_t i = ((size_t)b * g3 + v) * J + j;
      const float sp2 = softplus(softplus(out[i]));
      const float t = target(tab, lab, v, g, J, j);
      if (vol) vol[i] = sp2;
      const float d = sp2 - t;
      sq += d * d;
      ts += t;
    }
    red[(lane * J + j) * 2] = sq;
    red[(lane * J + j) * 2 + 1] = ts;
  }
  __syncthreads();
  for (int jj = threadIdx.x; jj < J; jj += blockDim.x) {
    float sq = 0.f, ts = 0.f;
    for (int l = 0; l < lanes; ++l) {
      sq += red[(l * J + jj) * 2];
      ts += red[(l * J + jj) * 2 + 1];
    }
    float* p = part + (((size_t)b * nblk + blk) * J + jj) * 2;
    p[0] = sq;
    p[1] = ts;
  }
}

// One block: per (b, j) the partials in block order; valid; the loss.
__global__ void k7_finalize(const float* __restrict__ part, const float* __restrict__ kp_world,
                            float* __restrict__ loss, float* __restrict__ valid, int B, int J,
                            int nblk, int g) {
  extern __shared__ float mse[];  // B * J
  const float g3 = (float)g * (float)g * (float)g;
  for (int i = threadIdx.x; i < B * J; i += blockDim.x) {
    const int b = i / J, j = i % J;
    float sq = 0.f, ts = 0.f;
    for (int k = 0; k < nblk; ++k) {
      const float* p = part + (((size_t)b * nblk + k) * J + j) * 2;
      sq += p[0];
      ts += p[1];
    }
    const float* w = kp_world + (size_t)i * 3;
    const bool labeled = w[0] != 0.f || w[1] != 0.f || w[2] != 0.f;
    const bool ok = labeled && ts > 1.f;
    valid[i] = ok ? 1.f : 0.f;
    mse[i] = ok ? sq / g3 : 0.f;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    float s = 0.f;
    for (int i = 0; i < B * J; ++i) s += mse[i];
    loss[0] = s;
  }
}

__global__ void k7_backward(const float* __restrict__ out, const float* __restrict__ kp_vox,
                            const float* __restrict__ kp_world, const float* __restrict__ valid,
                            const float* __restrict__ dloss, float* __restrict__ dout, int g,
                            int J, int per_block) {
  extern __shared__ float sh[];
  const int lanes = blockDim.x / J;
  float* tab = sh;
  float* lab = tab + 3 * g * J;
  const int blk = blockIdx.x, b = blockIdx.y;
  tables(kp_vox, kp_world, b, g, J, tab, lab);
  __syncthreads();
  const int lane = threadIdx.x / J, j = threadIdx.x % J;
  if (lane >= lanes) return;
  const int g3 = g * g * g;
  const float scale = valid[(size_t)b * J + j] != 0.f
                          ? dloss[0] * (2.f / ((float)g * (float)g * (float)g))
                          : 0.f;
  const int v0 = blk * per_block, v1 = min(g3, v0 + per_block);
  for (int v = v0 + lane; v < v1; v += lanes) {
    const size_t i = ((size_t)b * g3 + v) * J + j;
    if (scale == 0.f) {
      dout[i] = 0.f;
      continue;
    }
    const float o = out[i];
    const float sp1 = softplus(o);
    const float sp2 = softplus(sp1);
    const float t = target(tab, lab, v, g, J, j);
    dout[i] = scale * (sp2 - t) * sigmoid(sp1) * sigmoid(o);
  }
}

static size_t table_bytes(int g, int J) { return (size_t)(3 * g * J + J) * sizeof(float); }

// out (B, g, g, g, J), kp_vox, kp_world (B, J, 3): float32, contiguous.
// vol: the double-softplus volume, or null. part: B * nblk * J * 2 floats.
// loss: 1 float; valid: B * J floats (1 or 0), for the backward. Blocks of
// `threads` (a multiple of J), `per_block` voxels each, nblk = ceil(g^3 /
// per_block) of them per sample. Two launches on `stream`.
extern "C" int hybridnet_loss_forward(const void* out, const void* kp_vox, const void* kp_world,
                                      void* vol, void* part, void* loss, void* valid, int B,
                                      int g, int J, int threads, int per_block, int nblk,
                                      void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = table_bytes(g, J) + (size_t)(threads / J) * J * 2 * sizeof(float);
  if (J > threads || smem > 48 * 1024 || (size_t)B * J * sizeof(float) > 48 * 1024)
    return (int)cudaErrorInvalidValue;
  k7_forward<<<dim3(nblk, B), threads, smem, st>>>(
      (const float*)out, (const float*)kp_vox, (const float*)kp_world, (float*)vol,
      (float*)part, g, J, per_block);
  const int err = launch_status();
  if (err) return err;
  k7_finalize<<<1, 256, (size_t)B * J * sizeof(float), st>>>(
      (const float*)part, (const float*)kp_world, (float*)loss, (float*)valid, B, J, nblk, g);
  return launch_status();
}

// dloss: 1 float on the card (the incoming gradient of the loss); dout like
// out. One launch on `stream`.
extern "C" int hybridnet_loss_backward(const void* out, const void* kp_vox, const void* kp_world,
                                       const void* valid, const void* dloss, void* dout, int B,
                                       int g, int J, int threads, int per_block, int nblk,
                                       void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const size_t smem = table_bytes(g, J);
  if (J > threads || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  k7_backward<<<dim3(nblk, B), threads, smem, st>>>(
      (const float*)out, (const float*)kp_vox, (const float*)kp_world, (const float*)valid,
      (const float*)dloss, (float*)dout, g, J, per_block);
  return launch_status();
}
