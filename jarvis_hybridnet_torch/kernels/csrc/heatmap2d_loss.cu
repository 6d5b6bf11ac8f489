// K8 heatmap2d_loss: EfficientTrack's training loss with its two Gaussian
// targets built on the fly, forward and backward.
//
// Replaces: the jnp ops the JAX package's 2D train step builds by hand
// (training/trainer2d.py:140-160): ops/heatmap.py::gaussian_heatmaps_on_device
// (:73) at the two scales and trainer2d.py::heatmap_loss (:31), and their VJP.
//
// From the heads out4 (B, J, H4, W4) and out2 (B, J, H2, W2) float32 and the
// keypoints kps (B, J, 2) at input resolution S, per scale s (out = H_s):
//   c = trunc(kp * out / S), skipped where kp == (0, 0) or c is off the map
//   ul = rint(c - (3 sigma + 1))  (half to even), window int(6 sigma + 3) wide
//   t = 255 * exp(-((y - ul_y - x0)^2 + (x - ul_x - x0)^2) / (2 sigma^2))
//       inside the window, 0 outside; x0 = 3 sigma + 1
//   mean_s = sum (out_s - t_s)^2 / numel_s;  loss = mean4 + mean2
//   dL/dout_s = dL * (2 / numel_s) * (out_s - t_s)
// The targets are never stored: each block computes every (b, j)'s centre,
// window corner and flag in shared memory first. The heads are read in the
// layout the network gives them, channels-last (J fastest) or contiguous
// NCHW, through their strides; the gradients are written in the same layout.
// Built with --fmad=false, so each target is computed with the roundings of
// the plain version (kernels/heatmap2d_loss.py).
//
// Bound on the H100: bytes (forward: the heads read once; backward: read once
// and their gradients written once).
//
// Design: one launch each. The two heads are one index space (out4's
// elements, then out2's), cut into equal runs, one per block. Forward: each
// thread sums its elements' squares per scale in order, the block sums its
// threads in a fixed tree, writes its two partials, and the last block to
// take the ticket (left at 0 for the next call) sums the blocks' partials in
// block order (ordered_sums): two calls give the same bits. Backward: the
// same walk, elementwise.
#include "common.cuh"

constexpr int kThreads = 512;

struct Head {
  const float* p;
  float* g;
  int H, W, cl;        // cl: channels-last memory (J fastest), else NCHW
  long long n;         // elements
  float scale, off;    // out / S and 3 sigma + 1
  float den;           // 2 sigma^2
  int ksize;           // int(6 sigma + 3)
};

struct Args {
  Head h[2];
  const float* kps;  // (B, J, 2)
  int B, J;
};

// per (b, j) of each scale: flag, ul_x, ul_y at tab[(s * 3 + k) * B * J + bj]
__device__ __forceinline__ void corners(const Args& a, float* tab) {
  const int pairs = a.B * a.J;
  for (int i = threadIdx.x; i < 2 * pairs; i += blockDim.x) {
    const int s = i / pairs, bj = i - s * pairs;
    const Head& h = a.h[s];
    const float kx = a.kps[bj * 2], ky = a.kps[bj * 2 + 1];
    const float cx = truncf(kx * h.scale), cy = truncf(ky * h.scale);
    const bool ok = !(kx == 0.f && ky == 0.f) && cx >= 0.f && cx < (float)h.W && cy >= 0.f &&
                    cy < (float)h.H;
    tab[(s * 3 + 0) * pairs + bj] = ok ? 1.f : 0.f;
    tab[(s * 3 + 1) * pairs + bj] = rintf(cx - h.off);
    tab[(s * 3 + 2) * pairs + bj] = rintf(cy - h.off);
  }
  __syncthreads();
}

// The target of element e of head s (e < 2^31: the wrapper checks), whose
// value lies at offset e in both layouts (each is dense in the order walked).
__device__ __forceinline__ float target(const Args& a, const float* tab, int s, int e) {
  const Head& h = a.h[s];
  const int J = a.J;
  int b, j, y, x;
  if (h.cl) {
    j = e % J;
    int r = e / J;
    x = r % h.W;
    r /= h.W;
    y = r % h.H;
    b = r / h.H;
  } else {
    x = e % h.W;
    int r = e / h.W;
    y = r % h.H;
    r /= h.H;
    j = r % J;
    b = r / J;
  }
  const int pairs = a.B * J, bj = b * J + j;
  if (tab[(s * 3 + 0) * pairs + bj] == 0.f) return 0.f;
  const float kx = (float)x - tab[(s * 3 + 1) * pairs + bj];
  const float ky = (float)y - tab[(s * 3 + 2) * pairs + bj];
  const float kw = (float)h.ksize;
  if (!(kx >= 0.f && kx < kw && ky >= 0.f && ky < kw)) return 0.f;
  const float dy = ky - h.off, dx = kx - h.off;
  const float d2 = dy * dy + dx * dx;
  return 255.f * expf(-d2 / h.den);
}

// The run [first, end) of the joint index space of block `blk` of `blocks`.
__device__ __forceinline__ void run(const Args& a, int blk, int blocks, long long* first,
                                    long long* end) {
  const long long total = a.h[0].n + a.h[1].n;
  const long long per = (total + blocks - 1) / blocks;
  *first = min(total, (long long)blk * per);
  *end = min(total, *first + per);
}

// Block sum of v in a fixed tree; the result in thread 0. red: blockDim.x floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
  red[threadIdx.x] = v;
  __syncthreads();
  for (int k = blockDim.x / 2; k > 0; k >>= 1) {
    if ((int)threadIdx.x < k) red[threadIdx.x] += red[threadIdx.x + k];
    __syncthreads();
  }
  const float s = red[0];
  __syncthreads();
  return s;
}

// part: gridDim.x * 2 floats; ticket: one word, 0 before the first call and
// left so; loss: 1 float; means: 2 floats (mean4, mean2).
__global__ void __launch_bounds__(kThreads)
    k8_forward(const Args a, float* __restrict__ part, unsigned int* __restrict__ ticket,
               float* __restrict__ loss, float* __restrict__ means) {
  extern __shared__ __align__(16) float sm[];
  float* tab = sm;                         // 6 * B * J
  float* red = sm + 6 * a.B * a.J;         // blockDim.x
  float* fin = red + blockDim.x;           // 2 + max(blockDim.x, 2) for ordered_sums
  __shared__ bool last;
  corners(a, tab);
  long long first, end;
  run(a, blockIdx.x, gridDim.x, &first, &end);
  float sq[2] = {0.f, 0.f};
  for (long long i = first + threadIdx.x; i < end; i += blockDim.x) {
    const int s = i < a.h[0].n ? 0 : 1;
    const int e = (int)(s == 0 ? i : i - a.h[0].n);
    const float d = a.h[s].p[e] - target(a, tab, s, e);
    sq[s] += d * d;
  }
  const float s4 = block_sum(sq[0], red);
  const float s2 = block_sum(sq[1], red);
  if (threadIdx.x == 0) {
    part[blockIdx.x * 2] = s4;
    part[blockIdx.x * 2 + 1] = s2;
    __threadfence();  // this block's sums before its ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (threadIdx.x == 0) atomicExch(ticket, 0u);
  // the last block: each scale's partials in block order
  ordered_sums<true>(part, 2, gridDim.x, 2, [](int o) { return o; }, fin + 2, fin);
  if (threadIdx.x == 0) {
    const float m4 = fin[0] / (float)a.h[0].n, m2 = fin[1] / (float)a.h[1].n;
    means[0] = m4;
    means[1] = m2;
    loss[0] = m4 + m2;
  }
}

// dloss: 1 float on the card; writes a.h[s].g.
__global__ void __launch_bounds__(kThreads)
    k8_backward(const Args a, const float* __restrict__ dloss) {
  extern __shared__ __align__(16) float sm[];
  corners(a, sm);
  long long first, end;
  run(a, blockIdx.x, gridDim.x, &first, &end);
  const float g = dloss[0];
  const float c4 = g * (2.f / (float)a.h[0].n), c2 = g * (2.f / (float)a.h[1].n);
  for (long long i = first + threadIdx.x; i < end; i += blockDim.x) {
    const int s = i < a.h[0].n ? 0 : 1;
    const int e = (int)(s == 0 ? i : i - a.h[0].n);
    a.h[s].g[e] = (s == 0 ? c4 : c2) * (a.h[s].p[e] - target(a, sm, s, e));
  }
}

static Args make_args(const void* out4, const void* out2, void* d4, void* d2, const void* kps,
                      int B, int J, int H4, int W4, int cl4, int H2, int W2, int cl2,
                      float scale4, float off4, float den4, int ks4, float scale2, float off2,
                      float den2, int ks2) {
  Args a;
  a.h[0] = Head{(const float*)out4, (float*)d4, H4, W4, cl4, (long long)B * J * H4 * W4,
                scale4, off4, den4, ks4};
  a.h[1] = Head{(const float*)out2, (float*)d2, H2, W2, cl2, (long long)B * J * H2 * W2,
                scale2, off2, den2, ks2};
  a.kps = (const float*)kps;
  a.B = B;
  a.J = J;
  return a;
}

#define HEAD_ARGS                                                                          \
  int B, int J, int H4, int W4, int cl4, int H2, int W2, int cl2, float scale4, float off4, \
      float den4, int ks4, float scale2, float off2, float den2, int ks2, int blocks,       \
      void *stream
#define HEAD_PASS B, J, H4, W4, cl4, H2, W2, cl2, scale4, off4, den4, ks4, scale2, off2, den2, ks2

extern "C" int heatmap2d_loss_smem_bytes(int B, int J) {
  return (6 * B * J + kThreads + 2 + kThreads) * 4;
}

// out4, out2: the heads (float32, channels-last or contiguous NCHW as cl4 /
// cl2 say); kps (B, J, 2) float32; part: blocks * 2 floats; ticket: one
// word, 0 before the first call and left so; loss: 1 float; means: 2
// floats. One launch of `blocks` blocks on `stream`.
extern "C" int heatmap2d_loss_forward(const void* out4, const void* out2, const void* kps,
                                      void* part, void* ticket, void* loss, void* means,
                                      HEAD_ARGS) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(out4, out2, nullptr, nullptr, kps, HEAD_PASS);
  const int smem = heatmap2d_loss_smem_bytes(B, J);
  if (smem > 48 * 1024) {
    cudaError_t e =
        cudaFuncSetAttribute(k8_forward, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  k8_forward<<<blocks, kThreads, smem, (cudaStream_t)stream>>>(
      a, (float*)part, (unsigned int*)ticket, (float*)loss, (float*)means);
  return launch_status();
}

// dloss: 1 float on the card; d4, d2: the gradients, in the heads' layouts.
// One launch on `stream`.
extern "C" int heatmap2d_loss_backward(const void* out4, const void* out2, const void* kps,
                                       const void* dloss, void* d4, void* d2, HEAD_ARGS) {
  if (blocks <= 0) return (int)cudaErrorInvalidValue;
  const Args a = make_args(out4, out2, d4, d2, kps, HEAD_PASS);
  k8_backward<<<blocks, kThreads, 6 * B * J * 4, (cudaStream_t)stream>>>(a,
                                                                         (const float*)dloss);
  return launch_status();
}
