// K8 heatmap2d_loss: EfficientTrack's training loss with its two Gaussian
// targets built on the fly, forward and backward.
//
// Replaces: the jnp ops the JAX package's 2D train step builds by hand
// (training/trainer2d.py:140-160): ops/heatmap.py::gaussian_heatmaps_on_device
// (:73) at the two scales and trainer2d.py::heatmap_loss (:31), and their VJP.
//
// From the heads out4 (B, J, H4, W4) and out2 (B, J, H2, W2), float32 or
// bf16 (bf16 training), and the keypoints kps (B, J, 2) at input resolution
// S, per scale s (out = H_s):
//   c = trunc(kp * out / S), skipped where kp == (0, 0) or c is off the map
//   ul = rint(c - (3 sigma + 1))  (half to even), window int(6 sigma + 3) wide
//   t = 255 * exp(-((y - ul_y - x0)^2 + (x - ul_x - x0)^2) / (2 sigma^2))
//       inside the window, 0 outside; x0 = 3 sigma + 1
//   mean_s = sum (out_s - t_s)^2 / numel_s;  loss = mean4 + mean2
//   dL/dout_s = dL * (2 / numel_s) * (out_s - t_s)
// The targets are never stored. The heads are read in the layout the
// network gives them, channels-last (J fastest) or contiguous NCHW; the
// gradients are written in the same layout and the heads' dtype. A bf16 head
// is widened to float32 as it is read, the loss stays float32, and each
// gradient element is rounded once to bf16 as it is written: JAX's
// `out - tgt` promotes the bf16 head to float32 and the promotion's
// transpose rounds the gradient (trainer2d.py:31-37), two passes this
// instantiation fuses into the read and the write. Built with --fmad=false, so each
// target is computed with the roundings of the plain version
// (kernels/heatmap2d_loss.py).
//
// Bound on the H100: bytes (forward: the heads read once; backward: read once
// and their gradients written once).
//
// Design: one launch each. A "plane" is an image of a channels-last head
// (H rows of W * J floats) or one (image, joint) of an NCHW head (H rows of
// W); each block takes a band of `rows` consecutive rows of one plane of one
// scale (blocks [0, blocks4) scale 4, then scale 2), so scale, image and
// band are uniform in a block and the band is one contiguous run. The block
// first puts its image's window corners (ul_x, ul_y per joint; +inf for a
// skipped keypoint, so no element is inside) in shared memory. A thread
// takes 16-byte vectors of the run, kUnroll loads in flight, and carries
// the (y, x, j) of its next element by adds (the step's quotient and
// remainder are computed once), so no element pays a division. A vector is
// 4 elements: 16 bytes of float32, 8 of bf16. Forward:
// each thread sums its squares in order, the block in a fixed shuffle
// tree; the last block to take the ticket (an acquire-release atomic, left
// at 0 for the next call) sums the blocks' partials of each scale in a fixed
// order: two calls give the same bits. Backward: the same walk, 16-byte
// stores.
#include "common.cuh"

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;
#define kInf __int_as_float(0x7f800000)

template <typename T>
struct Head {
  const T* p;
  T* g;
  int H, W, cl;       // cl: channels-last memory (J fastest), else NCHW
  int rows, bands;    // rows a band, bands a plane
  int blocks;         // planes * bands
  int vec;            // rows of whole 4-element vectors, aligned to one
  long long n;        // elements
  float scale, off;   // out / S and 3 sigma + 1
  float den;          // 2 sigma^2
  int ksize;          // int(6 sigma + 3)
};

template <typename T>
struct Args {
  Head<T> h[2];
  const float* kps;  // (B, J, 2)
  int B, J;
};

// A block's band: head s, image b, joints [j0, j0 + jr) along a row of
// len = W * jr elements, rows [y0, y1), the run starting at `at`.
struct Band {
  int s, b, j0, jr, len, y0, y1;
  long long at;
};

template <typename T>
__device__ __forceinline__ Band band_of(const Args<T>& a, int blk) {
  Band d;
  d.s = blk < a.h[0].blocks ? 0 : 1;
  const Head<T>& h = a.h[d.s];
  const int local = blk - (d.s ? a.h[0].blocks : 0);
  const int plane = local / h.bands, k = local - plane * h.bands;
  d.jr = h.cl ? a.J : 1;
  d.b = h.cl ? plane : plane / a.J;
  d.j0 = h.cl ? 0 : plane - d.b * a.J;
  d.len = h.W * d.jr;
  d.y0 = k * h.rows;
  d.y1 = min(h.H, d.y0 + h.rows);
  d.at = ((long long)plane * h.H + d.y0) * d.len;
  return d;
}

// The window corners of image d.b at scale d.s: ul[j] = (ul_x, ul_y), +inf
// where the keypoint is skipped. Ends with the block synchronized.
template <typename T>
__device__ __forceinline__ void corners(const Args<T>& a, const Band& d, float2* ul) {
  const Head<T>& h = a.h[d.s];
  for (int j = threadIdx.x; j < a.J; j += blockDim.x) {
    const int bj = d.b * a.J + j;
    const float kx = a.kps[bj * 2], ky = a.kps[bj * 2 + 1];
    const float cx = truncf(kx * h.scale), cy = truncf(ky * h.scale);
    const bool ok = !(kx == 0.f && ky == 0.f) && cx >= 0.f && cx < (float)h.W && cy >= 0.f &&
                    cy < (float)h.H;
    ul[j] = ok ? make_float2(rintf(cx - h.off), rintf(cy - h.off))
               : make_float2(kInf, kInf);
  }
  __syncthreads();
}

template <typename T>
__device__ __forceinline__ float target(const Head<T>& h, float2 ul, int x, int y) {
  const float kx = (float)x - ul.x, ky = (float)y - ul.y;
  const float kw = (float)h.ksize;
  if (!(kx >= 0.f && kx < kw && ky >= 0.f && ky < kw)) return 0.f;
  const float dy = ky - h.off, dx = kx - h.off;
  const float d2 = dy * dy + dx * dx;
  return 255.f * expf(-d2 / h.den);
}

// The (y, x, j) of a band's element: j < jr, x < W, carried by adds.
struct Pos {
  int y, x, j;
};

__device__ __forceinline__ void step1(Pos& p, int jr, int W) {
  if (++p.j == jr) {
    p.j = 0;
    if (++p.x == W) {
      p.x = 0;
      ++p.y;
    }
  }
}

// p advanced by a row offset of dr = dx * jr + dj (dr < len) and dy rows
__device__ __forceinline__ void stepn(Pos& p, int dy, int dx, int dj, int jr, int W) {
  p.j += dj;
  p.x += dx;
  p.y += dy;
  if (p.j >= jr) {
    p.j -= jr;
    ++p.x;
  }
  if (p.x >= W) {
    p.x -= W;
    ++p.y;
  }
}

// Four elements as float32 from one vector load, and back in one store.
__device__ __forceinline__ float4 load4(const float* p, long long q) {
  return reinterpret_cast<const float4*>(p)[q];
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p, long long q) {
  const uint2 u = reinterpret_cast<const uint2*>(p)[q];
  const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.x));
  const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&u.y));
  return make_float4(lo.x, lo.y, hi.x, hi.y);
}
__device__ __forceinline__ void store4(float* p, long long q, float4 v) {
  reinterpret_cast<float4*>(p)[q] = v;
}
__device__ __forceinline__ void store4(__nv_bfloat16* p, long long q, float4 v) {
  const __nv_bfloat162 lo = __floats2bfloat162_rn(v.x, v.y), hi = __floats2bfloat162_rn(v.z, v.w);
  uint2 u;
  u.x = *reinterpret_cast<const unsigned int*>(&lo);
  u.y = *reinterpret_cast<const unsigned int*>(&hi);
  reinterpret_cast<uint2*>(p)[q] = u;
}

// The walk of one block over its band, each thread's elements in
// increasing order: fv(offset in the head, 4 values, 4 targets) for every
// 4-element vector where the rows are whole vectors, else fs(offset, value,
// target) for every element; the values widened to float32.
template <typename T, typename FV, typename FS>
__device__ __forceinline__ void walk(const Args<T>& a, const Band& d, const float2* ul, FV fv,
                                     FS fs) {
  const Head<T>& h = a.h[d.s];
  const int nt = blockDim.x, tid = threadIdx.x, jr = d.jr, W = h.W;
  const int count = (d.y1 - d.y0) * d.len;
  const T* src = h.p + d.at;
  if (h.vec) {
    // thread t: vectors t, t + nt, ...; its position moves 4 * nt a vector
    const int nv = count / 4, r0 = 4 * tid, st = 4 * nt;
    Pos p{d.y0 + r0 / d.len, (r0 % d.len) / jr, (r0 % d.len) % jr};
    const int dy1 = st / d.len, dx1 = (st % d.len) / jr, dj1 = (st % d.len) % jr;
    for (int q0 = tid; q0 < nv; q0 += kUnroll * nt) {
      float4 v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + u * nt < nv) v[u] = load4(src, q0 + u * nt);
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (q0 + u * nt < nv) {
          Pos e = p;
          float4 t;
          t.x = target(h, ul[d.j0 + e.j], e.x, e.y);
          step1(e, jr, W);
          t.y = target(h, ul[d.j0 + e.j], e.x, e.y);
          step1(e, jr, W);
          t.z = target(h, ul[d.j0 + e.j], e.x, e.y);
          step1(e, jr, W);
          t.w = target(h, ul[d.j0 + e.j], e.x, e.y);
          fv(d.at + 4LL * (q0 + u * nt), v[u], t);
        }
        stepn(p, dy1, dx1, dj1, jr, W);
      }
    }
  } else {
    Pos p{d.y0 + tid / d.len, (tid % d.len) / jr, (tid % d.len) % jr};
    const int dy1 = nt / d.len, dx1 = (nt % d.len) / jr, dj1 = (nt % d.len) % jr;
    for (int i = tid; i < count; i += nt) {
      fs(d.at + i, to_f(src[i]), target(h, ul[d.j0 + p.j], p.x, p.y));
      stepn(p, dy1, dx1, dj1, jr, W);
    }
  }
}

// Block sum of v in a fixed tree; the result in thread 0. red: 32 floats.
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = 0.f;
  if (threadIdx.x < 32) {
    s = threadIdx.x < blockDim.x / 32 ? red[threadIdx.x] : 0.f;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) s += __shfl_xor_sync(0xffffffffu, s, off);
  }
  return s;
}

// part: one float a block; ticket: one word, 0 before the first call and
// left so; loss: 1 float; means: 2 floats (mean4, mean2).
template <typename T>
__global__ void __launch_bounds__(kMaxThreads)
    k8_forward(const Args<T> a, float* __restrict__ part, unsigned int* __restrict__ ticket,
               float* __restrict__ loss, float* __restrict__ means) {
  extern __shared__ __align__(16) float2 ul[];  // J
  __shared__ float red[2][32];
  __shared__ bool last;
  const Band d = band_of(a, blockIdx.x);
  corners(a, d, ul);
  float sq = 0.f;
  walk(
      a, d, ul,
      [&](long long, float4 p, float4 t) {
        const float e0 = p.x - t.x, e1 = p.y - t.y, e2 = p.z - t.z, e3 = p.w - t.w;
        sq += e0 * e0;
        sq += e1 * e1;
        sq += e2 * e2;
        sq += e3 * e3;
      },
      [&](long long, float p, float t) {
        const float e = p - t;
        sq += e * e;
      });
  const float s = block_sum(sq, red[0]);
  if (threadIdx.x == 0) {
    part[blockIdx.x] = s;
    // this block's sum before its ticket (release), the others' after (acquire)
    last = ticket_add(ticket) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  // the last block: thread t sums partials t, t + nt, ... of each scale in
  // order, then the block in its fixed tree
  const int b4 = a.h[0].blocks, nb = gridDim.x;
  float s4 = 0.f, s2 = 0.f;
#pragma unroll 4
  for (int i = threadIdx.x; i < nb; i += blockDim.x) {
    const float v = __ldcg(part + i);
    if (i < b4)
      s4 += v;
    else
      s2 += v;
  }
  s4 = block_sum(s4, red[0]);
  s2 = block_sum(s2, red[1]);
  if (threadIdx.x == 0) {
    atomicExch(ticket, 0u);
    const float m4 = s4 / (float)a.h[0].n, m2 = s2 / (float)a.h[1].n;
    means[0] = m4;
    means[1] = m2;
    loss[0] = m4 + m2;
  }
}

// dloss: 1 float on the card; writes a.h[s].g, each element rounded once to T.
template <typename T>
__global__ void __launch_bounds__(kMaxThreads) k8_backward(const Args<T> a,
                                                          const float* __restrict__ dloss) {
  extern __shared__ __align__(16) float2 ul[];  // J
  const Band d = band_of(a, blockIdx.x);
  corners(a, d, ul);
  const Head<T>& h = a.h[d.s];
  const float c = dloss[0] * (2.f / (float)h.n);
  walk(
      a, d, ul,
      [&](long long at, float4 p, float4 t) {
        store4(h.g + at, 0,
               make_float4(c * (p.x - t.x), c * (p.y - t.y), c * (p.z - t.z), c * (p.w - t.w)));
      },
      [&](long long at, float p, float t) { h.g[at] = from_f<T>(c * (p - t)); });
}

template <typename T>
static Head<T> make_head(const void* p, void* g, int B, int J, int H, int W, int cl, int rows,
                         float scale, float off, float den, int ks) {
  Head<T> h;
  h.p = static_cast<const T*>(p);
  h.g = static_cast<T*>(g);
  h.H = H;
  h.W = W;
  h.cl = cl;
  h.rows = rows;
  h.bands = (H + rows - 1) / rows;
  h.blocks = (cl ? B : B * J) * h.bands;
  const int len = cl ? W * J : W;
  const uintptr_t vb = 4 * sizeof(T);
  h.vec = len % 4 == 0 && (uintptr_t)p % vb == 0 && (g == nullptr || (uintptr_t)g % vb == 0);
  h.n = (long long)B * J * H * W;
  h.scale = scale;
  h.off = off;
  h.den = den;
  h.ksize = ks;
  return h;
}

template <typename T>
static bool make_args(Args<T>* a, const void* out4, const void* out2, void* d4, void* d2,
                      const void* kps, int B, int J, int H4, int W4, int cl4, int rows4, int H2,
                      int W2, int cl2, int rows2, float scale4, float off4, float den4, int ks4,
                      float scale2, float off2, float den2, int ks2, int threads) {
  if (B <= 0 || J <= 0 || rows4 <= 0 || rows2 <= 0 || threads <= 0 || threads % 32 ||
      threads > kMaxThreads || (long long)B * J * (H4 * W4 + H2 * W2) >= (1LL << 31))
    return false;
  a->h[0] = make_head<T>(out4, d4, B, J, H4, W4, cl4, rows4, scale4, off4, den4, ks4);
  a->h[1] = make_head<T>(out2, d2, B, J, H2, W2, cl2, rows2, scale2, off2, den2, ks2);
  a->kps = static_cast<const float*>(kps);
  a->B = B;
  a->J = J;
  return true;
}

#define HEAD_ARGS                                                                              \
  int B, int J, int H4, int W4, int cl4, int rows4, int H2, int W2, int cl2, int rows2,        \
      float scale4, float off4, float den4, int ks4, float scale2, float off2, float den2,      \
      int ks2, int dtype, int threads, void *stream
#define HEAD_PASS                                                                              \
  B, J, H4, W4, cl4, rows4, H2, W2, cl2, rows2, scale4, off4, den4, ks4, scale2, off2, den2, \
      ks2, threads

template <typename T>
static int forward(const void* out4, const void* out2, const void* kps, void* part, void* ticket,
                   void* loss, void* means, HEAD_ARGS) {
  Args<T> a;
  if (!make_args(&a, out4, out2, nullptr, nullptr, kps, HEAD_PASS))
    return (int)cudaErrorInvalidValue;
  k8_forward<T><<<a.h[0].blocks + a.h[1].blocks, threads, J * sizeof(float2),
                  (cudaStream_t)stream>>>(a, (float*)part, (unsigned int*)ticket, (float*)loss,
                                          (float*)means);
  return launch_status();
}

template <typename T>
static int backward(const void* out4, const void* out2, const void* kps, const void* dloss,
                    void* d4, void* d2, HEAD_ARGS) {
  Args<T> a;
  if (!make_args(&a, out4, out2, d4, d2, kps, HEAD_PASS)) return (int)cudaErrorInvalidValue;
  k8_backward<T><<<a.h[0].blocks + a.h[1].blocks, threads, J * sizeof(float2),
                   (cudaStream_t)stream>>>(a, (const float*)dloss);
  return launch_status();
}

#define HEAD_CALL                                                                              \
  B, J, H4, W4, cl4, rows4, H2, W2, cl2, rows2, scale4, off4, den4, ks4, scale2, off2, den2, \
      ks2, dtype, threads, stream

// out4, out2: the heads (dtype 0 float32, 1 bf16; channels-last or
// contiguous NCHW as cl4 / cl2 say); kps (B, J, 2) float32; rows4 / rows2:
// rows a band (the plan of kernels/heatmap2d_loss.py); part: one float a
// block; ticket: one word, 0 before the first call and left so; loss: 1
// float; means: 2 floats. One launch on `stream`.
extern "C" int heatmap2d_loss_forward(const void* out4, const void* out2, const void* kps,
                                      void* part, void* ticket, void* loss, void* means,
                                      HEAD_ARGS) {
  if (dtype == 0)
    return forward<float>(out4, out2, kps, part, ticket, loss, means, HEAD_CALL);
  if (dtype == 1)
    return forward<__nv_bfloat16>(out4, out2, kps, part, ticket, loss, means, HEAD_CALL);
  return (int)cudaErrorInvalidValue;
}

// dloss: 1 float on the card; d4, d2: the gradients, in the heads' layouts
// and dtype. One launch on `stream`.
extern "C" int heatmap2d_loss_backward(const void* out4, const void* out2, const void* kps,
                                       const void* dloss, void* d4, void* d2, HEAD_ARGS) {
  if (dtype == 0) return backward<float>(out4, out2, kps, dloss, d4, d2, HEAD_CALL);
  if (dtype == 1) return backward<__nv_bfloat16>(out4, out2, kps, dloss, d4, d2, HEAD_CALL);
  return (int)cudaErrorInvalidValue;
}
