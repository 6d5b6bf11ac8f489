// K10 argmax2d: per (image, channel), the spatial maximum of a heatmap and the
// first row-major index that attains it.
//
// Replaces: ops/heatmap.py::argmax_2d (:15) of the JAX package (jnp.argmax
// and jnp.max over the flattened H * W of (N, H, W, C) heatmaps), which the
// 2D train and eval steps (trainer2d.py:178, :197) and every predictor
// (predictor3d.py:70, predictor2d.py:57, :79 of the port) call.
//
// Out: x = m % W, y = m / W (int32) and the maximum (float32; exact for a
// bfloat16 input). NaN counts as larger than any number, so a NaN and its
// first index win, as with jnp.argmax and torch.max.
//
// Bound on the H100: bytes (each heatmap element read once; 12 bytes written
// per (image, channel)).
//
// Design: the heads are read through their strides (the callers pass a
// permuted view of an NCHW tensor, channels-last or contiguous: no copy is
// made), in one of two launches.
// - Channels-last heads of C > 1 channels (a pixel's C values contiguous):
//   a block per (image, tile of pixels) of C * L threads, thread t holding
//   channel t % C of every L-th pixel, so each round of the block reads C *
//   L consecutive elements. Each block writes every channel's (maximum,
//   first index) over its tile; the last block to take the ticket (left at
//   0 for the next call) merges the tiles of each (image, channel), a few
//   threads each.
// - Otherwise a block per (image, channel) walks the channel's H * W
//   elements: 16 bytes a load where its rows are contiguous and aligned (x
//   stride 1: every single-channel head), vector q holding elements q * V ...
//   q * V + V - 1; else one element a load, the (x, y) of the next element
//   carried instead of divided.
// A thread takes its elements in increasing index, so its first maximum is
// kept by a strict comparison, with kUnroll loads in flight; (value, index)
// pairs are then merged with the lowest index winning every tie (a total
// order, so the merge order does not change the result).
#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kUnroll = 4;
constexpr int kNone = 0x7fffffff;

// a beats b: a larger value (NaN above all), or an equal one at a lower index
__device__ __forceinline__ bool beats(float av, int ai, float bv, int bi) {
  if (ai == kNone) return false;
  if (bi == kNone) return true;
  const bool an = isnan(av), bn = isnan(bv);
  if (an != bn) return an;
  if (!an && av != bv) return av > bv;
  return ai < bi;
}

// a later element (higher index) replaces the running best only when larger
__device__ __forceinline__ void take(float v, int m, float& best, int& bi) {
  if (bi == kNone || (isnan(v) ? !isnan(best) : v > best)) {
    best = v;
    bi = m;
  }
}

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

template <typename T, bool kVec>
__global__ void __launch_bounds__(kThreads)
    k10_argmax(const T* __restrict__ hm, int C, int H, int W, long long sn, long long sy,
               long long sx, long long sc, int* __restrict__ xy, float* __restrict__ maxv) {
  const int n = blockIdx.x / C, c = blockIdx.x - n * C;
  const T* base = hm + n * sn + c * sc;
  const int HW = H * W, tid = threadIdx.x, T_ = blockDim.x;
  float best = 0.f;
  int bi = kNone;
  if constexpr (kVec) {
    constexpr int V = 16 / sizeof(T);
    const int vw = W / V, nv = HW / V;  // vectors a row, in the channel
    for (int q0 = tid; q0 < nv; q0 += kUnroll * T_) {
      Vec16<T> r[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * T_;
        if (q < nv) {
          const int y = q / vw, xv = q - y * vw;
          r[u] = *reinterpret_cast<const Vec16<T>*>(base + y * sy + xv * V);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int q = q0 + u * T_;
        if (q < nv) {
#pragma unroll
          for (int k = 0; k < V; ++k) take(to_f(r[u].v[k]), q * V + k, best, bi);
        }
      }
    }
  } else {
    // element m = tid + i * T_: (x, y) carried by (T_ % W, T_ / W)
    const int dx = T_ % W, dy = T_ / W;
    int x = tid % W, y = tid / W;
    for (int m0 = tid; m0 < HW; m0 += kUnroll * T_) {
      float r[kUnroll];
      int xs[kUnroll], ys[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        xs[u] = x;
        ys[u] = y;
        if (m0 + u * T_ < HW) r[u] = to_f(base[y * sy + x * sx]);
        x += dx;
        y += dy;
        if (x >= W) {
          x -= W;
          ++y;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (m0 + u * T_ < HW) take(r[u], ys[u] * W + xs[u], best, bi);
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const float ov = __shfl_down_sync(0xffffffffu, best, off);
    const int oi = __shfl_down_sync(0xffffffffu, bi, off);
    if (beats(ov, oi, best, bi)) {
      best = ov;
      bi = oi;
    }
  }
  __shared__ float wv[kThreads / 32];
  __shared__ int wi[kThreads / 32];
  const int lane = tid & 31, warp = tid >> 5;
  if (lane == 0) {
    wv[warp] = best;
    wi[warp] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    for (int w = 1; w < T_ / 32; ++w)
      if (beats(wv[w], wi[w], best, bi)) {
        best = wv[w];
        bi = wi[w];
      }
    xy[blockIdx.x * 2] = bi % W;
    xy[blockIdx.x * 2 + 1] = bi / W;
    maxv[blockIdx.x] = best;
  }
}

// Channels-last heads: grid (N * tiles), blocks of C * L threads (L lanes a
// channel); tile k of image n covers pixels [k * per, (k + 1) * per). part_v,
// part_i: N * tiles * C (maximum, index) of the tiles; ticket: one word, 0
// before the first call and left so.
template <typename T>
__global__ void __launch_bounds__(1024)
    k10_tiles(const T* __restrict__ hm, int C, int HW, int W, long long sn, int tiles, int per,
              float* __restrict__ part_v, int* __restrict__ part_i,
              unsigned int* __restrict__ ticket, int* __restrict__ xy,
              float* __restrict__ maxv) {
  __shared__ float sv[1024];
  __shared__ int si[1024];
  __shared__ bool last;
  const int n = blockIdx.x / tiles, k = blockIdx.x - n * tiles, tid = threadIdx.x;
  const int L = blockDim.x / C, c = tid % C, l = tid / C;
  const int p0 = k * per, p1 = min(HW, p0 + per);
  const T* base = hm + n * sn + c;
  float best = 0.f;
  int bi = kNone;
  for (int q = p0 + l; q < p1; q += kUnroll * L) {
    float r[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q + u * L < p1) r[u] = to_f(base[(long long)(q + u * L) * C]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (q + u * L < p1) take(r[u], q + u * L, best, bi);
  }
  sv[tid] = best;
  si[tid] = bi;
  __syncthreads();
  if (tid < C) {  // channel tid: its lanes in order
    for (int j = 1; j < L; ++j)
      if (beats(sv[j * C + tid], si[j * C + tid], best, bi)) {
        best = sv[j * C + tid];
        bi = si[j * C + tid];
      }
    part_v[(size_t)blockIdx.x * C + tid] = best;
    part_i[(size_t)blockIdx.x * C + tid] = bi;
  }
  __syncthreads();
  if (tid == 0) {
    __threadfence();  // this block's partials before its ticket
    last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  if (tid == 0) atomicExch(ticket, 0u);
  // S = blockDim.x / pairs threads per (image, channel) (1 when there are
  // more pairs than threads, each thread then walking pairs); thread s of a
  // pair merges tiles s, s + S, ..., kUnroll loads at a time, then thread 0
  // of the pair merges the S results (the comparison is a total order, so
  // the merge order does not change the result).
  const int pairs = (int)(gridDim.x / tiles) * C;
  const int S = max(1, (int)blockDim.x / pairs);
  const int s_ = tid / pairs;
  for (int pr = tid % pairs; s_ < S && pr < pairs; pr += (S == 1 ? blockDim.x : pairs)) {
    const int m = pr / C, ch = pr - m * C;
    const size_t at0 = (size_t)m * tiles * C + ch;
    float b = 0.f;
    int i = kNone;
    for (int t0 = s_; t0 < tiles; t0 += kUnroll * S) {
      float v[kUnroll];
      int j[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int t = t0 + u * S;
        j[u] = kNone;
        if (t < tiles) {
          v[u] = __ldcg(part_v + at0 + (size_t)t * C);
          j[u] = __ldcg(part_i + at0 + (size_t)t * C);
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (beats(v[u], j[u], b, i)) {
          b = v[u];
          i = j[u];
        }
    }
    if (S == 1) {
      xy[pr * 2] = i % W;
      xy[pr * 2 + 1] = i / W;
      maxv[pr] = b;
    } else {
      sv[tid] = b;
      si[tid] = i;
    }
  }
  if (S == 1) return;
  __syncthreads();
  if (tid < pairs) {
    float b = sv[tid];
    int i = si[tid];
    for (int k = 1; k < S; ++k)
      if (beats(sv[k * pairs + tid], si[k * pairs + tid], b, i)) {
        b = sv[k * pairs + tid];
        i = si[k * pairs + tid];
      }
    xy[tid * 2] = i % W;
    xy[tid * 2 + 1] = i / W;
    maxv[tid] = b;
  }
}

// hm: N heatmaps (H, W, C) at element strides (sn, sy, sx, sc), float32
// (dtype 0) or bfloat16 (1); vec: 1 where x stride is 1, W, sy and sn are
// multiples of 16 bytes' elements and the base is 16-byte aligned (the
// wrapper checks); xy: (N, C, 2) int32; maxv: (N, C) float32. One launch of
// N * C blocks on `stream`.
extern "C" int argmax2d(const void* hm, int N, int H, int W, int C, long long sn, long long sy,
                        long long sx, long long sc, int dtype, int vec, void* xy, void* maxv,
                        void* stream) {
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || (long long)H * W >= (1LL << 31) ||
      (long long)N * C > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const int blocks = N * C;
#define LAUNCH(TT, VV)                                                                      \
  k10_argmax<TT, VV><<<blocks, kThreads, 0, st>>>((const TT*)hm, C, H, W, sn, sy, sx, sc,   \
                                                   (int*)xy, (float*)maxv)
  if (dtype == DTYPE_F32 && vec) LAUNCH(float, true);
  else if (dtype == DTYPE_F32) LAUNCH(float, false);
  else if (dtype == DTYPE_BF16 && vec) LAUNCH(__nv_bfloat16, true);
  else if (dtype == DTYPE_BF16) LAUNCH(__nv_bfloat16, false);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return launch_status();
}

// Channels-last heads (sc 1, sx C, sy W * C; C > 1): the tiled launch of
// `tiles` tiles of `per` pixels an image and blocks of `threads` (a multiple
// of C, at most 1024). part_v, part_i: N * tiles * C floats / ints; ticket:
// one word, 0 before the first call and left so. One launch on `stream`.
extern "C" int argmax2d_tiles(const void* hm, int N, int H, int W, int C, long long sn,
                              int dtype, int tiles, int per, int threads, void* part_v,
                              void* part_i, void* ticket, void* xy, void* maxv, void* stream) {
  if (N <= 0 || C <= 1 || threads % C || threads > 1024 || tiles <= 0 ||
      (long long)tiles * per < (long long)H * W || (long long)N * tiles > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
#define LAUNCH(TT)                                                                          \
  k10_tiles<TT><<<N * tiles, threads, 0, st>>>((const TT*)hm, C, H * W, W, sn, tiles, per,  \
                                              (float*)part_v, (int*)part_i,                 \
                                              (unsigned int*)ticket, (int*)xy, (float*)maxv)
  if (dtype == DTYPE_F32) LAUNCH(float);
  else if (dtype == DTYPE_BF16) LAUNCH(__nv_bfloat16);
  else return (int)cudaErrorInvalidValue;
#undef LAUNCH
  return launch_status();
}
