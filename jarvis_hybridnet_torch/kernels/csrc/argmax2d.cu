// K10 argmax2d: per (image, channel), the spatial maximum of a heatmap and the
// first row-major index that attains it.
//
// Replaces: ops/heatmap.py::argmax_2d (:15) of the JAX package (jnp.argmax
// and jnp.max over the flattened H * W of (N, H, W, C) heatmaps), which the
// 2D train and eval steps (trainer2d.py:187, :195) and every predictor
// (predictor3d.py:70, predictor2d.py:57, :79 of the port) call.
//
// Out: x = m % W, y = m / W (int32) and the maximum (float32; exact for a
// bfloat16 input). NaN counts as larger than any number, so a NaN and its
// first index win, as with jnp.argmax and torch.max; -0.0 and +0.0 tie.
//
// Bound on the H100: bytes (each heatmap element read once; 12 bytes written
// per (image, channel)).
//
// Design: one launch. Each (value, index) becomes one 64-bit key: the high
// word the value's order-preserving bits (-0.0 folded onto +0.0, every NaN
// on one key above +inf), the low word ~index. The largest key is then the
// largest value at its lowest index, so every merge is one max, in any
// order, and the result does not depend on the scheduling. The heads are
// read through their strides as "runs", each cut into `shares` CTAs:
// - planar: a run per (image, channel) whose H * W elements are one dense
//   row-major plane (x stride 1, y stride W: every single-channel head and
//   contiguous NCHW maps). A thread takes 16-byte vectors of its share in
//   increasing index, kUnroll loads in flight, and keeps its first maximum
//   by a strict comparison of the 32-bit order keys; the block merges its
//   threads' 64-bit keys by warp shuffles. Other layouts take the same walk
//   an element at a time.
// - interleaved: a run per image of channels-last heads (C > 1, a pixel's C
//   values contiguous, pixels dense). A share is a whole number of pixels,
//   staged in shared memory by 16-byte loads where aligned; then warp w
//   takes channels w, w + warps, ..., its lanes every 32nd pixel
//   (conflict-free for an odd C), and merges by shuffles.
// The shares of a run fold their keys into global ones with atomicMax; the
// share that takes the run's last ticket (one acquire-release atomic) reads
// them back with atomicExch(0), which leaves keys and ticket at 0 for the
// next call. (A thread block cluster per run, merged through distributed
// shared memory, measured the same within 0.0003 ms where a run's shares
// fit one, kernel_sweep.py; atomics cover every run.) The winner's value is
// decoded from its key, or read back at its index where the key cannot say
// it (a zero, which may be -0.0, and NaN), so the maximum equals the
// element's bits.
#include "common.cuh"

constexpr int kMaxThreads = 1024;
constexpr int kUnroll = 4;
constexpr unsigned int kZeroKey = 0x80000000u;  // +0.0 and -0.0
constexpr unsigned int kNanKey = 0xffffffffu;

template <typename T>
struct alignas(16) Vec16 {
  T v[16 / sizeof(T)];
};

// The order key of v: larger values have larger keys.
__device__ __forceinline__ unsigned int order_key(float v) {
  const unsigned int u = __float_as_uint(v);
  unsigned int o = u ^ ((unsigned int)((int)u >> 31) | 0x80000000u);
  if (o == 0x7fffffffu) o = kZeroKey;  // -0.0
  return isnan(v) ? kNanKey : o;
}

// A thread's elements come in increasing index: the first maximum stays.
// Every element's key is above 0, so the first element is always taken.
__device__ __forceinline__ void take(float v, int m, unsigned int& best, int& at) {
  const unsigned int o = order_key(v);
  if (o > best) {
    best = o;
    at = m;
  }
}

__device__ __forceinline__ unsigned long long make_key(unsigned int best, int at) {
  return at < 0 ? 0ull : ((unsigned long long)best << 32) | (unsigned int)~at;
}

__device__ __forceinline__ unsigned long long warp_max(unsigned long long k) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    const unsigned long long o = __shfl_xor_sync(0xffffffffu, k, off);
    k = o > k ? o : k;
  }
  return k;
}

struct Args {
  const void* hm;
  long long sn, sy, sx, sc;  // element strides
  int N, H, W, C;
  int cr;       // channels a run holds: 1 (planar) or C (interleaved)
  int len;      // elements a run: H * W * cr
  int shares;   // CTAs a run
  int per;      // elements a share (a multiple of the vector's and, interleaved, of C)
  int vec;      // 16-byte loads (the runs start on 16 bytes)
  unsigned long long* keys;  // runs * cr, 0 between calls (atomic merge)
  unsigned int* tickets;     // runs, 0 between calls
  int* xy;
  float* maxv;
};

// (image, channel) o = r * cr + c of run r: its index, and its maximum
// decoded from the key or read back at the index.
template <typename T>
__device__ void write_out(const Args& a, int o, unsigned long long key) {
  const int n = o / a.C, c = o - n * a.C;
  const int m = (int)~(unsigned int)key;
  const int y = m / a.W, x = m - y * a.W;
  const unsigned int hi = (unsigned int)(key >> 32);
  float v;
  if (hi == kZeroKey || hi == kNanKey)
    v = to_f(static_cast<const T*>(a.hm)[n * a.sn + c * a.sc + y * a.sy + x * a.sx]);
  else
    v = __uint_as_float(hi & 0x80000000u ? hi & 0x7fffffffu : ~hi);
  a.xy[o * 2] = x;
  a.xy[o * 2 + 1] = y;
  a.maxv[o] = v;
}

// grid runs * shares. Shared memory: the CTA's cr keys (planar: one a warp), then, interleaved, the
// share's elements at stage_off.
template <typename T, bool kInterleaved>
__global__ void __launch_bounds__(kMaxThreads) k10(const Args a, int stage_off) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ bool last;
  unsigned long long* ck = reinterpret_cast<unsigned long long*>(smem);
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31, warp = tid >> 5;
  const int r = blockIdx.x / a.shares, s = blockIdx.x - r * a.shares;
  const int e0 = s * a.per, e1 = min(a.len, e0 + a.per);
  const T* base = static_cast<const T*>(a.hm) +
                  (kInterleaved ? r * a.sn : (r / a.C) * a.sn + (r % a.C) * a.sc);
  constexpr int V = 16 / sizeof(T);
  if constexpr (!kInterleaved) {
    unsigned int best = 0;
    int at = -1;
    if (a.vec) {
      const int q1 = e1 / V;  // e0 is a multiple of V
      for (int q0 = e0 / V + tid; q0 < q1; q0 += kUnroll * nt) {
        Vec16<T> v[kUnroll];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q0 + u * nt < q1) v[u] = reinterpret_cast<const Vec16<T>*>(base)[q0 + u * nt];
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
          if (q0 + u * nt < q1) {
#pragma unroll
            for (int k = 0; k < V; ++k) take(to_f(v[u].v[k]), (q0 + u * nt) * V + k, best, at);
          }
      }
      for (int e = q1 * V + tid; e < e1; e += nt) take(to_f(base[e]), e, best, at);
    } else {
      for (int e = e0 + tid; e < e1; e += nt) {
        const int y = e / a.W, x = e - y * a.W;
        take(to_f(base[y * a.sy + x * a.sx]), e, best, at);
      }
    }
    const unsigned long long k = warp_max(make_key(best, at));
    if (lane == 0) ck[warp] = k;
    __syncthreads();
    if (warp == 0) {
      const unsigned long long w = warp_max(lane < nt / 32 ? ck[lane] : 0ull);
      if (lane == 0) ck[0] = w;
    }
  } else {
    T* stage = reinterpret_cast<T*>(smem + stage_off);
    const int n = e1 - e0;  // a whole number of pixels
    const int nv = a.vec ? n / V : 0;
    for (int q0 = tid; q0 < nv; q0 += kUnroll * nt) {
      Vec16<T> v[kUnroll];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + u * nt < nv) v[u] = reinterpret_cast<const Vec16<T>*>(base + e0)[q0 + u * nt];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
        if (q0 + u * nt < nv) reinterpret_cast<Vec16<T>*>(stage)[q0 + u * nt] = v[u];
    }
    for (int e = nv * V + tid; e < n; e += nt) stage[e] = base[e0 + e];
    __syncthreads();
    const int cr = a.cr, pixels = n / cr, p0 = e0 / cr;
    for (int c = warp; c < cr; c += nt / 32) {
      unsigned int best = 0;
      int at = -1;
      for (int p = lane; p < pixels; p += 32) take(to_f(stage[p * cr + c]), p0 + p, best, at);
      const unsigned long long k = warp_max(make_key(best, at));
      if (lane == 0) ck[c] = k;
    }
  }
  __syncthreads();
  const int o0 = r * a.cr;
  if (a.shares == 1) {
    for (int c = tid; c < a.cr; c += nt) write_out<T>(a, o0 + c, ck[c]);
    return;
  }
  for (int c = tid; c < a.cr; c += nt) atomicMax(a.keys + o0 + c, ck[c]);
  // the barrier orders the block's key updates before thread 0's ticket,
  // whose release makes them visible with it (cumulativity); its acquire
  // orders the other shares' updates before the last share's reads
  __syncthreads();
  if (tid == 0) last = ticket_add(a.tickets + r) == (unsigned int)a.shares - 1;
  __syncthreads();
  if (!last) return;
  for (int c = tid; c < a.cr; c += nt) write_out<T>(a, o0 + c, atomicExch(a.keys + o0 + c, 0ull));
  if (tid == 0) atomicExch(a.tickets + r, 0u);
}

template <typename T, bool kInterleaved>
static int launch(const Args& a, int runs, int threads, cudaStream_t st) {
  const int keys = (kInterleaved ? a.cr : kMaxThreads / 32) * 8;
  const int stage_off = (keys + 15) / 16 * 16;
  const int smem = kInterleaved ? stage_off + a.per * (int)sizeof(T) : keys;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        k10<T, kInterleaved>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  k10<T, kInterleaved><<<runs * a.shares, threads, smem, st>>>(a, stage_off);
  return launch_status();
}

// hm: N heatmaps (H, W, C) at element strides (sn, sy, sx, sc), float32
// (dtype 0) or bfloat16 (1); xy: (N, C, 2) int32; maxv: (N, C) float32. The
// plan (kernels/argmax2d.py::launch_plan): interleaved (channels-last runs,
// sc 1, sx C, sy W * C) or planar; vec: 16-byte loads (the runs start on 16
// bytes; planar also x stride 1 and y stride W); `shares` CTAs of `threads`
// a run, `per` elements each. keys: with more than one share, runs * cr
// 64-bit keys then runs 32-bit tickets, all 0 before the first call and left
// so. One launch on `stream`.
extern "C" int argmax2d(const void* hm, int N, int H, int W, int C, long long sn, long long sy,
                        long long sx, long long sc, int dtype, int interleaved, int vec,
                        int shares, int per, int threads, void* keys, void* xy, void* maxv,
                        void* stream) {
  const int V = dtype == DTYPE_BF16 ? 8 : 4;
  const long long cr = interleaved ? C : 1, runs = interleaved ? N : (long long)N * C;
  const long long len = (long long)H * W * cr;
  if (N <= 0 || C <= 0 || H <= 0 || W <= 0 || len >= (1LL << 31) || shares <= 0 || per <= 0 ||
      (long long)per * shares < len || (long long)per * (shares - 1) >= len ||
      runs * shares > 0x7fffffffLL || threads % 32 || threads <= 0 || threads > kMaxThreads ||
      (vec && per % V) || (interleaved && (C < 2 || per % C)) || (shares > 1 && !keys))
    return (int)cudaErrorInvalidValue;
  Args a;
  a.hm = hm;
  a.sn = sn;
  a.sy = sy;
  a.sx = sx;
  a.sc = sc;
  a.N = N;
  a.H = H;
  a.W = W;
  a.C = C;
  a.cr = (int)cr;
  a.len = (int)len;
  a.shares = shares;
  a.per = per;
  a.vec = vec;
  a.keys = static_cast<unsigned long long*>(keys);
  a.tickets = keys ? reinterpret_cast<unsigned int*>(a.keys + runs * cr) : nullptr;
  a.xy = static_cast<int*>(xy);
  a.maxv = static_cast<float*>(maxv);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_F32)
    return interleaved ? launch<float, true>(a, (int)runs, threads, st)
                       : launch<float, false>(a, (int)runs, threads, st);
  if (dtype == DTYPE_BF16)
    return interleaved ? launch<__nv_bfloat16, true>(a, (int)runs, threads, st)
                       : launch<__nv_bfloat16, false>(a, (int)runs, threads, st);
  return (int)cudaErrorInvalidValue;
}
