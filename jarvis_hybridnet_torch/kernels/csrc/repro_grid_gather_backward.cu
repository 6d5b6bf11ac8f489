// K12: the exact, half and half_fused reprojection gathers' backward with
// respect to the heatmap rows, one launch (after a cudaMemsetAsync of the
// output).
//
// Replaces: the VJP (jax.vjp, as jax.value_and_grad takes it through
// HybridNet) of models/repro.py reprojection_layer with respect to the
// heatmaps in the exact (:266-273), half (:302-317, _upsample2_axis :47)
// and half_fused (:302-311) modes: gather_voxel_volume's (:157) camera
// mean transposed, the VJP of K5.
//
// The function: the upstream gradient of the forward's float32 volume, in
// its layout (B, F, F, F, J), goes through the 0.25/0.75 value upsample
// transposed along z, then y, then x for half (F = 2n), or is taken as it
// is for exact and half_fused (F = n); each of the n^3 gather points'
// values, divided by the rig's cameras (ct), is added to the row the point
// was gathered from in each of the C cameras. The output is the (B, C, hs2, J) gradient of the
// rows, the J-view of a zeroed (B, C, hs2, S) buffer.
//
// Bound on the H100: bytes (the upstream gradient and the indices read
// once, the padded rows written once). The work is B * C * n^3 * J adds at
// rows the indices choose, and every point outside a camera's crop clamps
// onto the window's edge pixels. Measured, the L2 applies the reductions
// at about 75 G 32-byte sectors a second whatever their width, so only
// adding a pixel's points first moves the scatter; a 6^3 exact tile's
// points land 2.9 to a pixel in a camera (PERF.md).
//
// Design: a block per (frameset, tile) of t^3 gather points, t a
// compile-time edge (K12_TILES below), so no index arithmetic divides
// (tile 0, exact and half_fused without a window: point_backward below,
// no tile and no shared memory).
// 1. Staging, one round trip: cp.async copies of the tile's upstream rows
//    (half: its upstream block with a one-position halo), a warp a run of
//    consecutive z (contiguous in global memory), and of every camera's
//    indices of its points, all in flight at once.
// 2. The values, divided by ct, rows S floats apart (joints past J are 0).
//    half: the transposed upsample from the staged block, separably (z,
//    then y, then x), each product rounded before its sum in the plain
//    version's order (_upsample2_transposed), so the values equal its
//    float32 ones bit for bit (built with --fmad=false).
// 3. Each point's pixel as (row, col) and, a warp a camera, each camera's
//    bounding box.
// 4. The scatter, in 16-byte reductions (atomicAdd on float4,
//    red.global.add.v4.f32). The overflow branch: each (point, 4 joints)
//    adds its 4 values to each camera's row. With a window (win > 0), a
//    camera whose box of the tile's pixels holds at most win pixels sorts
//    the tile's points by pixel in shared memory (a counting sort: integer
//    atomics count, a warp scans, each point takes its place), and each
//    (pixel, 4 joints) sums its points' values and adds them once; a
//    larger box takes the overflow branch. Without a window no barrier
//    follows the one after step 3.
// Float atomics still add in a changing order: two calls need not be
// bit-equal.
#include <limits.h>

#include <cmath>

#include "common.cuh"

// repro_grid_gather.py MODES
constexpr int kExact = 0, kHalf = 1, kHalfFused = 2;
constexpr int kSmemMax = 232448;

// the (mode, tile edge) pairs compiled (repro_grid_gather.BACKWARD_TILES)
#define K12_TILES(X) \
  X(kExact, 4) X(kExact, 6) X(kExact, 8) X(kHalf, 2) X(kHalf, 3) X(kHalf, 4) X(kHalfFused, 4)

// The shared-memory layout in 4-byte words (repro_grid_gather.backward_layout
// mirrors it): the values, P = t^3 rows of S; the points' pixels in every
// camera, C * P ints; the cameras' boxes, 4 * C ints; then, on 16 bytes, a
// region that first holds the staged upstream rows as they lie in global
// memory (J apart): the tile's P rows, or for half its upstream block of
// (e, e, e) rows (e = 2t + 2) with the z pass's (e, e, t) rows of S behind
// it, and the y pass's (e, t, t) rows of S over the block; then, with a
// window, the counting sort's C rows of win + 1 ints and C rows of P ints.
struct Layout {
  int val, pix, box, wnd, tz, total;
};

__host__ __device__ inline Layout layout(int mode, int C, int t, int J, int S, int win) {
  const int P = t * t * t, e = 2 * t + 2;
  Layout l;
  l.val = 0;
  l.pix = P * S;
  l.box = l.pix + C * P;
  l.wnd = (l.box + 4 * C + 3) / 4 * 4;
  l.tz = l.wnd + (e * e * e * J + 3) / 4 * 4;
  const int staged = mode == kHalf ? l.tz - l.wnd + e * e * t * S : P * J;
  const int sort = win > 0 ? C * (win + 1) + C * P : 0;
  l.total = l.wnd + (sort > staged ? sort : staged);
  return l;
}

// a 4-byte copy from global to shared memory that does not wait (cp.async)
__device__ __forceinline__ void copy_async(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"((unsigned)__cvta_generic_to_shared(dst)), "l"(src) : "memory");
}

__device__ __forceinline__ void copies_landed() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// in[k] of the 0.25/0.75 upsample's transpose along an axis of 2L outputs,
// at(q) the output q: _upsample2_transposed's terms in its order.
template <typename At>
__device__ __forceinline__ float upsample2_t(At at, int k, int L) {
  const float e = at(2 * k), o = at(2 * k + 1);
  float v = __fadd_rn(__fmul_rn(0.75f, e), __fmul_rn(0.75f, o));
  if (k < L - 1) v = __fadd_rn(v, __fmul_rn(0.25f, at(2 * k + 2)));
  if (k == 0) v = __fadd_rn(v, __fmul_rn(0.25f, e));
  if (k > 0) v = __fadd_rn(v, __fmul_rn(0.25f, at(2 * k - 1)));
  if (k == L - 1) v = __fadd_rn(v, __fmul_rn(0.25f, o));
  return v;
}

template <int kMode, int kTile, int kThreads>
__global__ void __launch_bounds__(kThreads)
    grid_backward(const float* __restrict__ grad, const int* __restrict__ idx,
                  float* __restrict__ out, int C, int ct, int J, int S, int hs2, int hs, int n,
                  int win) {
  constexpr int t = kTile, P = t * t * t, e = 2 * t + 2;
  extern __shared__ __align__(16) float sm[];
  const Layout l = layout(kMode, C, t, J, S, win);
  float* val = sm + l.val;
  int* pix = (int*)(sm + l.pix);
  int* box = (int*)(sm + l.box);
  const int tiles = (n + t - 1) / t, tid = threadIdx.x;
  const int b = blockIdx.x / (tiles * tiles * tiles), item = blockIdx.x % (tiles * tiles * tiles);
  const int x0 = item / (tiles * tiles) * t, y0 = item / tiles % tiles * t, z0 = item % tiles * t;
  const int F = kMode == kHalf ? 2 * n : n;
  const float* g = grad + (size_t)b * F * F * F * J;
  const int* ib = idx + (size_t)b * C * n * n * n;
  // point groups of S threads, one per joint (threads past groups * S only
  // join the whole-block loops)
  const int groups = kThreads / S, grp = tid / S, j = tid % S;
  const bool in_group = grp < groups;

  // 1. staging, every copy in flight at once: the tile's upstream rows
  // (half: its upstream block with the halo), a warp a run of consecutive z
  // (contiguous in global memory); every camera's indices of the tile's
  // points
  float* raw = sm + l.wnd;
  const int warp = tid / 32, lane = tid % 32;
  if (kMode != kHalf) {
    const int len = min(t, n - z0) * J;
    for (int r = warp; r < t * t; r += kThreads / 32) {
      const int x = x0 + r / t, y = y0 + r % t;
      if (x >= n || y >= n) continue;
      const float* src = g + (((size_t)x * n + y) * n + z0) * J;
      for (int k = lane; k < len; k += 32) copy_async(raw + r * t * J + k, src + k);
    }
  } else {
    const int zlo = max(2 * z0 - 1, 0), len = (min(2 * z0 + 2 * t, F - 1) - zlo + 1) * J;
    for (int r = warp; r < e * e; r += kThreads / 32) {
      const int gx = 2 * x0 - 1 + r / e, gy = 2 * y0 - 1 + r % e;
      if (gx < 0 || gx >= F || gy < 0 || gy >= F) continue;
      const float* src = g + (((size_t)gx * F + gy) * F + zlo) * J;
      float* dst = raw + (r * e + zlo - (2 * z0 - 1)) * J;
      for (int k = lane; k < len; k += 32) copy_async(dst + k, src + k);
    }
  }
  for (int i = tid; i < C * P; i += kThreads) {
    const int c = i / P, p = i - c * P;
    const int x = x0 + p / (t * t), y = y0 + p / t % t, z = z0 + p % t;
    if (x < n && y < n && z < n)
      copy_async(pix + i, ib + (size_t)c * n * n * n + ((size_t)x * n + y) * n + z);
  }
  copies_landed();
  __syncthreads();

  // 2. the values / ct (the rig's cameras) in rows S apart, joints past J and points past the
  // grid's edge 0 (half: the transposed upsample's z, y and x passes first,
  // each product rounded before its sum)
  const float fc = (float)ct;
  if (kMode != kHalf) {
    for (int p = grp; in_group && p < P; p += groups) {
      const int x = x0 + p / (t * t), y = y0 + p / t % t, z = z0 + p % t;
      val[p * S + j] = j < J && x < n && y < n && z < n ? __fdiv_rn(raw[p * J + j], fc) : 0.f;
    }
  } else {
    float* tz = sm + l.tz;
    float* ty = raw;  // over the upstream block, once the z pass has read it
    // z: (xl, yl, kz) from raw[(xl, yl, zl)], zl = z - (2 z0 - 1)
    for (int i = grp; in_group && i < e * e * t; i += groups) {
      const int kz = i % t, k = z0 + kz, r = i / t;
      const int gx = 2 * x0 - 1 + r / e, gy = 2 * y0 - 1 + r % e;
      const float* row = raw + (size_t)r * e * J + j;
      tz[i * S + j] = j < J && k < n && gx >= 0 && gx < F && gy >= 0 && gy < F
                          ? upsample2_t([&](int q) { return row[(q - 2 * z0 + 1) * J]; }, k, n)
                          : 0.f;
    }
    __syncthreads();
    // y: (xl, ky, kz) from tz[(xl, yl, kz)], yl = y - (2 y0 - 1)
    for (int i = grp; in_group && i < e * t * t; i += groups) {
      const int kz = i % t, ky = i / t % t, xl = i / (t * t);
      const float* col = tz + ((size_t)xl * e * t + kz) * S + j;
      ty[i * S + j] =
          y0 + ky < n
              ? upsample2_t([&](int q) { return col[(q - 2 * y0 + 1) * t * S]; }, y0 + ky, n)
              : 0.f;
    }
    __syncthreads();
    // x: (kx, ky, kz) from ty[(xl, ky, kz)], xl = x - (2 x0 - 1)
    for (int p = grp; in_group && p < P; p += groups) {
      const int kz = p % t, ky = p / t % t, kx = p / (t * t);
      const float* col = ty + ((size_t)ky * t + kz) * S + j;
      float v = 0.f;
      if (x0 + kx < n && y0 + ky < n && z0 + kz < n)
        v = __fdiv_rn(
            upsample2_t([&](int q) { return col[(q - 2 * x0 + 1) * t * t * S]; }, x0 + kx, n),
            fc);
      val[p * S + j] = v;
    }
  }

  // 3. the points' pixels as (row << 16 | col), -1 past the grid's edge,
  // and (with a window) each camera's box, a warp a camera
  for (int c = warp; c < C; c += kThreads / 32) {
    int rmin = INT_MAX, rmax = -1, cmin = INT_MAX, cmax = -1;
    for (int p = lane; p < P; p += 32) {
      const int x = x0 + p / (t * t), y = y0 + p / t % t, z = z0 + p % t;
      int rc = -1;
      if (x < n && y < n && z < n) {
        const int q = min(max(pix[c * P + p], 0), hs2 - 1);  // memory safety only
        const int r = q / hs, col = q - r * hs;
        rc = r << 16 | col;
        rmin = min(rmin, r), rmax = max(rmax, r), cmin = min(cmin, col), cmax = max(cmax, col);
      }
      pix[c * P + p] = rc;
    }
    if (win > 0) {
      rmin = __reduce_min_sync(~0u, rmin), rmax = __reduce_max_sync(~0u, rmax);
      cmin = __reduce_min_sync(~0u, cmin), cmax = __reduce_max_sync(~0u, cmax);
      if (lane == 0)
        box[4 * c] = rmin, box[4 * c + 1] = rmax, box[4 * c + 2] = cmin, box[4 * c + 3] = cmax;
    }
  }

  __syncthreads();

  // 4. the scatter, (point or pixel, 4 joints) items, a thread each; quads
  // past J are skipped
  float* ob = out + (size_t)b * C * hs2 * S;
  const int q4 = S / 4, items = kThreads / q4, it = tid / q4, q = tid % q4;
  const bool quad_on = it < items && 4 * q < J;
  if (win == 0) {  // the overflow branch for every camera, no barrier
    for (int p = it; quad_on && p < P; p += items) {
      const float4 v = *(const float4*)(val + p * S + 4 * q);
      for (int c = 0; c < C; ++c) {
        const int rc = pix[c * P + p];
        if (rc >= 0)
          atomicAdd((float4*)(ob + ((size_t)c * hs2 + (rc >> 16) * hs + (rc & 0xffff)) * S) + q,
                    v);
      }
    }
    return;
  }
  // The windows: camera c's points sorted by their pixel in its box of
  // h * w <= win pixels (a counting sort: count, scan, place), so each
  // (pixel, 4 joints) sums its points' values and adds them once. cnt:
  // C rows of win + 1 ints (the counts, then the buckets' starts); order:
  // C rows of P points; both over the staged rows, which are read by now.
  int* cnt = (int*)raw;
  int* order = cnt + C * (win + 1);
  for (int i = tid; i < C * (win + 1); i += kThreads) cnt[i] = 0;
  __syncthreads();
  // count: a point's rank in its pixel's bucket, packed with the pixel
  // (local << 16 | rank) where its camera has a window
  for (int i = tid; i < C * P; i += kThreads) {
    const int c = i / P, rc = pix[i], *bx = box + 4 * c;
    const int w = bx[3] - bx[2] + 1;
    if (rc < 0 || (bx[1] - bx[0] + 1) * w > win) continue;
    const int local = ((rc >> 16) - bx[0]) * w + (rc & 0xffff) - bx[2];
    pix[i] = local << 16 | atomicAdd(cnt + c * (win + 1) + local, 1);
  }
  __syncthreads();
  // scan: each windowed camera's counts into its buckets' starts (a warp a
  // camera; entry h * w ends as the camera's point count)
  for (int c = warp; c < C; c += kThreads / 32) {
    const int* bx = box + 4 * c;
    const int area = (bx[1] - bx[0] + 1) * (bx[3] - bx[2] + 1);
    if (area > win) continue;
    int* row = cnt + c * (win + 1);
    int carry = 0;
    for (int i0 = 0; i0 <= area; i0 += 32) {
      const int v = i0 + lane <= area ? row[i0 + lane] : 0;
      int incl = v;
      for (int d = 1; d < 32; d *= 2) {
        const int u = __shfl_up_sync(~0u, incl, d);
        if (lane >= d) incl += u;
      }
      if (i0 + lane <= area) row[i0 + lane] = carry + incl - v;
      carry += __shfl_sync(~0u, incl, 31);
    }
  }
  __syncthreads();
  // place each point in its bucket
  for (int i = tid; i < C * P; i += kThreads) {
    const int c = i / P, *bx = box + 4 * c;
    if (pix[i] < 0 || (bx[1] - bx[0] + 1) * (bx[3] - bx[2] + 1) > win) continue;
    order[c * P + cnt[c * (win + 1) + (pix[i] >> 16)] + (pix[i] & 0xffff)] = i - c * P;
  }
  __syncthreads();
  // add: a (pixel, 4 joints) item sums its bucket's values in one 16-byte
  // reduction; a camera without a window takes the overflow branch
  for (int c = 0; c < C; ++c) {
    const int* bx = box + 4 * c;
    const int w = bx[3] - bx[2] + 1, area = (bx[1] - bx[0] + 1) * w;
    float* oc = ob + (size_t)c * hs2 * S;
    if (area > win) {
      for (int p = it; quad_on && p < P; p += items) {
        const int rc = pix[c * P + p];
        if (rc >= 0)
          atomicAdd((float4*)(oc + ((size_t)(rc >> 16) * hs + (rc & 0xffff)) * S) + q,
                    *(const float4*)(val + p * S + 4 * q));
      }
      continue;
    }
    const int* starts = cnt + c * (win + 1);
    for (int local = it; quad_on && local < area; local += items) {
      const int k0 = starts[local], k1 = starts[local + 1];
      if (k0 == k1) continue;
      float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
      for (int k = k0; k < k1; ++k) {
        const float4 u = *(const float4*)(val + order[c * P + k] * S + 4 * q);
        v.x = __fadd_rn(v.x, u.x), v.y = __fadd_rn(v.y, u.y);
        v.z = __fadd_rn(v.z, u.z), v.w = __fadd_rn(v.w, u.w);
      }
      const int row = bx[0] + local / w, col = bx[2] + local - local / w * w;
      atomicAdd((float4*)(oc + ((size_t)row * hs + col) * S) + q, v);
    }
  }
}

// The overflow branch without a tile (tile 0; exact and half_fused, no
// window): a thread per (frameset, point, 4 joints) divides its 4 upstream
// values by ct and adds them to each camera's row in one 16-byte reduction,
// its C index loads in flight together.
template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    point_backward(const float* __restrict__ grad, const int* __restrict__ idx,
                   float* __restrict__ out, int C, int ct, int J, int S, int hs2, int n3) {
  const int q4 = S / 4;
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  const int p = (int)(i / q4), q = (int)(i - (long long)p * q4);
  if (p >= n3 || 4 * q >= J) return;
  const int b = blockIdx.y;
  const float* g = grad + ((size_t)b * n3 + p) * J + 4 * q;
  const float fc = (float)ct;
  float4 v;
  v.x = __fdiv_rn(g[0], fc);
  v.y = 4 * q + 1 < J ? __fdiv_rn(g[1], fc) : 0.f;
  v.z = 4 * q + 2 < J ? __fdiv_rn(g[2], fc) : 0.f;
  v.w = 4 * q + 3 < J ? __fdiv_rn(g[3], fc) : 0.f;
  const int* ic = idx + (size_t)b * C * n3 + p;
  float* ob = out + (size_t)b * C * hs2 * S + 4 * q;
#pragma unroll 4
  for (int c = 0; c < C; ++c) {
    const int px = min(max(ic[(size_t)c * n3], 0), hs2 - 1);  // memory safety only
    atomicAdd((float4*)(ob + ((size_t)c * hs2 + px) * S), v);
  }
}

// lets the instantiation use up to kSmemMax bytes of shared memory (once)
template <int kMode, int kTile, int kThreads>
static int allow_smem() {
  static const int err = (int)cudaFuncSetAttribute(grid_backward<kMode, kTile, kThreads>,
                                                   cudaFuncAttributeMaxDynamicSharedMemorySize,
                                                   kSmemMax);
  return err;
}

template <int kMode, int kTile, int kThreads>
static int launch(const void* grad, const void* idx, void* out, int B, int C, int J, int S,
                  int hs2, int hs, int n, int win, int smem, int ct, cudaStream_t st) {
  const int err = allow_smem<kMode, kTile, kThreads>();
  if (err != 0) return err;
  const int tiles = (n + kTile - 1) / kTile;
  grid_backward<kMode, kTile, kThreads><<<B * tiles * tiles * tiles, kThreads, smem, st>>>(
      (const float*)grad, (const int*)idx, (float*)out, C, ct, J, S, hs2, hs, n, win);
  return launch_status();
}

// mode: 0 exact, 1 half, 2 half_fused (repro_grid_gather.py MODES); n: the
// gather grid's points per axis (G for exact, G/2 for the half modes).
// grad: float32 (B, G, G, G, J) for exact and half, (B, G/2, G/2, G/2, J)
// for half_fused; idx: int32 (B, C, n^3), K5's indices. out: float32 (B, C,
// hs2, S), 16-byte aligned, S a multiple of 4 and >= J, zeroed here, then
// the rows' gradient in its first J elements of each row. tile: gather
// points per tile edge (one of K12_TILES for the mode), or 0 for
// point_backward (exact, half_fused; win 0, smem 0); win: the window's
// pixels, below 32768 (0: every (tile, camera) takes the overflow branch); smem: the
// layout's bytes (Layout); threads: 256 or 512 a block, at least S. A block
// per (frameset, tile): B * ceil(n / tile)^3 blocks. ct: the forward's
// divisor, the rig's cameras (C, or more where each rank holds C of them).
extern "C" int repro_grid_gather_backward(const void* grad, const void* idx, void* out, int B,
                                          int C, int J, int S, int hs2, int n, int mode,
                                          int tile, int win, int smem, int threads, int ct,
                                          void* stream) {
  int hs = (int)std::lround(std::sqrt((double)hs2));
  if (hs * hs != hs2) hs = hs2;  // rows of one pixel row: the window still holds
  const long long tiles = tile > 0 ? (n + (long long)tile - 1) / tile : 1;
  if (mode < kExact || mode > kHalfFused || B < 1 || C < 1 || ct < C || J < 1 || S < J || S % 4 ||
      S > threads || n < 1 || tile < 0 || win < 0 || win >= 32768 || hs >= 32768 ||
      (size_t)out % 16 || smem > kSmemMax ||
      smem != (tile ? 4 * layout(mode, C, tile, J, S, win).total : 0) ||
      B * tiles * tiles * tiles >= (1LL << 31) ||
      (tile == 0 && (mode == kHalf || win || B > 65535 || (long long)n * n * n * S >= 1LL << 31)))
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * C * hs2 * S * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  if (tile == 0) {
    const long long work = (long long)n * n * n * (S / 4);
    const dim3 grid((unsigned)((work + threads - 1) / threads), B);
    if (threads == 256)
      point_backward<256><<<grid, 256, 0, st>>>((const float*)grad, (const int*)idx, (float*)out,
                                                C, ct, J, S, hs2, n * n * n);
    else if (threads == 512)
      point_backward<512><<<grid, 512, 0, st>>>((const float*)grad, (const int*)idx, (float*)out,
                                                C, ct, J, S, hs2, n * n * n);
    else
      return (int)cudaErrorInvalidValue;
    return launch_status();
  }
#define K12_LAUNCH(M, TL)                                                                   \
  if (mode == M && tile == TL)                                                              \
    return threads == 256                                                                   \
               ? launch<M, TL, 256>(grad, idx, out, B, C, J, S, hs2, hs, n, win, smem, ct, st)  \
               : threads == 512                                                             \
                     ? launch<M, TL, 512>(grad, idx, out, B, C, J, S, hs2, hs, n, win, smem, \
                                          ct, st)                                             \
                     : (int)cudaErrorInvalidValue;
  K12_TILES(K12_LAUNCH)
#undef K12_LAUNCH
  return (int)cudaErrorInvalidValue;
}

template <int kMode, int kTile, int kThreads>
static int occupancy(int smem, int* blocks) {
  const int err = allow_smem<kMode, kTile, kThreads>();
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      blocks, grid_backward<kMode, kTile, kThreads>, kThreads, smem);
}

// Blocks of (mode, tile, threads) with smem bytes one SM holds
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *blocks; tile 0:
// point_backward's.
extern "C" int repro_grid_backward_occupancy(int mode, int tile, int threads, int smem,
                                             int* blocks) {
  if (tile == 0 && (threads == 256 || threads == 512))
    return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks, threads == 256 ? point_backward<256> : point_backward<512>, threads, 0);
#define K12_OCC(M, TL)                                                                  \
  if (mode == M && tile == TL)                                                          \
    return threads == 256   ? occupancy<M, TL, 256>(smem, blocks)                       \
           : threads == 512 ? occupancy<M, TL, 512>(smem, blocks)                       \
                            : (int)cudaErrorInvalidValue;
  K12_TILES(K12_OCC)
#undef K12_OCC
  return (int)cudaErrorInvalidValue;
}
