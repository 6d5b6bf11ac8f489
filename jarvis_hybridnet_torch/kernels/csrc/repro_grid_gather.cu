// K5 repro_grid_gather: the exact, half and half_fused voxel reprojection
// modes, one launch per call.
//
// Replaces: models/repro.py reprojection_layer's exact mode (repro.py:266-273:
// reproject_indices with the trilinear index upsample, :94-154, and
// gather_voxel_volume, :157) and its half / half_fused modes (:302-317:
// reproject_indices(upsample=False), gather_voxel_volume and, for half, the
// three _upsample2_axis value passes, :47-66).
//
// Bound on the H100: bytes. Each (frameset, voxel, camera) reads one J-row
// of the heatmaps at a data-dependent pixel, and the volume is written once
// in float32: (B, G^3, J) for exact and half, (B, (G/2)^3, J) for
// half_fused. The row reads come from L2 (one frameset's rows are ~10 MB),
// so their number and width, not the distinct bytes, set the time.
//
// Design:
// - Rows padded to 16 bytes. The rows are a (B, C, hs*hs, J) view of a
//   buffer whose rows are S >= J elements apart, S * itemsize a multiple of
//   16 (heatmap_rows pads J = 23 to 24). A row is read as L = ceil(J / V)
//   16-byte loads of V = 16 / itemsize joints.
// - A block of 256 threads per (frameset, tile) work item, up to 4 blocks
//   per SM (<= 64 registers; the shared memory of the larger tiles allows
//   3). The blocks of an SM run in different phases, so one block's
//   projection and index passes overlap another's row loads (a persistent
//   grid walking the items measured no faster: kernel_sweep.py, PERF.md).
// - A work item is a tile of TILE^3 points of the (G/2)^3 half grid (a
//   compile-time edge, K5_TILES below). Its shared tile holds the half-grid
//   points at the clamped coordinates clamp(t0 - halo + l, 0, G/2 - 1),
//   with a one-point halo on both sides for the 0.25/0.75 stencil
//   (out[2k] = 0.25 in[k-1] + 0.75 in[k], out[2k+1] = 0.75 in[k] +
//   0.25 in[k+1], both edges clamped), so the edge clamps are plain reads.
//   Phases:
//   project — one thread per (camera, shared point): the projection, k1/k2
//             distortion and clamp to the crop window (repro_common.cuh);
//             the half modes keep the flat pixel index, exact the (u, v)
//             maps before the truncation;
//   index   — exact only: the (u, v) maps upsampled by three separable
//             passes in shared memory, x into (2T, e, e), then y into
//             (2T, 2T, e), then z with the truncation to the pixel index.
//             Each pass applies the JAX op to the same inputs as the
//             per-voxel stencil does, so the indices are bit-identical;
//   gather  — rounds of whole z-rows of points; a thread holds KT
//             (point, lane) tasks and loops over the cameras in order, so
//             the block reads one camera's window of rows at a time (rows
//             that neighbouring voxels share come from L1), and adds each
//             camera's V joints into float32 sums in camera order 0..C-1,
//             then divides by C (gather_voxel_volume, repro.py:206-213);
//   write   — exact and half_fused stage a round's means in shared memory
//             and copy them to the volume a warp per z-row, consecutive
//             lanes on consecutive floats; half keeps the half-grid means
//             and upsamples them one full-grid x-slab at a time: the y pass
//             (x computed on the fly, x before y) into a double-buffered
//             slab, the z pass straight to the volume, coalesced.
// The rows are read in their own dtype (bf16 or f32) and summed in float32:
// a bf16 value widened to float32 is exactly the value JAX's exact mode
// gathers from its float32 cast of the same heatmaps.
// Built with --fmad=false, so the stencil rounds after every op, as the JAX
// code does.
#include "repro_common.cuh"

#define MODE_EXACT 0
#define MODE_HALF 1
#define MODE_HALF_FUSED 2

// the (mode, tile edge) pairs compiled; kernel_sweep.py times each
#define K5_TILES(X)                                                                   \
  X(MODE_EXACT, 3) X(MODE_EXACT, 4) X(MODE_HALF, 4) X(MODE_HALF, 6) X(MODE_HALF_FUSED, 6) \
  X(MODE_HALF_FUSED, 8)

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 4;  // blocks per SM the register cap (64) allows
constexpr int kSmemMax = 232448;

// gather tasks a thread holds per round: 24 float sums of bf16 rows, 16 of f32
template <typename T>
struct Row;
template <>
struct Row<__nv_bfloat16> {
  static constexpr int V = 8, KT = 3;
  // bf16 2i is the low half of word i; widening is a 16-bit shift
  static __device__ __forceinline__ void add(float* acc, uint4 r) {
    const unsigned w[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      acc[2 * i] = __fadd_rn(acc[2 * i], __uint_as_float(w[i] << 16));
      acc[2 * i + 1] = __fadd_rn(acc[2 * i + 1], __uint_as_float(w[i] & 0xffff0000u));
    }
  }
};
template <>
struct Row<float> {
  static constexpr int V = 4, KT = 4;
  static __device__ __forceinline__ void add(float* acc, uint4 r) {
    acc[0] = __fadd_rn(acc[0], __uint_as_float(r.x));
    acc[1] = __fadd_rn(acc[1], __uint_as_float(r.y));
    acc[2] = __fadd_rn(acc[2], __uint_as_float(r.z));
    acc[3] = __fadd_rn(acc[3], __uint_as_float(r.w));
  }
};

// one 0.25/0.75 stencil step: lo, hi are in[a], in[a + 1] in index order and
// d the parity of the output (repro.py:62-63)
__device__ __forceinline__ float up2(float lo, float hi, int d) {
  return d ? __fadd_rn(__fmul_rn(0.75f, lo), __fmul_rn(0.25f, hi))
           : __fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.75f, hi));
}

// The geometry of a tile of TILE^3 half-grid points in MODE.
template <int MODE, int TILE>
struct Tile {
  static constexpr int halo = MODE == MODE_HALF_FUSED ? 0 : 1;
  static constexpr int e = TILE + 2 * halo;  // shared half-grid points per edge
  static constexpr int ne = e * e * e;
  static constexpr int F = MODE == MODE_HALF_FUSED ? TILE : 2 * TILE;  // output points per edge
  static constexpr int np = MODE == MODE_EXACT ? F * F * F : ne;       // gathered points
  static constexpr int row = MODE == MODE_HALF ? 1 : F;  // a round holds whole rows of these
};

__host__ __device__ constexpr int rup4(int w) { return (w + 3) / 4 * 4; }
__host__ __device__ constexpr int imax(int a, int b) { return a > b ? a : b; }

// Points per gather round: whole rows, at most the tasks the block holds.
template <int MODE, int TILE>
__host__ __device__ int round_points(int L, int KT) {
  using G = Tile<MODE, TILE>;
  const int fit = kThreads * KT / L / G::row * G::row;
  return fit < G::np ? fit : G::np;
}

// Shared memory in 4-byte words: the camera fields, then regions A and B.
//   exact:      A the (u, v) maps, then the y pass, then a round's means;
//               B the x pass, then the index tile
//   half:       A the index tile, then the two y slabs; B the half-grid means
//   half_fused: A the index tile; B a round's means
struct Layout {
  int a, b, total;
};
template <int MODE, int TILE>
__host__ __device__ Layout layout(int C, int J, int L, int KT) {
  using G = Tile<MODE, TILE>;
  const int cam = rup4(C * kCamFields), rp = round_points<MODE, TILE>(L, KT);
  int A, Bw;
  if (MODE == MODE_EXACT) {
    A = imax(imax(2 * C * G::ne, 2 * C * G::F * G::F * G::e), rp * J);
    Bw = imax(2 * C * G::F * G::e * G::e, C * G::np);
  } else if (MODE == MODE_HALF) {
    A = imax(C * G::ne, 2 * G::F * G::e * J);
    Bw = G::ne * J;
  } else {
    A = C * G::ne;
    Bw = rp * J;
  }
  return {cam, cam + rup4(A), cam + rup4(A) + rup4(Bw)};
}

// project (and, for exact, the separable index upsample): the tile's pixel
// indices into idx[c * np + p]; idx_out receives the owned points' indices
template <int MODE, int TILE>
__device__ __forceinline__ void tile_indices(float* smem, Layout lay, const int* __restrict__ center3d,
                                             int* __restrict__ idx_out, int b, int C, int hs, int n2,
                                             float step, int t0x, int t0y, int t0z) {
  using G = Tile<MODE, TILE>;
  constexpr int e = G::e, e2 = e * e, ne = G::ne, F = G::F, halo = G::halo;
  const float* cam = smem;
  float2* uv = reinterpret_cast<float2*>(smem + lay.a);
  int* idx = reinterpret_cast<int*>(smem + (MODE == MODE_EXACT ? lay.b : lay.a));
  const int mid = n2 / 2;  // index of the cube center on each axis
  const float cx3 = (float)center3d[b * 3 + 0], cy3 = (float)center3d[b * 3 + 1],
              cz3 = (float)center3d[b * 3 + 2];
  for (int w = threadIdx.x; w < C * ne; w += kThreads) {
    const int c = w / ne, v = w - c * ne;
    const int li = v / e2, lj = v / e % e, lk = v % e;
    const int i = min(max(t0x - halo + li, 0), n2 - 1), j = min(max(t0y - halo + lj, 0), n2 - 1),
              k = min(max(t0z - halo + lk, 0), n2 - 1);
    float u, q;
    project_uv(cam + c * kCamFields, grid_coord(i, mid, step, cx3), grid_coord(j, mid, step, cy3),
               grid_coord(k, mid, step, cz3), hs, &u, &q);
    if (MODE == MODE_EXACT) {
      uv[w] = make_float2(u, q);
      continue;
    }
    const int pix = pixel_index(u, q, hs);
    idx[w] = pix;
    const int ai = li - halo, aj = lj - halo, ak = lk - halo;
    if (idx_out != nullptr && ai >= 0 && aj >= 0 && ak >= 0 && ai < TILE && aj < TILE &&
        ak < TILE && t0x + ai < n2 && t0y + aj < n2 && t0z + ak < n2)
      idx_out[(size_t)(b * C + c) * n2 * n2 * n2 + (i * n2 + j) * n2 + k] = pix;
  }
  if (MODE != MODE_EXACT) return;
  __syncthreads();
  // x pass: (c, fi, lj, lk), into B. Full voxel 2 (t0 + l) + d reads the
  // tile at a = l + d and a + 1.
  float2* xp = reinterpret_cast<float2*>(smem + lay.b);
  for (int w = threadIdx.x; w < C * F * e2; w += kThreads) {
    const int s = w / e2, q = w - s * e2;  // s = c F + fi
    const int c = s / F, fi = s - c * F;
    const int a = (fi + 1) >> 1, d = fi & 1;
    const float2 lo = uv[(c * e + a) * e2 + q], hi = uv[(c * e + a + 1) * e2 + q];
    xp[w] = make_float2(up2(lo.x, hi.x, d), up2(lo.y, hi.y, d));
  }
  __syncthreads();
  // y pass: (c, fi, fj, lk), into A (the maps are no longer read)
  float2* yp = uv;
  for (int w = threadIdx.x; w < C * F * F * e; w += kThreads) {
    const int s = w / e, lk = w - s * e;  // s = (c F + fi) F + fj
    const int cf = s / F, fj = s - cf * F;
    const int bb = (fj + 1) >> 1, d = fj & 1;
    const float2 lo = xp[(cf * e + bb) * e + lk], hi = xp[(cf * e + bb + 1) * e + lk];
    yp[w] = make_float2(up2(lo.x, hi.x, d), up2(lo.y, hi.y, d));
  }
  __syncthreads();
  // z pass and truncation: (c, fi, fj, fk) = c F^3 + f, into B (the x pass
  // is no longer read)
  const int G2 = 2 * n2;
  for (int w = threadIdx.x; w < C * F * F * F; w += kThreads) {
    const int s = w / F, fk = w - s * F;
    const int cc = (fk + 1) >> 1, d = fk & 1;
    const float2 lo = yp[s * e + cc], hi = yp[s * e + cc + 1];
    const int pix = pixel_index(up2(lo.x, hi.x, d), up2(lo.y, hi.y, d), hs);
    idx[w] = pix;
    if (idx_out != nullptr) {
      const int c = w / (F * F * F), fi = s / F % F, fj = s % F;
      const int I = 2 * t0x + fi, Jv = 2 * t0y + fj, Kv = 2 * t0z + fk;
      if (I < G2 && Jv < G2 && Kv < G2)
        idx_out[(size_t)(b * C + c) * G2 * G2 * G2 + ((size_t)I * G2 + Jv) * G2 + Kv] = pix;
    }
  }
}

// The camera means of points [p0, p1): stage[(p - sbase) * J + joint].
template <typename T, int NP>
__device__ __forceinline__ void gather_round(const T* __restrict__ rb, const int* idx, float* stage,
                                             int C, int ct, int J, int S, int L, int cstride,
                                             int p0, int p1, int sbase) {
  constexpr int V = Row<T>::V, KT = Row<T>::KT;
  const int q1 = (p1 - p0) * L;
  int pt[KT], lane[KT];
  float acc[KT][V];
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    const int q = k * kThreads + threadIdx.x, p = q / L;
    pt[k] = q < q1 ? p0 + p : -1;
    lane[k] = (q - p * L) * V;
#pragma unroll
    for (int i = 0; i < V; ++i) acc[k][i] = 0.f;
  }
  if (pt[0] < 0) return;  // the thread has no task in this round
  for (int c = 0; c < C; ++c) {
    const T* rc = rb + c * cstride;
    const int* ic = idx + c * NP;
    uint4 raw[KT];
#pragma unroll
    for (int k = 0; k < KT; ++k)
      raw[k] = pt[k] >= 0 ? __ldg(reinterpret_cast<const uint4*>(rc + ic[pt[k]] * S + lane[k]))
                          : make_uint4(0u, 0u, 0u, 0u);
#pragma unroll
    for (int k = 0; k < KT; ++k) Row<T>::add(acc[k], raw[k]);
  }
#pragma unroll
  for (int k = 0; k < KT; ++k) {
    if (pt[k] < 0) continue;
    float* s = stage + (pt[k] - sbase) * J + lane[k];
    // a zero sum (rows of the zero border) skips the division's slow path
#pragma unroll
    for (int i = 0; i < V; ++i)
      if (lane[k] + i < J) s[i] = acc[k][i] == 0.f ? 0.f : __fdiv_rn(acc[k][i], (float)ct);
  }
}

// Copy the staged means of points [p0, p1) (whole z-rows of F points of the
// tile starting at output point (x0, y0, z0) of an n^3 volume) to ob: a
// warp per row, consecutive lanes on consecutive floats, 16 bytes a lane
// where the volume's and the stage's rows start on 16 bytes (n J and
// z0 J multiples of 4, F J a multiple of 4: exact at even tile edges).
template <int F>
__device__ __forceinline__ void write_rows(const float* stage, float* __restrict__ ob, int J, int n,
                                           int x0, int y0, int z0, int p0, int p1) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int len = min(F, n - z0) * J;
  const bool vec = (n * J) % 4 == 0 && (z0 * J) % 4 == 0 && (F * J) % 4 == 0 && len % 4 == 0;
  for (int r = p0 / F + warp; r < p1 / F; r += kWarps) {
    const int fi = r / F, fj = r - fi * F;
    if (x0 + fi >= n || y0 + fj >= n) continue;
    float* o = ob + ((size_t)((x0 + fi) * n + y0 + fj) * n + z0) * J;
    const float* s = stage + (r * F - p0) * J;
    if (vec) {
      for (int i = lane; i < len / 4; i += 32)
        reinterpret_cast<float4*>(o)[i] = reinterpret_cast<const float4*>(s)[i];
    } else {
      for (int i = lane; i < len; i += 32) o[i] = s[i];
    }
  }
}

// half: the 2x value upsample of the shared half-grid means vals[(li, lj,
// lk)][joint] (edge e = TILE + 2) to the full-grid tile at (x0, y0, z0),
// one x-slab at a time, x then y then z as upsample_trilinear; a warp per
// full-grid (fi, fj) row.
template <int TILE>
__device__ __forceinline__ void upsample_write(const float* vals, float* ybuf,
                                               float* __restrict__ ob, int J, int G, int x0, int y0,
                                               int z0) {
  constexpr int e = TILE + 2, F = 2 * TILE;
  const int eJ = e * J;
  const int fx_n = min(F, G - x0), fy_n = min(F, G - y0), fz_n = min(F, G - z0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int k0 = lane / J, j0 = lane - k0 * J;
  for (int fi = 0; fi < fx_n; ++fi) {
    float* Y = ybuf + (fi & 1) * F * eJ;
    const int a = (fi + 1) >> 1, dx = fi & 1;
    // y pass: Y[fj][lk * J + joint], x on the fly from rows a and a + 1
    for (int fj = warp; fj < fy_n; fj += kWarps) {
      const int bb = (fj + 1) >> 1, dy = fj & 1;
      const float* v0 = vals + (a * e + bb) * eJ;
      const float* v1 = vals + ((a + 1) * e + bb) * eJ;
      for (int r = lane; r < eJ; r += 32)
        Y[fj * eJ + r] = up2(up2(v0[r], v1[r], dx), up2(v0[r + eJ], v1[r + eJ], dx), dy);
    }
    __syncthreads();  // slab fi is complete; slab fi - 1's buffer is free
    // z pass: the full-grid row (fi, fj) straight to the volume
    for (int fj = warp; fj < fy_n; fj += kWarps) {
      const float* y = Y + fj * eJ;
      float* o = ob + ((size_t)((x0 + fi) * G + y0 + fj) * G + z0) * J;
      int fk = k0, j = j0;
      for (int r = lane; r < fz_n * J; r += 32) {
        const int cc = (fk + 1) >> 1;
        o[r] = up2(y[cc * J + j], y[(cc + 1) * J + j], fk & 1);
        for (j += 32; j >= J; j -= J) ++fk;
      }
    }
  }
}

template <typename T, int MODE, int TILE>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    repro_grid(const T* __restrict__ rows, const int* __restrict__ center3d,
               const int* __restrict__ center_hm, const float* __restrict__ P,
               const float* __restrict__ K, const float* __restrict__ D, float* __restrict__ out,
               int* __restrict__ idx_out, int C, int ct, int J, int S, int hs, int n2,
               float step) {
  using G = Tile<MODE, TILE>;
  extern __shared__ __align__(16) float smem[];
  const int L = (J + Row<T>::V - 1) / Row<T>::V;
  const Layout lay = layout<MODE, TILE>(C, J, L, Row<T>::KT);
  const int rp = round_points<MODE, TILE>(L, Row<T>::KT);
  const int tiles = (n2 + TILE - 1) / TILE, per_b = tiles * tiles * tiles;
  const int cstride = hs * hs * S, Gf = 2 * n2;
  const int* idx = reinterpret_cast<const int*>(smem + (MODE == MODE_EXACT ? lay.b : lay.a));
  // where a round's means go: exact A, half and half_fused B
  float* stage = smem + (MODE == MODE_EXACT ? lay.a : lay.b);
  const int b = blockIdx.x / per_b, t = blockIdx.x - b * per_b;
  const int t0x = t / (tiles * tiles) * TILE, t0y = t / tiles % tiles * TILE,
            t0z = t % tiles * TILE;
  load_cameras(smem, P, K, D, center_hm, b, C);
  __syncthreads();
  tile_indices<MODE, TILE>(smem, lay, center3d, idx_out, b, C, hs, n2, step, t0x, t0y, t0z);
  __syncthreads();
  const T* rb = rows + (size_t)b * C * cstride;
  for (int p0 = 0; p0 < G::np; p0 += rp) {
    const int p1 = min(p0 + rp, G::np);
    gather_round<T, G::np>(rb, idx, stage, C, ct, J, S, L, cstride, p0, p1,
                           MODE == MODE_HALF ? 0 : p0);
    if (MODE == MODE_HALF) continue;
    __syncthreads();
    if (MODE == MODE_EXACT)
      write_rows<G::F>(stage, out + (size_t)b * Gf * Gf * Gf * J, J, Gf, 2 * t0x, 2 * t0y, 2 * t0z,
                       p0, p1);
    else
      write_rows<G::F>(stage, out + (size_t)b * n2 * n2 * n2 * J, J, n2, t0x, t0y, t0z, p0, p1);
    if (p1 < G::np) __syncthreads();
  }
  if (MODE == MODE_HALF) {
    __syncthreads();
    upsample_write<TILE>(stage, smem + lay.a, out + (size_t)b * Gf * Gf * Gf * J, J, Gf, 2 * t0x,
                         2 * t0y, 2 * t0z);
  }
}

template <typename T, int MODE, int TILE>
static int smem_words(int C, int J) {
  const int L = (J + Row<T>::V - 1) / Row<T>::V;
  return round_points<MODE, TILE>(L, Row<T>::KT) < 1 ? -1
                                                       : layout<MODE, TILE>(C, J, L, Row<T>::KT).total;
}

// lets the instantiation use up to kSmemMax bytes of shared memory (once)
template <typename T, int MODE, int TILE>
static int allow_smem() {
  static const int err = (int)cudaFuncSetAttribute(
      repro_grid<T, MODE, TILE>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
  return err;
}

template <typename T, int MODE, int TILE>
static int launch(const void* rows, const void* center3d, const void* center_hm, const void* P,
                  const void* K, const void* D, void* out, void* idx_out, int B, int C, int ct,
                  int J, int S, int hs, int n2, float step, int smem, cudaStream_t st) {
  const int err = allow_smem<T, MODE, TILE>();
  if (err != 0) return err;
  const int words = smem_words<T, MODE, TILE>(C, J);
  const int tiles = (n2 + TILE - 1) / TILE;
  if (words < 0 || smem != 4 * words || smem > kSmemMax || B < 1 || ct < C ||
      (S * (int)sizeof(T)) % 16 != 0 || S < J)
    return (int)cudaErrorInvalidValue;
  repro_grid<T, MODE, TILE><<<B * tiles * tiles * tiles, kThreads, smem, st>>>(
      (const T*)rows, (const int*)center3d, (const int*)center_hm, (const float*)P,
      (const float*)K, (const float*)D, (float*)out, (int*)idx_out, C, ct, J, S, hs, n2, step);
  return launch_status();
}

template <typename T>
static int dispatch(const void* rows, const void* center3d, const void* center_hm, const void* P,
                    const void* K, const void* D, void* out, void* idx_out, int B, int C, int ct,
                    int J, int S, int hs, int n2, int tile, float step, int mode, int smem,
                    cudaStream_t st) {
#define K5_LAUNCH(M, TL)                                                                      \
  if (mode == M && tile == TL)                                                                \
    return launch<T, M, TL>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, ct, J, S, \
                            hs, n2, step, smem, st);
  K5_TILES(K5_LAUNCH)
#undef K5_LAUNCH
  return (int)cudaErrorInvalidValue;
}

// rows: (B, C, hs*hs, J) heatmap rows S elements apart (S * itemsize a
// multiple of 16, the buffer 16-byte aligned); center3d (B, 3) int32;
// center_hm (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5)
// float32. n2: half-grid points per axis (G / 2); step: their spacing in mm
// (twice the grid spacing); tile: half-grid points per tile edge (one of
// K5_TILES); mode: 0 exact, 1 half, 2 half_fused; smem: the bytes of
// shared memory (Layout). A block per (frameset, tile): B * ceil(n2 /
// tile)^3 blocks. out: float32 (B, G^3, J), or (B, n2^3, J) for
// half_fused. idx_out: null, or int32 (B, C, G^3) for exact, (B, C, n2^3)
// otherwise, to receive the gather indices. ct: the camera sum's divisor,
// the rig's cameras (C, or more where each rank holds C of them).
extern "C" int repro_grid_gather(const void* rows, const void* center3d, const void* center_hm,
                                 const void* P, const void* K, const void* D, void* out,
                                 void* idx_out, int B, int C, int J, int S, int hs, int n2,
                                 int tile, float step, int mode, int smem, int dtype, int ct,
                                 void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return dispatch<__nv_bfloat16>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, ct, J,
                                   S, hs, n2, tile, step, mode, smem, st);
  return dispatch<float>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, ct, J, S, hs, n2,
                         tile, step, mode, smem, st);
}

template <typename T, int MODE, int TILE>
static int occupancy(int smem, int* n) {
  const int err = allow_smem<T, MODE, TILE>();
  if (err != 0) return err;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(n, repro_grid<T, MODE, TILE>, kThreads,
                                                            smem);
}

// Blocks of (mode, tile, dtype) with smem bytes the card holds on one SM
// (cudaOccupancyMaxActiveBlocksPerMultiprocessor), into *n.
extern "C" int repro_grid_occupancy(int mode, int tile, int smem, int dtype, int* n) {
#define K5_OCC(M, TL)                                                                \
  if (mode == M && tile == TL) return dtype == DTYPE_BF16 ? occupancy<__nv_bfloat16, M, TL>(smem, n) \
                                                          : occupancy<float, M, TL>(smem, n);
  K5_TILES(K5_OCC)
#undef K5_OCC
  return (int)cudaErrorInvalidValue;
}
