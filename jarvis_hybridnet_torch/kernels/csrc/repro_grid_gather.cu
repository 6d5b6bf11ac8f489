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
// of the padded heatmaps at a data-dependent pixel, and the volume is
// written once in float32: (B, G^3, J) for exact and half, (B, (G/2)^3, J)
// for half_fused.
//
// Design: a block owns a tile of `tile`^3 points of the (G/2)^3 half grid
// of one frameset (for exact and half: the (2 tile)^3 full-grid voxels
// over it). Its shared tile holds half-grid points at the clamped global
// coordinates clamp(t0 - halo + l, 0, G/2 - 1), l = 0..tile + 2 halo - 1,
// with a one-point halo on both sides for the 0.25/0.75 stencil
// (out[2k] = 0.25 in[k-1] + 0.75 in[k], out[2k+1] = 0.75 in[k] + 0.25 in[k+1],
// both edges clamped), which makes the edge clamps plain reads. The phases:
//   project — one thread per (tile point, camera): the projection, k1/k2
//             distortion and clamp to the crop window (repro_common.cuh).
//             half / half_fused keep the flat pixel index; exact keeps the
//             (u, v) maps before the truncation;
//   index   — exact only: one thread per (full voxel, camera) upsamples u and
//             v from the shared maps along x, then y, then z in the JAX op
//             order and truncates them to the pixel index;
//   gather  — a group of J threads per voxel, the camera mean in camera
//             order (gather_means in repro_common.cuh); exact and half_fused
//             write it out, half keeps it in shared memory;
//   upsample— half only: one thread per (full voxel, joint) applies the
//             0.25/0.75 stencil to the values along x, y, z and writes; the
//             threads of a block write consecutive joints of consecutive
//             voxels.
// The rows are read in their own dtype (bf16 or f32) and summed in float32:
// a bf16 value widened to float32 is exactly the value JAX's exact mode
// gathers from its float32 cast of the same heatmaps.
// Built with --fmad=false, so the stencil rounds after every op, as the JAX
// code does.
#include "repro_common.cuh"

#define MODE_EXACT 0
#define MODE_HALF 1
#define MODE_HALF_FUSED 2

constexpr int kThreads = 512;
constexpr int kSmemMax = 232448;

// one 0.25/0.75 stencil step: lo, hi are in[a], in[a + 1] in index order and
// d the parity of the output (repro.py:62-63)
__device__ __forceinline__ float up2(float lo, float hi, int d) {
  return d ? __fadd_rn(__fmul_rn(0.75f, lo), __fmul_rn(0.25f, hi))
           : __fadd_rn(__fmul_rn(0.25f, lo), __fmul_rn(0.75f, hi));
}

// The trilinear 2x value at a full voxel from a shared tile of edge e with
// elements `stride` apart: (a, bb, cc) is the tile index of the lower input
// along x, y, z and (dx, dy, dz) the voxel's parities. The x pass runs
// first, then y, then z, as upsample_trilinear (repro.py:72-74).
__device__ __forceinline__ float up2_3d(const float* m, int e, int stride, int a, int bb, int cc,
                                        int dx, int dy, int dz) {
  auto at = [&](int i, int j, int k) { return m[((i * e + j) * e + k) * stride]; };
  auto fx = [&](int j, int k) { return up2(at(a, j, k), at(a + 1, j, k), dx); };
  auto fy = [&](int k) { return up2(fx(bb, k), fx(bb + 1, k), dy); };
  return up2(fy(cc), fy(cc + 1), dz);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    repro_grid(const T* __restrict__ rows, const int* __restrict__ center3d,
               const int* __restrict__ center_hm, const float* __restrict__ P,
               const float* __restrict__ K, const float* __restrict__ D, float* __restrict__ out,
               int* __restrict__ idx_out, int C, int J, int hs, int n2, int tile, int tiles,
               float step, int mode) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int halo = mode == MODE_HALF_FUSED ? 0 : 1;
  const int e = tile + 2 * halo, ne = e * e * e;  // shared half-grid points
  const int F = 2 * tile, nf = F * F * F;          // full-grid voxels (exact, half)
  const int G = 2 * n2;
  float* cam = reinterpret_cast<float*>(smem);  // [C][kCamFields]
  float* um = cam + C * kCamFields;             // exact: u, v maps [C][ne] each
  float* vm = um + (mode == MODE_EXACT ? C * ne : 0);
  int* idx = reinterpret_cast<int*>(vm + (mode == MODE_EXACT ? C * ne : 0));
  // half: the gathered values [ne][J] after the indices [C][ne]
  float* vals = reinterpret_cast<float*>(idx + C * (mode == MODE_EXACT ? nf : ne));

  const int b = blockIdx.y;
  const int t0x = blockIdx.x / (tiles * tiles) * tile, t0y = (blockIdx.x / tiles) % tiles * tile,
            t0z = blockIdx.x % tiles * tile;
  const int hs2 = hs * hs;

  load_cameras(cam, P, K, D, center_hm, b, C);
  __syncthreads();

  // project: pairs w = c * ne + v of the shared half-grid points
  const int mid = n2 / 2;  // index of the cube center on each axis
  const float cx3 = (float)center3d[b * 3 + 0], cy3 = (float)center3d[b * 3 + 1],
              cz3 = (float)center3d[b * 3 + 2];
  for (int w = threadIdx.x; w < C * ne; w += kThreads) {
    const int c = w / ne, v = w - c * ne;
    const int li = v / (e * e), lj = v / e % e, lk = v % e;
    const int i = min(max(t0x - halo + li, 0), n2 - 1), j = min(max(t0y - halo + lj, 0), n2 - 1),
              k = min(max(t0z - halo + lk, 0), n2 - 1);
    float u, q;
    project_uv(cam + c * kCamFields, grid_coord(i, mid, step, cx3), grid_coord(j, mid, step, cy3),
               grid_coord(k, mid, step, cz3), hs, &u, &q);
    if (mode == MODE_EXACT) {
      um[w] = u;
      vm[w] = q;
      continue;
    }
    const int pix = pixel_index(u, q, hs);
    idx[w] = pix;
    const int ai = li - halo, aj = lj - halo, ak = lk - halo;
    if (idx_out != nullptr && ai >= 0 && aj >= 0 && ak >= 0 && ai < tile && aj < tile &&
        ak < tile && t0x + ai < n2 && t0y + aj < n2 && t0z + ak < n2)
      idx_out[(size_t)(b * C + c) * n2 * n2 * n2 + (i * n2 + j) * n2 + k] = pix;
  }
  __syncthreads();

  if (mode == MODE_EXACT) {
    // index: pairs w = c * nf + f of the full voxels, from the shared maps.
    // Full voxel I = 2 (t0 + l) + d reads the tile at l + d and l + d + 1.
    const size_t nvox = (size_t)G * G * G;
    for (int w = threadIdx.x; w < C * nf; w += kThreads) {
      const int c = w / nf, f = w - c * nf;
      const int fi = f / (F * F), fj = f / F % F, fk = f % F;
      const int a = (fi + 1) >> 1, bb = (fj + 1) >> 1, cc = (fk + 1) >> 1;
      const int dx = fi & 1, dy = fj & 1, dz = fk & 1;
      const float u = up2_3d(um + c * ne, e, 1, a, bb, cc, dx, dy, dz);
      const float q = up2_3d(vm + c * ne, e, 1, a, bb, cc, dx, dy, dz);
      const int pix = pixel_index(u, q, hs);
      idx[w] = pix;
      const int I = 2 * t0x + fi, Jv = 2 * t0y + fj, Kv = 2 * t0z + fk;
      if (idx_out != nullptr && I < G && Jv < G && Kv < G)
        idx_out[(size_t)(b * C + c) * nvox + ((size_t)I * G + Jv) * G + Kv] = pix;
    }
    __syncthreads();
    float* ob = out + (size_t)b * nvox * J;
    gather_means(rows + (size_t)b * C * hs2 * J, idx, nf, C, J, hs2, kThreads,
                 [&](int f, int jj, float m) {
                   const int I = 2 * t0x + f / (F * F), Jv = 2 * t0y + f / F % F,
                             Kv = 2 * t0z + f % F;
                   if (I < G && Jv < G && Kv < G) ob[(((size_t)I * G + Jv) * G + Kv) * J + jj] = m;
                 });
    return;
  }

  const T* rb = rows + (size_t)b * C * hs2 * J;
  if (mode == MODE_HALF_FUSED) {
    float* ob = out + (size_t)b * n2 * n2 * n2 * J;
    gather_means(rb, idx, ne, C, J, hs2, kThreads, [&](int v, int jj, float m) {
      const int i = t0x + v / (e * e), j = t0y + v / e % e, k = t0z + v % e;
      if (i < n2 && j < n2 && k < n2) ob[(((size_t)i * n2 + j) * n2 + k) * J + jj] = m;
    });
    return;
  }

  // half: values of the shared tile, then the upsample to the full grid
  gather_means(rb, idx, ne, C, J, hs2, kThreads,
               [&](int v, int jj, float m) { vals[v * J + jj] = m; });
  __syncthreads();
  float* ob = out + (size_t)b * G * G * G * J;
  const int fx_n = min(F, G - 2 * t0x), fy_n = min(F, G - 2 * t0y), fz_n = min(F, G - 2 * t0z);
  const int row = fz_n * J;  // (z, joint) pairs of one full-grid (x, y) row
  for (int w = threadIdx.x; w < fx_n * fy_n * row; w += kThreads) {
    const int xy = w / row, r = w - xy * row;
    const int fi = xy / fy_n, fj = xy - fi * fy_n, fk = r / J, jj = r - fk * J;
    const float m = up2_3d(vals + jj, e, J, (fi + 1) >> 1, (fj + 1) >> 1, (fk + 1) >> 1, fi & 1,
                           fj & 1, fk & 1);
    ob[(((size_t)(2 * t0x + fi) * G + 2 * t0y + fj) * G + 2 * t0z + fk) * J + jj] = m;
  }
}

static size_t smem_bytes(int C, int J, int tile, int mode) {
  const int halo = mode == MODE_HALF_FUSED ? 0 : 1;
  const size_t e = tile + 2 * halo, ne = e * e * e, nf = (size_t)8 * tile * tile * tile;
  size_t words = (size_t)C * kCamFields;
  if (mode == MODE_EXACT) words += 2 * C * ne + C * nf;
  else words += C * ne + (mode == MODE_HALF ? ne * J : 0);
  return words * 4;
}

template <typename T>
static int launch(const void* rows, const void* center3d, const void* center_hm, const void* P,
                  const void* K, const void* D, void* out, void* idx_out, int B, int C, int J,
                  int hs, int n2, int tile, float step, int mode, cudaStream_t st) {
  static bool ready = false;  // the function attribute, set once per instantiation
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(repro_grid<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int tiles = (n2 + tile - 1) / tile;
  const size_t smem = smem_bytes(C, J, tile, mode);
  if (smem > (size_t)kSmemMax || mode < MODE_EXACT || mode > MODE_HALF_FUSED)
    return (int)cudaErrorInvalidValue;
  repro_grid<T><<<dim3(tiles * tiles * tiles, B), kThreads, smem, st>>>(
      (const T*)rows, (const int*)center3d, (const int*)center_hm, (const float*)P,
      (const float*)K, (const float*)D, (float*)out, (int*)idx_out, C, J, hs, n2, tile, tiles, step,
      mode);
  return launch_status();
}

// rows: (B, C, hs*hs, J) heatmap rows; center3d (B, 3) int32; center_hm
// (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5) float32.
// n2: half-grid points per axis (G / 2); step: their spacing in mm (twice
// the grid spacing); tile: half-grid points per tile edge; mode: 0 exact,
// 1 half, 2 half_fused. out: float32 (B, G^3, J), or (B, n2^3, J) for
// half_fused. idx_out: null, or int32 (B, C, G^3) for exact, (B, C, n2^3)
// otherwise, to receive the gather indices.
extern "C" int repro_grid_gather(const void* rows, const void* center3d, const void* center_hm,
                                 const void* P, const void* K, const void* D, void* out,
                                 void* idx_out, int B, int C, int J, int hs, int n2, int tile,
                                 float step, int mode, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs,
                                 n2, tile, step, mode, st);
  return launch<float>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs, n2, tile,
                       step, mode, st);
}
