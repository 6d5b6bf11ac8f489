// K2 repro_quarter_gather: the quarter_fused voxel reprojection, one launch.
//
// Replaces: models/repro.py reproject_indices(upsample=False) called with
// (grid_size // 2, 2 * grid_spacing) (repro.py:288-293), gather_voxel_volume
// (:157) and _upsample2_aligned_axis x3 (:297-299).
//
// Bound on the H100: bytes, and most of them scattered. Each (frameset,
// quarter voxel, camera) reads one J-row of the padded heatmaps at a
// data-dependent pixel; the half-grid volume is written once in float32.
//
// Design: a block owns a tile of `tile`^3 quarter voxels of one frameset and
// writes the matching (2 tile)^3 tile of the half grid. The upsample stencil
// reads in[min(k + 1, L - 1)], so the block also computes a one-voxel halo on
// the high side; its shared tile holds quarter voxels at the clamped global
// coordinates min(t0 + i, g4 - 1), i = 0..tile, which makes the top-edge
// clamp a plain read of the next entry. Halo voxels are recomputed by the
// neighbouring block; their heatmap rows come from L2. Three phases, each
// thread finding its place once, with no integer division in the loops:
//   index   — one thread per (tile voxel, camera): the projection, k1/k2
//             distortion, clamp to the crop window and flat pixel index,
//             computed once and kept in shared memory;
//   gather  — a group of J threads per tile voxel, one per joint, two voxels
//             at a time (gather_means in repro_common.cuh): the sums add in
//             camera order 0..C-1 and divide by C;
//   upsample— a group of threads per half-grid (X, Y) row, one per (z, joint):
//             the center-aligned 2x stencil along x, then y, then z in the
//             reference's op order, from the shared tile, with 32-bit index
//             arithmetic; each thread writes two z-neighbours, and
//             consecutive threads write consecutive joints.
// The index arithmetic (repro_common.cuh, shared with K5) rounds after every
// op in the JAX op order, and the file is built with --fmad=false.
#include "repro_common.cuh"

constexpr int kThreads = 512;
constexpr int kSmemMax = 232448;

template <typename T>
__global__ void __launch_bounds__(kThreads)
    repro_tile(const T* __restrict__ rows, const int* __restrict__ center3d,
               const int* __restrict__ center_hm, const float* __restrict__ P,
               const float* __restrict__ K, const float* __restrict__ D, float* __restrict__ out,
               int* __restrict__ idx_out, int C, int J, int S, int hs, int g4, int tile,
               int tiles, float step) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int e = tile + 1;  // tile edge with the halo
  const int ne = e * e * e;
  float* quarter = reinterpret_cast<float*>(smem);      // [ne][J]
  int* idx = reinterpret_cast<int*>(quarter + ne * J);  // [C][ne]
  int* vox = idx + C * ne;                              // [ne]: li | lj << 10 | lk << 20
  float* cam = reinterpret_cast<float*>(vox + ne);      // [C][kCamFields]

  const int b = blockIdx.y;
  const int tx = blockIdx.x / (tiles * tiles), ty = (blockIdx.x / tiles) % tiles,
            tz = blockIdx.x % tiles;
  const int x0 = tx * tile, y0 = ty * tile, z0 = tz * tile;
  const int hs2 = hs * hs, nvox = g4 * g4 * g4;

  load_cameras(cam, P, K, D, center_hm, b, C);
  for (int v = threadIdx.x; v < ne; v += kThreads)
    vox[v] = v / (e * e) | ((v / e) % e) << 10 | (v % e) << 20;
  __syncthreads();

  // index phase (repro.py:107-153), pairs w = c * ne + v
  const int mid = g4 / 2;  // index of the cube center on each axis
  const float cx3 = (float)center3d[b * 3 + 0], cy3 = (float)center3d[b * 3 + 1],
              cz3 = (float)center3d[b * 3 + 2];
  for (int w = threadIdx.x, c = w / ne, v = w - c * ne; w < C * ne; w += kThreads) {
    const int li = vox[v] & 1023, lj = vox[v] >> 10 & 1023, lk = vox[v] >> 20;
    const int i = min(x0 + li, g4 - 1), j = min(y0 + lj, g4 - 1), k = min(z0 + lk, g4 - 1);
    float u, q;
    project_uv(cam + c * kCamFields, grid_coord(i, mid, step, cx3), grid_coord(j, mid, step, cy3),
               grid_coord(k, mid, step, cz3), hs, &u, &q);
    const int pix = pixel_index(u, q, hs);
    idx[w] = pix;
    if (idx_out != nullptr && li < tile && lj < tile && lk < tile && x0 + li < g4 &&
        y0 + lj < g4 && z0 + lk < g4)
      idx_out[(size_t)(b * C + c) * nvox + (i * g4 + j) * g4 + k] = pix;
    for (v += kThreads; v >= ne; v -= ne) ++c;
  }
  __syncthreads();

  // gather phase: camera mean of the J-rows at the indices
  gather_means(rows + (size_t)b * C * hs2 * S, idx, ne, C, J, S, hs2, kThreads,
               [&](int v, int jj, float m) { quarter[v * J + jj] = m; });
  __syncthreads();

  // upsample phase: out[2k] = in[k], out[2k+1] = 0.5 * (in[k] + in[min(k+1, L-1)])
  const int nx = min(tile, g4 - x0), ny = min(tile, g4 - y0), nz = min(tile, g4 - z0);
  const int g2 = 2 * g4;
  const int row_tasks = nz * J;  // (z, joint) pairs of one half-grid (X, Y) row
  const int row_groups = kThreads / row_tasks;
  if ((int)threadIdx.x >= row_groups * row_tasks) return;
  const int g = threadIdx.x / row_tasks, rz = threadIdx.x % row_tasks;
  const int lz = rz / J, jj = rz % J;
  float* ob = out + (size_t)b * g2 * g2 * g2 * J + jj;
  auto at = [&](int a, int bb, int cc) { return quarter[((a * e + bb) * e + cc) * J + jj]; };
  for (int p = g, Xl = g / (2 * ny), Yl = g % (2 * ny); p < 4 * nx * ny; p += row_groups) {
    const int lx = Xl >> 1, dx = Xl & 1, ly = Yl >> 1, dy = Yl & 1;
    auto fxv = [&](int y, int z) {
      return dx ? __fmul_rn(0.5f, __fadd_rn(at(lx, y, z), at(lx + 1, y, z))) : at(lx, y, z);
    };
    auto fyv = [&](int z) {
      return dy ? __fmul_rn(0.5f, __fadd_rn(fxv(ly, z), fxv(ly + 1, z))) : fxv(ly, z);
    };
    const float a0 = fyv(lz), a1 = fyv(lz + 1);
    const int X = 2 * x0 + Xl, Y = 2 * y0 + Yl, Z = 2 * (z0 + lz);
    float* o = ob + ((X * g2 + Y) * g2 + Z) * J;
    o[0] = a0;
    o[J] = __fmul_rn(0.5f, __fadd_rn(a0, a1));
    for (Yl += row_groups; Yl >= 2 * ny; Yl -= 2 * ny) ++Xl;
  }
}

static size_t smem_bytes(int C, int J, int tile) {
  const size_t ne = (size_t)(tile + 1) * (tile + 1) * (tile + 1);
  return (ne * J + ne * C + ne + (size_t)C * kCamFields) * 4;
}

template <typename T>
static int launch(const void* rows, const void* center3d, const void* center_hm, const void* P,
                  const void* K, const void* D, void* out, void* idx_out, int B, int C, int J,
                  int S, int hs, int g4, int tile, float step, cudaStream_t st) {
  static bool ready = false;  // the function attribute, set once per instantiation
  if (!ready) {
    const cudaError_t e =
        cudaFuncSetAttribute(repro_tile<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemMax);
    if (e != cudaSuccess) return (int)e;
    ready = true;
  }
  const int tiles = (g4 + tile - 1) / tile;
  const size_t smem = smem_bytes(C, J, tile);
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  repro_tile<T><<<dim3(tiles * tiles * tiles, B), kThreads, smem, st>>>(
      (const T*)rows, (const int*)center3d, (const int*)center_hm, (const float*)P,
      (const float*)K, (const float*)D, (float*)out, (int*)idx_out, C, J, S, hs, g4, tile, tiles,
      step);
  return launch_status();
}

// rows: (B, C, hs*hs, J) heatmap rows S >= J elements apart; center3d (B, 3) int32; center_hm
// (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5) float32.
// out: float32 (B, 2g4, 2g4, 2g4, J); idx_out: null, or int32 (B, C, g4^3)
// to receive the gather indices. tile: quarter voxels per tile edge.
extern "C" int repro_quarter_gather(const void* rows, const void* center3d,
                                    const void* center_hm, const void* P, const void* K,
                                    const void* D, void* out, void* idx_out, int B, int C, int J,
                                    int S, int hs, int g4, int tile, float step, int dtype,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, S,
                                 hs, g4, tile, step, st);
  return launch<float>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, S, hs, g4, tile,
                       step, st);
}
