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
//             at a time: all 2 C row loads are issued before the sums, which
//             add in camera order 0..C-1 and divide by C (the same sums as a
//             warp reading each camera's J-row);
//   upsample— a group of threads per half-grid (X, Y) row, one per (z, joint):
//             the center-aligned 2x stencil along x, then y, then z in the
//             reference's op order, from the shared tile, with 32-bit index
//             arithmetic; each thread writes two z-neighbours, and
//             consecutive threads write consecutive joints.
// The index arithmetic rounds after every op with __f*_rn intrinsics in the
// JAX op order (a division by 2 is the exact multiplication by 0.5), and the
// file is built with --fmad=false: an FMA contraction moves a value across an
// integer boundary often enough to change indices.
#include "common.cuh"

constexpr int kThreads = 512;
constexpr int kCamFields = 20;  // P (12), fx, fy, cx, cy, k1, k2, center_hm x, y
constexpr int kLoadBatch = 16;  // camera rows loaded before they are summed
constexpr int kSmemMax = 232448;

__device__ __forceinline__ float sq_rn(float a) { return __fmul_rn(a, a); }

template <typename T>
__global__ void __launch_bounds__(kThreads)
    repro_tile(const T* __restrict__ rows, const int* __restrict__ center3d,
               const int* __restrict__ center_hm, const float* __restrict__ P,
               const float* __restrict__ K, const float* __restrict__ D, float* __restrict__ out,
               int* __restrict__ idx_out, int C, int J, int hs, int g4, int tile, int tiles,
               float step) {
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

  for (int i = threadIdx.x; i < C * kCamFields; i += kThreads) {
    const int c = i / kCamFields, f = i % kCamFields, bc = b * C + c;
    float v;
    if (f < 12) v = P[bc * 12 + f];  // (4, 3) row-major
    else if (f == 12) v = K[bc * 9 + 0];
    else if (f == 13) v = K[bc * 9 + 4];
    else if (f == 14) v = K[bc * 9 + 6];
    else if (f == 15) v = K[bc * 9 + 7];
    else if (f == 16) v = D[bc * 5 + 0];
    else if (f == 17) v = D[bc * 5 + 1];
    else v = (float)center_hm[bc * 2 + (f - 18)];
    cam[i] = v;
  }
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
    // coords = (arange - half) * step + center3d   (repro.py:114-115)
    const float X = __fadd_rn(__fmul_rn((float)(i - mid), step), cx3);
    const float Y = __fadd_rn(__fmul_rn((float)(j - mid), step), cy3);
    const float Z = __fadd_rn(__fmul_rn((float)(k - mid), step), cz3);
    const float* p = cam + c * kCamFields;
    float proj[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      proj[m] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(p[m], X), __fmul_rn(p[3 + m], Y)), __fmul_rn(p[6 + m], Z)),
          p[9 + m]);
    const float fx = p[12], fy = p[13], cx = p[14], cy = p[15], k1 = p[16], k2 = p[17];

    float u = __fsub_rn(__fdiv_rn(proj[0], proj[2]), cx);
    float q = __fsub_rn(__fdiv_rn(proj[1], proj[2]), cy);
    const float r2 = __fadd_rn(sq_rn(__fdiv_rn(u, fx)), sq_rn(__fdiv_rn(q, fy)));
    const float distort = __fadd_rn(1.f, __fmul_rn(__fadd_rn(k1, __fmul_rn(k2, r2)), r2));
    u = __fadd_rn(__fmul_rn(u, distort), cx);
    q = __fadd_rn(__fmul_rn(q, distort), cy);

    // clamp to the crop window, shift to crop-local (repro.py:143-147)
    const float chx = p[18], chy = p[19];
    const float lo = (float)(hs - 1), hi = (float)hs;
    u = __fadd_rn(__fsub_rn(fminf(fmaxf(u, __fsub_rn(chx, lo)), __fsub_rn(__fadd_rn(chx, hi), 2.f)), chx), lo);
    q = __fadd_rn(__fsub_rn(fminf(fmaxf(q, __fsub_rn(chy, lo)), __fsub_rn(__fadd_rn(chy, hi), 2.f)), chy), lo);
    int pix = (int)__fmul_rn(q, 0.5f) * hs + (int)__fmul_rn(u, 0.5f);
    pix = min(max(pix, 0), hs2 - 1);  // memory safety only: the clamp keeps pix in range
    idx[w] = pix;
    if (idx_out != nullptr && li < tile && lj < tile && lk < tile && x0 + li < g4 &&
        y0 + lj < g4 && z0 + lk < g4)
      idx_out[(size_t)(b * C + c) * nvox + (i * g4 + j) * g4 + k] = pix;
    for (v += kThreads; v >= ne; v -= ne) ++c;
  }
  __syncthreads();

  // gather phase: camera mean of the J-rows at the indices
  const T* rb = rows + (size_t)b * C * hs2 * J;
  const int groups = kThreads / J;
  if ((int)threadIdx.x < groups * J) {
    const int g = threadIdx.x / J, jj = threadIdx.x % J;
    for (int v = g; v < ne; v += 2 * groups) {
      const int v2 = v + groups;
      const bool two = v2 < ne;
      float acc = 0.f, acc2 = 0.f;
      for (int c0 = 0; c0 < C; c0 += kLoadBatch) {
        float val[kLoadBatch], val2[kLoadBatch];
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u) {
          const int c = c0 + u;
          val[u] = c < C ? to_f(rb[(c * hs2 + idx[c * ne + v]) * J + jj]) : 0.f;
          val2[u] = c < C && two ? to_f(rb[(c * hs2 + idx[c * ne + v2]) * J + jj]) : 0.f;
        }
#pragma unroll
        for (int u = 0; u < kLoadBatch; ++u)
          if (c0 + u < C) {
            acc += val[u];
            acc2 += val2[u];
          }
      }
      quarter[v * J + jj] = __fdiv_rn(acc, (float)C);
      if (two) quarter[v2 * J + jj] = __fdiv_rn(acc2, (float)C);
    }
  }
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
                  int hs, int g4, int tile, float step, cudaStream_t st) {
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
      (const float*)K, (const float*)D, (float*)out, (int*)idx_out, C, J, hs, g4, tile, tiles,
      step);
  return launch_status();
}

// rows: (B, C, hs*hs, J) heatmap rows; center3d (B, 3) int32; center_hm
// (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5) float32.
// out: float32 (B, 2g4, 2g4, 2g4, J); idx_out: null, or int32 (B, C, g4^3)
// to receive the gather indices. tile: quarter voxels per tile edge.
extern "C" int repro_quarter_gather(const void* rows, const void* center3d,
                                    const void* center_hm, const void* P, const void* K,
                                    const void* D, void* out, void* idx_out, int B, int C, int J,
                                    int hs, int g4, int tile, float step, int dtype,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    return launch<__nv_bfloat16>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs,
                                 g4, tile, step, st);
  return launch<float>(rows, center3d, center_hm, P, K, D, out, idx_out, B, C, J, hs, g4, tile,
                       step, st);
}
