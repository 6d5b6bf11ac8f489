// K2 repro_quarter_gather: the quarter_fused voxel reprojection.
//
// Replaces: models/repro.py reproject_indices(upsample=False) called with
// (grid_size // 2, 2 * grid_spacing) (repro.py:288-293), gather_voxel_volume
// (:157) and _upsample2_aligned_axis x3 (:297-299).
//
// Bound on the H100: bytes, and most of them scattered. Each (frameset,
// quarter voxel, camera) reads one J-row of the padded heatmaps at a
// data-dependent pixel; the half-grid volume is written once in float32.
//
// Design:
//   quarter kernel — one warp per (frameset, quarter voxel), one lane per
//     joint (J <= 32). Every lane computes the projection into each camera
//     in registers (a few dozen flops, cheaper than a shuffle), then the
//     warp reads that camera's contiguous J-row in one coalesced load and
//     accumulates in float32 in camera order; the mean divides by C. No
//     index map is written to memory (an optional one is, for tests).
//   upsample kernel — one thread per half-grid element: the center-aligned
//     2x stencil along x, then y, then z, in the reference's op order.
// The index arithmetic rounds after every op with __f*_rn intrinsics in the
// JAX op order, and the file is built with --fmad=false: an FMA contraction
// moves a value across an integer boundary often enough to change indices.
#include "common.cuh"

__device__ __forceinline__ float sq_rn(float a) { return __fmul_rn(a, a); }

template <typename T>
__global__ void repro_quarter(const T* __restrict__ rows, const int* __restrict__ center3d,
                              const int* __restrict__ center_hm, const float* __restrict__ P,
                              const float* __restrict__ K, const float* __restrict__ D,
                              float* __restrict__ quarter, int* __restrict__ idx_out, int B,
                              int C, int J, int hs, int g4, float step) {
  const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  const int nvox = g4 * g4 * g4;
  if (warp >= B * nvox) return;
  const int b = warp / nvox, v = warp - b * nvox;
  const int i = v / (g4 * g4), j = (v / g4) % g4, k = v % g4;
  const int mid = g4 / 2;  // index of the cube center on each axis
  const int hs2 = hs * hs;

  // coords = (arange - half) * step + center3d   (repro.py:114-115)
  const float X = __fadd_rn(__fmul_rn((float)(i - mid), step), (float)center3d[b * 3 + 0]);
  const float Y = __fadd_rn(__fmul_rn((float)(j - mid), step), (float)center3d[b * 3 + 1]);
  const float Z = __fadd_rn(__fmul_rn((float)(k - mid), step), (float)center3d[b * 3 + 2]);

  float acc = 0.f;
  for (int c = 0; c < C; ++c) {
    const int bc = b * C + c;
    const float* p = P + bc * 12;  // (4, 3) row-major
    float proj[3];
#pragma unroll
    for (int m = 0; m < 3; ++m)
      proj[m] = __fadd_rn(
          __fadd_rn(__fadd_rn(__fmul_rn(p[m], X), __fmul_rn(p[3 + m], Y)), __fmul_rn(p[6 + m], Z)),
          p[9 + m]);
    const float* kk = K + bc * 9;
    const float fx = kk[0], fy = kk[4], cx = kk[6], cy = kk[7];
    const float k1 = D[bc * 5 + 0], k2 = D[bc * 5 + 1];

    float u = __fsub_rn(__fdiv_rn(proj[0], proj[2]), cx);
    float w = __fsub_rn(__fdiv_rn(proj[1], proj[2]), cy);
    const float r2 = __fadd_rn(sq_rn(__fdiv_rn(u, fx)), sq_rn(__fdiv_rn(w, fy)));
    const float distort = __fadd_rn(1.f, __fmul_rn(__fadd_rn(k1, __fmul_rn(k2, r2)), r2));
    u = __fadd_rn(__fmul_rn(u, distort), cx);
    w = __fadd_rn(__fmul_rn(w, distort), cy);

    // clamp to the crop window, shift to crop-local (repro.py:143-147)
    const float chx = (float)center_hm[bc * 2 + 0], chy = (float)center_hm[bc * 2 + 1];
    const float lo = (float)(hs - 1), hi = (float)hs;
    u = __fadd_rn(__fsub_rn(fminf(fmaxf(u, __fsub_rn(chx, lo)), __fsub_rn(__fadd_rn(chx, hi), 2.f)), chx), lo);
    w = __fadd_rn(__fsub_rn(fminf(fmaxf(w, __fsub_rn(chy, lo)), __fsub_rn(__fadd_rn(chy, hi), 2.f)), chy), lo);
    int idx = (int)__fdiv_rn(w, 2.f) * hs + (int)__fdiv_rn(u, 2.f);
    idx = min(max(idx, 0), hs2 - 1);  // memory safety only: the clamp keeps idx in range
    if (idx_out != nullptr && lane == 0) idx_out[(size_t)bc * nvox + v] = idx;

    if (lane < J) acc += to_f(rows[((size_t)bc * hs2 + idx) * J + lane]);
  }
  if (lane < J) quarter[((size_t)b * nvox + v) * J + lane] = __fdiv_rn(acc, (float)C);
}

// Center-aligned 2x linear upsample of the quarter volume along x, y, z in
// turn: out[2k] = in[k], out[2k+1] = 0.5 * (in[k] + in[min(k+1, L-1)]).
__global__ void repro_upsample(const float* __restrict__ q, float* __restrict__ out, int B,
                               int J, int g4) {
  const int g2 = 2 * g4;
  const size_t total = (size_t)B * g2 * g2 * g2 * J;
  const size_t e = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= total) return;
  const int jj = (int)(e % J);
  size_t r = e / J;
  const int Z = (int)(r % g2); r /= g2;
  const int Y = (int)(r % g2); r /= g2;
  const int X = (int)(r % g2);
  const int b = (int)(r / g2);

  const int x0 = X >> 1, x1 = min(x0 + 1, g4 - 1), dx = X & 1;
  const int y0 = Y >> 1, y1 = min(y0 + 1, g4 - 1), dy = Y & 1;
  const int z0 = Z >> 1, z1 = min(z0 + 1, g4 - 1), dz = Z & 1;
  const float* qb = q + (size_t)b * g4 * g4 * g4 * J + jj;
  auto at = [&](int x, int y, int z) { return qb[((size_t)(x * g4 + y) * g4 + z) * J]; };
  auto fx = [&](int y, int z) {
    return dx ? __fmul_rn(0.5f, __fadd_rn(at(x0, y, z), at(x1, y, z))) : at(x0, y, z);
  };
  auto fy = [&](int z) {
    return dy ? __fmul_rn(0.5f, __fadd_rn(fx(y0, z), fx(y1, z))) : fx(y0, z);
  };
  out[e] = dz ? __fmul_rn(0.5f, __fadd_rn(fy(z0), fy(z1))) : fy(z0);
}

// rows: (B, C, hs*hs, J) heatmap rows; center3d (B, 3) int32; center_hm
// (B, C, 2) int32; P (B, C, 4, 3), K (B, C, 3, 3), D (B, C, 1, 5) float32.
// quarter: float32 scratch (B, g4^3, J); out: float32 (B, 2g4, 2g4, 2g4, J);
// idx_out: null, or int32 (B, C, g4^3) to receive the gather indices.
extern "C" int repro_quarter_gather(const void* rows, const void* center3d,
                                    const void* center_hm, const void* P, const void* K,
                                    const void* D, void* quarter, void* out, void* idx_out,
                                    int B, int C, int J, int hs, int g4, float step, int dtype,
                                    void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const int threads = 256;
  const long long warps = (long long)B * g4 * g4 * g4;
  const unsigned blocks = (unsigned)((warps * 32 + threads - 1) / threads);
  if (dtype == DTYPE_BF16)
    repro_quarter<__nv_bfloat16><<<blocks, threads, 0, st>>>(
        (const __nv_bfloat16*)rows, (const int*)center3d, (const int*)center_hm,
        (const float*)P, (const float*)K, (const float*)D, (float*)quarter, (int*)idx_out, B,
        C, J, hs, g4, step);
  else
    repro_quarter<float><<<blocks, threads, 0, st>>>(
        (const float*)rows, (const int*)center3d, (const int*)center_hm, (const float*)P,
        (const float*)K, (const float*)D, (float*)quarter, (int*)idx_out, B, C, J, hs, g4,
        step);
  const long long total = (long long)B * 8 * g4 * g4 * g4 * J;
  repro_upsample<<<(unsigned)((total + threads - 1) / threads), threads, 0, st>>>(
      (const float*)quarter, (float*)out, B, J, g4);
  return launch_status();
}
