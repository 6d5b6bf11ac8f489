// Device helpers shared by the two voxel reprojection kernels, K2
// (repro_quarter_gather.cu) and K5 (repro_grid_gather.cu): the per-camera
// fields staged in shared memory, the projection of one grid point into a
// camera's crop and the flat pixel index; and K2's camera mean of the
// gathered J-rows (K5 gathers 16-byte lanes of padded rows instead). K2's
// backward, K11 (repro_gather_backward.cu), adds with the camera mean's
// transpose, scatter_camera_rows, at the end of this file.
//
// The index arithmetic rounds after every operation with __f*_rn
// intrinsics in the op order of models/repro.py reproject_indices
// (repro.py:107-153), and both sources are built with --fmad=false: an FMA
// contraction moves a value across an integer boundary often enough to
// change indices.
#pragma once

#include "common.cuh"

constexpr int kCamFields = 20;  // P (12), fx, fy, cx, cy, k1, k2, center_hm x, y
constexpr int kLoadBatch = 16;  // camera rows loaded before they are summed

__device__ __forceinline__ float sq_rn(float a) { return __fmul_rn(a, a); }

// Frameset b's camera fields into cam[C][kCamFields], by the whole block.
__device__ __forceinline__ void load_cameras(float* cam, const float* __restrict__ P,
                                             const float* __restrict__ K,
                                             const float* __restrict__ D,
                                             const int* __restrict__ center_hm, int b, int C) {
  for (int i = threadIdx.x; i < C * kCamFields; i += blockDim.x) {
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
}

// coords = (arange - half) * step + center3d   (repro.py:114-115)
__device__ __forceinline__ float grid_coord(int i, int mid, float step, float center) {
  return __fadd_rn(__fmul_rn((float)(i - mid), step), center);
}

// The point (X, Y, Z) projected into the camera of fields p: the k1/k2
// distortion, the clamp to the crop window and the shift to crop-local
// pixels (repro.py:116-147); u and v before the truncation.
__device__ __forceinline__ void project_uv(const float* p, float X, float Y, float Z, int hs,
                                           float* u_out, float* v_out) {
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

  const float chx = p[18], chy = p[19];
  const float lo = (float)(hs - 1), hi = (float)hs;
  *u_out = __fadd_rn(
      __fsub_rn(fminf(fmaxf(u, __fsub_rn(chx, lo)), __fsub_rn(__fadd_rn(chx, hi), 2.f)), chx), lo);
  *v_out = __fadd_rn(
      __fsub_rn(fminf(fmaxf(q, __fsub_rn(chy, lo)), __fsub_rn(__fadd_rn(chy, hi), 2.f)), chy), lo);
}

// (v / 2).int() * hs + (u / 2).int()   (repro.py:153); a division by 2 is
// the exact multiplication by 0.5
__device__ __forceinline__ int pixel_index(float u, float v, int hs) {
  const int pix = (int)__fmul_rn(v, 0.5f) * hs + (int)__fmul_rn(u, 0.5f);
  return min(max(pix, 0), hs * hs - 1);  // memory safety only: the clamp keeps pix in range
}

// The camera mean of n voxels' J-rows, S elements apart: idx[c * n + v] is
// voxel v's pixel in camera c. A group of J threads per voxel, one per joint, two voxels at a
// time: all 2 C row loads start before the sums, which add in camera
// order 0..C-1 and divide by ct, the cameras of the whole rig (C itself
// unless the cameras are sharded over ranks; gather_voxel_volume,
// repro.py:206-213).
// store(v, joint, mean) receives each result.
template <typename T, typename Store>
__device__ __forceinline__ void gather_means(const T* __restrict__ rb, const int* idx, int n,
                                             int C, int ct, int J, int S, int hs2,
                                             int threads, Store store) {
  const int groups = threads / J;
  if ((int)threadIdx.x >= groups * J) return;
  const int g = threadIdx.x / J, jj = threadIdx.x % J;
  for (int v = g; v < n; v += 2 * groups) {
    const int v2 = v + groups;
    const bool two = v2 < n;
    float acc = 0.f, acc2 = 0.f;
    for (int c0 = 0; c0 < C; c0 += kLoadBatch) {
      float val[kLoadBatch], val2[kLoadBatch];
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u) {
        const int c = c0 + u;
        val[u] = c < C ? to_f(rb[(c * hs2 + idx[c * n + v]) * S + jj]) : 0.f;
        val2[u] = c < C && two ? to_f(rb[(c * hs2 + idx[c * n + v2]) * S + jj]) : 0.f;
      }
#pragma unroll
      for (int u = 0; u < kLoadBatch; ++u)
        if (c0 + u < C) {
          acc += val[u];
          acc2 += val2[u];
        }
    }
    store(v, jj, __fdiv_rn(acc, (float)ct));
    if (two) store(v2, jj, __fdiv_rn(acc2, (float)ct));
  }
}

// The camera mean's transpose for one (gather point, joint): `val`, the mean's
// gradient already divided by the rig's cameras, added to the joint's element of the point's
// row in every camera. idx points at camera 0's index of the point, the
// cameras' indices `cam_stride` apart; out at the frameset's (C, hs2, S)
// gradient rows, offset by the joint. Float atomics: the sums' order, and so
// their rounding, changes from run to run.
__device__ __forceinline__ void scatter_camera_rows(float* out, const int* __restrict__ idx,
                                                    size_t cam_stride, int C, int hs2, int S,
                                                    float val) {
  for (int c = 0; c < C; ++c) {
    const int pix = min(max(idx[(size_t)c * cam_stride], 0), hs2 - 1);  // memory safety only
    atomicAdd(out + ((size_t)c * hs2 + pix) * S, val);
  }
}
