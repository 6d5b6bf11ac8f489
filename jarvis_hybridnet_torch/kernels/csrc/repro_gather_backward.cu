// K11 and K12: the reprojection gather's backward with respect to the heatmap
// rows, one launch each.
//
// Replaces: the VJP (jax.vjp, as jax.value_and_grad takes it through
// HybridNet) of models/repro.py reprojection_layer with respect to the
// heatmaps: gather_voxel_volume (:157) in every mode, with
// _upsample2_aligned_axis x3 (:78, :297-299) for quarter_fused (K11, the
// VJP of K2) and _upsample2_axis x3 (:47, :315-317) for half (K12, the VJP
// of K5, which also takes exact, :266-273, and half_fused, :302-314).
//
// The function: the upstream gradient of the forward's float32 volume, in
// its layout (B, F, F, F, J), is transposed through the mode's value
// upsample onto the gather points (L per axis: F = 2L for quarter_fused and
// half, F = L for exact and half_fused), divided by C, and added to the row
// each camera gathered the point from. The output is the (B, C, hs2, J)
// gradient of the rows, as the J-view of a (B, C, hs2, S) buffer.
//
// Bound on the H100: bytes in the function (the upstream gradient and the
// indices read once, the padded rows written once), but the scatter is
// B * C * L^3 * J float atomics at data-dependent rows, and every point that
// projects outside a camera's crop is clamped onto the window's edge pixels,
// so a few rows take many of them. Which of the two holds is measured
// (chip_smoke.py's check_k11 / check_k12, PERF.md).
//
// Design (a simple first version): the buffer is zeroed by
// cudaMemsetAsync on the caller's stream; one thread per (frameset, gather
// point, joint), joints fastest, so a warp's loads of the upstream gradient
// and its atomics on one row are contiguous. The thread sums the transposed
// stencil from the upstream gradient in registers (z innermost, then y,
// then x: the order of the plain version's three passes), divides by C and
// adds the value to its element of each camera's row with atomicAdd
// (scatter_camera_rows in repro_common.cuh). Aggregating the points that hit
// the same pixel within a warp or a block, and 16-byte vector atomics, are
// later work. Built with --fmad=false: each product rounds before its sum,
// as in the plain version.
#include "repro_common.cuh"

// the gather modes: K5's numbering (repro_grid_gather.py MODES), then K2's
constexpr int kExact = 0, kHalf = 1, kHalfFused = 2, kQuarter = 3;

// The forward's output positions along one axis that read gather point k
// of L, with their weights: the transposed 1-D stencil. Returns the count.
template <int kMode>
__device__ __forceinline__ int axis_taps(int k, int L, int* pos, float* w) {
  int n = 0;
  if (kMode == kExact || kMode == kHalfFused) {
    pos[n] = k, w[n++] = 1.f;
  } else if (kMode == kQuarter) {
    // out[2k] = in[k], out[2k+1] = 0.5 (in[k] + in[min(k+1, L-1)])
    pos[n] = 2 * k, w[n++] = 1.f;
    pos[n] = 2 * k + 1, w[n++] = k == L - 1 ? 1.f : 0.5f;
    if (k > 0) pos[n] = 2 * k - 1, w[n++] = 0.5f;
  } else {
    // out[2k] = 0.25 in[max(k-1, 0)] + 0.75 in[k],
    // out[2k+1] = 0.75 in[k] + 0.25 in[min(k+1, L-1)]
    pos[n] = 2 * k, w[n++] = k == 0 ? 1.f : 0.75f;
    pos[n] = 2 * k + 1, w[n++] = k == L - 1 ? 1.f : 0.75f;
    if (k > 0) pos[n] = 2 * k - 1, w[n++] = 0.25f;
    if (k < L - 1) pos[n] = 2 * k + 2, w[n++] = 0.25f;
  }
  return n;
}

template <int kMode, int kThreads>
__global__ void __launch_bounds__(kThreads)
    gather_backward(const float* __restrict__ grad, const int* __restrict__ idx,
                    float* __restrict__ out, int C, int J, int S, int hs2, int L) {
  const int F = (kMode == kHalf || kMode == kQuarter) ? 2 * L : L;
  const int n3 = L * L * L;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n3 * J) return;
  const int b = blockIdx.y;
  const int v = t / J, j = t - v * J;
  const int x = v / (L * L), y = v / L % L, z = v % L;
  int px[4], py[4], pz[4];
  float wx[4], wy[4], wz[4];
  const int nx = axis_taps<kMode>(x, L, px, wx), ny = axis_taps<kMode>(y, L, py, wy),
            nz = axis_taps<kMode>(z, L, pz, wz);
  const float* g = grad + (size_t)b * F * F * F * J + j;
  float acc = 0.f;
  for (int a = 0; a < nx; ++a) {
    float sy = 0.f;
    for (int c = 0; c < ny; ++c) {
      const float* row = g + ((size_t)px[a] * F + py[c]) * F * J;
      float sz = 0.f;
      for (int d = 0; d < nz; ++d) sz = __fadd_rn(sz, __fmul_rn(wz[d], row[pz[d] * J]));
      sy = __fadd_rn(sy, __fmul_rn(wy[c], sz));
    }
    acc = __fadd_rn(acc, __fmul_rn(wx[a], sy));
  }
  scatter_camera_rows(out + (size_t)b * C * hs2 * S + j, idx + (size_t)b * C * n3 + v, n3, C,
                      hs2, S, __fdiv_rn(acc, (float)C));
}

template <int kMode, int kThreads>
static void go(const void* grad, const void* idx, void* out, int B, int C, int J, int S, int hs2,
               int L, long long work, cudaStream_t st) {
  gather_backward<kMode, kThreads><<<dim3((unsigned)((work + kThreads - 1) / kThreads), B),
                                     kThreads, 0, st>>>((const float*)grad, (const int*)idx,
                                                        (float*)out, C, J, S, hs2, L);
}

// threads: the block size, 256 from the wrappers (kernel_sweep.py times the
// others)
template <int kMode>
static int launch(const void* grad, const void* idx, void* out, int B, int C, int J, int S,
                  int hs2, int L, int threads, cudaStream_t st) {
  const long long work = (long long)L * L * L * J;
  if (work >= (1LL << 31) || B > 65535) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * C * hs2 * S * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  switch (threads) {
    case 64: go<kMode, 64>(grad, idx, out, B, C, J, S, hs2, L, work, st); break;
    case 128: go<kMode, 128>(grad, idx, out, B, C, J, S, hs2, L, work, st); break;
    case 256: go<kMode, 256>(grad, idx, out, B, C, J, S, hs2, L, work, st); break;
    case 512: go<kMode, 512>(grad, idx, out, B, C, J, S, hs2, L, work, st); break;
    case 1024: go<kMode, 1024>(grad, idx, out, B, C, J, S, hs2, L, work, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}

// K11. grad: float32 (B, 2g4, 2g4, 2g4, J), the upstream gradient of K2's
// half-grid volume; idx: int32 (B, C, g4^3), K2's indices. out: float32
// (B, C, hs2, S), S >= J, zeroed here, then the rows' gradient in its first J
// elements of each row. threads: 64, 128, 256, 512 or 1024 a block.
extern "C" int repro_quarter_gather_backward(const void* grad, const void* idx, void* out, int B,
                                             int C, int J, int S, int hs2, int g4, int threads,
                                             void* stream) {
  return launch<kQuarter>(grad, idx, out, B, C, J, S, hs2, g4, threads, (cudaStream_t)stream);
}

// K12. mode: 0 exact, 1 half, 2 half_fused (repro_grid_gather.py MODES); n:
// the gather grid's points per axis (G for exact, G/2 for the half modes).
// grad: float32 (B, G, G, G, J) for exact and half, (B, G/2, G/2, G/2, J)
// for half_fused; idx: int32 (B, C, n^3), K5's indices; out as K11's.
extern "C" int repro_grid_gather_backward(const void* grad, const void* idx, void* out, int B,
                                          int C, int J, int S, int hs2, int n, int mode,
                                          int threads, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (mode == kExact) return launch<kExact>(grad, idx, out, B, C, J, S, hs2, n, threads, st);
  if (mode == kHalf) return launch<kHalf>(grad, idx, out, B, C, J, S, hs2, n, threads, st);
  if (mode == kHalfFused)
    return launch<kHalfFused>(grad, idx, out, B, C, J, S, hs2, n, threads, st);
  return (int)cudaErrorInvalidValue;
}
