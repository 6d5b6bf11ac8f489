// K11: the quarter_fused reprojection gather's backward with respect to the
// heatmap rows, one launch (K12, the other modes', is
// repro_grid_gather_backward.cu).
//
// Replaces: the VJP (jax.vjp, as jax.value_and_grad takes it through
// HybridNet) of models/repro.py reprojection_layer's quarter_fused mode with
// respect to the heatmaps: gather_voxel_volume (:157) with
// _upsample2_aligned_axis x3 (:78, :297-299), the VJP of K2.
//
// The function: the upstream gradient of the forward's float32 half-grid
// volume, in its layout (B, 2L, 2L, 2L, J), is transposed through the
// aligned value upsample onto the L^3 gather points, divided by ct, and added
// to the row each camera gathered the point from. The output is the (B, C,
// hs2, J) gradient of the rows, as the J-view of a (B, C, hs2, S) buffer.
//
// Bound on the H100: bytes in the function (the upstream gradient and the
// indices read once, the padded rows written once); the scatter is
// B * C * L^3 * J float atomics at data-dependent rows. Measured at 53% of
// the bytes bound (PERF.md).
//
// bf16 rows (bf16 training): the wrapper runs the float32 function into a
// scratch buffer and then repro_rows_to_bf16 (below), a second launch that
// rounds it once to the bf16 rows' layout. K12's wrapper calls the same
// entry for its bf16 rows.
//
// Design: the buffer is zeroed by cudaMemsetAsync on the caller's stream;
// one thread per (frameset, gather point, joint), joints fastest, so a
// warp's loads of the upstream gradient and its atomics on one row are
// contiguous. The thread sums the transposed stencil from the upstream
// gradient in registers (z innermost, then y, then x: the order of the
// plain version's three passes), divides by ct and adds the value to its
// element of each camera's row with atomicAdd (scatter_camera_rows in
// repro_common.cuh). Built with --fmad=false: each product rounds before
// its sum, as in the plain version.
#include <algorithm>

#include "repro_common.cuh"

// The forward's output positions along one axis that read gather point k
// of L, with their weights: the aligned upsample's stencil transposed,
// out[2k] = in[k], out[2k+1] = 0.5 (in[k] + in[min(k+1, L-1)]). Returns
// the count.
__device__ __forceinline__ int axis_taps(int k, int L, int* pos, float* w) {
  int n = 0;
  pos[n] = 2 * k, w[n++] = 1.f;
  pos[n] = 2 * k + 1, w[n++] = k == L - 1 ? 1.f : 0.5f;
  if (k > 0) pos[n] = 2 * k - 1, w[n++] = 0.5f;
  return n;
}

template <int kThreads>
__global__ void __launch_bounds__(kThreads)
    gather_backward(const float* __restrict__ grad, const int* __restrict__ idx,
                    float* __restrict__ out, int C, int ct, int J, int S, int hs2, int L) {
  const int F = 2 * L;
  const int n3 = L * L * L;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n3 * J) return;
  const int b = blockIdx.y;
  const int v = t / J, j = t - v * J;
  const int x = v / (L * L), y = v / L % L, z = v % L;
  int px[4], py[4], pz[4];
  float wx[4], wy[4], wz[4];
  const int nx = axis_taps(x, L, px, wx), ny = axis_taps(y, L, py, wy),
            nz = axis_taps(z, L, pz, wz);
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
                      hs2, S, __fdiv_rn(acc, (float)ct));
}

template <int kThreads>
static void go(const void* grad, const void* idx, void* out, int B, int C, int ct, int J, int S,
               int hs2, int L, long long work, cudaStream_t st) {
  gather_backward<kThreads><<<dim3((unsigned)((work + kThreads - 1) / kThreads), B), kThreads, 0,
                              st>>>((const float*)grad, (const int*)idx, (float*)out, C, ct, J, S,
                                    hs2, L);
}

// threads: the block size, 256 from the wrapper (kernel_sweep.py times the
// others)
static int launch(const void* grad, const void* idx, void* out, int B, int C, int ct, int J,
                  int S, int hs2, int L, int threads, cudaStream_t st) {
  const long long work = (long long)L * L * L * J;
  if (work >= (1LL << 31) || B > 65535 || ct < C) return (int)cudaErrorInvalidValue;
  const cudaError_t e = cudaMemsetAsync(out, 0, (size_t)B * C * hs2 * S * sizeof(float), st);
  if (e != cudaSuccess) return (int)e;
  switch (threads) {
    case 64: go<64>(grad, idx, out, B, C, ct, J, S, hs2, L, work, st); break;
    case 128: go<128>(grad, idx, out, B, C, ct, J, S, hs2, L, work, st); break;
    case 256: go<256>(grad, idx, out, B, C, ct, J, S, hs2, L, work, st); break;
    case 512: go<512>(grad, idx, out, B, C, ct, J, S, hs2, L, work, st); break;
    case 1024: go<1024>(grad, idx, out, B, C, ct, J, S, hs2, L, work, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return launch_status();
}

// K11. grad: float32 (B, 2g4, 2g4, 2g4, J), the upstream gradient of K2's
// half-grid volume; idx: int32 (B, C, g4^3), K2's indices. out: float32
// (B, C, hs2, S), S >= J, zeroed here, then the rows' gradient in its first J
// elements of each row. threads: 64, 128, 256, 512 or 1024 a block. ct:
// the forward's divisor, the rig's cameras (C, or more where each rank
// holds C of them).
extern "C" int repro_quarter_gather_backward(const void* grad, const void* idx, void* out, int B,
                                             int C, int J, int S, int hs2, int g4, int threads,
                                             int ct, void* stream) {
  return launch(grad, idx, out, B, C, ct, J, S, hs2, g4, threads, (cudaStream_t)stream);
}

// bf16 rows: the backwards (K11, K12) sum a bf16 table's gradient in float32
// and round it once here, in a second launch: out (rows, So) bf16 takes
// in (rows, Si) float32's first J elements of each row rounded to nearest
// even, and zeros in its padding. JAX scatter-adds the rounded cotangents
// into a bf16 table instead (the VJP of jnp.take, repro.py:210): one
// rounding per add, so its sums are less exact than these.
__global__ void rows_to_bf16(const float* __restrict__ in, __nv_bfloat16* __restrict__ out,
                             long long n, int J, int Si, int So) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (long long)gridDim.x * blockDim.x) {
    const long long r = i / So;
    const int k = (int)(i - r * So);
    out[i] = __float2bfloat16_rn(k < J ? in[r * Si + k] : 0.f);
  }
}

// in: float32 (rows, Si), the gradient K11 or K12 wrote; out: bf16 (rows,
// So); Si, So >= J.
extern "C" int repro_rows_to_bf16(const void* in, void* out, long long rows, int J, int Si,
                                  int So, void* stream) {
  if (rows < 1 || J < 1 || Si < J || So < J) return (int)cudaErrorInvalidValue;
  const long long n = rows * So;
  const int threads = 256;
  const long long blocks = std::min<long long>((n + threads - 1) / threads, 1LL << 16);
  rows_to_bf16<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)in, (__nv_bfloat16*)out, n, J, Si, So);
  return launch_status();
}
