// K3 soft_argmax: the HybridNet epilogue.
//
// Replaces: models/hybridnet.py:95-112 — softplus of the V2V output in
// float32, the normalizer and the three coordinate-weighted sums over the
// g^3 grid, world mm = pts * spacing * 2 - cube / 2 + center3d, and the
// confidence min(max, 255) / 255.
//
// Bound on the H100: bytes. One read of the (B, g, g, g, J) volume; the
// outputs are B * J * 4 floats. softplus costs an exp and a log1p per
// element, still under the card's flops-per-byte balance.
//
// Design: joints are the minor axis, so a block reads whole contiguous
// J-rows: thread t owns joint t % J of row lane t / J, and one step of the
// block covers floor(256 / J) consecutive voxels as one contiguous span.
// Every thread accumulates its five sums in registers over its share of the
// block's voxel chunk; the block reduces them per joint in shared memory and
// writes one partial per (frameset, chunk). A second small kernel adds the
// partials in chunk order (deterministic, no atomics) and finishes.
#include "common.cuh"

constexpr int kThreads = 256;
#define NEG_INF __int_as_float(0xff800000)

__device__ __forceinline__ float softplus_f(float x) {
  // jax.nn.softplus == logaddexp(x, 0)
  return fmaxf(x, 0.f) + log1pf(expf(-fabsf(x)));
}

template <typename T>
__global__ void __launch_bounds__(kThreads) sa_partial(const T* __restrict__ vol,
                                                       float* __restrict__ part, int g, int J,
                                                       int vox_per_chunk, int chunks) {
  __shared__ float red[5][kThreads];
  const int b = blockIdx.y, chunk = blockIdx.x;
  const int lanes = kThreads / J;  // voxels per block step
  const int jj = threadIdx.x % J, r = threadIdx.x / J;
  const bool on = r < lanes;
  const int nvox = g * g * g;
  const int v0 = chunk * vox_per_chunk, v1 = min(nvox, v0 + vox_per_chunk);
  const T* vb = vol + (size_t)b * nvox * J;

  float n = 0.f, sx = 0.f, sy = 0.f, sz = 0.f, mx = NEG_INF;
  if (on) {
    for (int v = v0 + r; v < v1; v += lanes) {
      const float sp = softplus_f(to_f(vb[(size_t)v * J + jj]));
      const int x = v / (g * g), y = (v / g) % g, z = v % g;
      n += sp;
      sx += sp * (float)x;
      sy += sp * (float)y;
      sz += sp * (float)z;
      mx = fmaxf(mx, sp);
    }
  }
  red[0][threadIdx.x] = n;
  red[1][threadIdx.x] = sx;
  red[2][threadIdx.x] = sy;
  red[3][threadIdx.x] = sz;
  red[4][threadIdx.x] = mx;
  __syncthreads();
  if (threadIdx.x < J) {
    float acc[5] = {0.f, 0.f, 0.f, 0.f, NEG_INF};
    for (int l = 0; l < lanes; ++l) {
      const int t = l * J + threadIdx.x;
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[q] += red[q][t];
      acc[4] = fmaxf(acc[4], red[4][t]);
    }
    float* out = part + (((size_t)b * chunks + chunk) * 5) * J + threadIdx.x;
#pragma unroll
    for (int q = 0; q < 5; ++q) out[q * J] = acc[q];
  }
}

__global__ void sa_finish(const float* __restrict__ part, const int* __restrict__ center3d,
                          float* __restrict__ points, float* __restrict__ conf, int B, int J,
                          int chunks, float spacing, float cube) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= B * J) return;
  const int b = t / J, jj = t % J;
  float acc[5] = {0.f, 0.f, 0.f, 0.f, NEG_INF};
  for (int k = 0; k < chunks; ++k) {
    const float* p = part + (((size_t)b * chunks + k) * 5) * J + jj;
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[q] += p[q * J];
    acc[4] = fmaxf(acc[4], p[4 * J]);
  }
#pragma unroll
  for (int d = 0; d < 3; ++d) {
    const float pt = acc[1 + d] / acc[0];
    points[(size_t)t * 3 + d] = pt * spacing * 2.f - cube / 2.f + (float)center3d[b * 3 + d];
  }
  conf[t] = fminf(acc[4], 255.f) / 255.f;
}

// vol: (B, g, g, g, J) contiguous; center3d (B, 3) int32; part: float32
// scratch (B, chunks, 5, J); points (B, J, 3) and conf (B, J) float32.
extern "C" int soft_argmax(const void* vol, const void* center3d, void* part, void* points,
                           void* conf, int B, int g, int J, int vox_per_chunk, int chunks,
                           float spacing, float cube, int dtype, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 grid(chunks, B);
  if (dtype == DTYPE_BF16)
    sa_partial<__nv_bfloat16><<<grid, kThreads, 0, st>>>((const __nv_bfloat16*)vol,
                                                         (float*)part, g, J, vox_per_chunk,
                                                         chunks);
  else
    sa_partial<float><<<grid, kThreads, 0, st>>>((const float*)vol, (float*)part, g, J,
                                                 vox_per_chunk, chunks);
  sa_finish<<<(B * J + 127) / 128, 128, 0, st>>>((const float*)part, (const int*)center3d,
                                                (float*)points, (float*)conf, B, J, chunks,
                                                spacing, cube);
  return launch_status();
}
