// K4 resize_normalize: uint8 frames to the normalized network input.
//
// Replaces: ops/image.py resize_bilinear (:64), resize_bilinear_mxu (:101)
// and normalize_imagenet (:127) as predictor3d.py:96-108 chains them.
//
// Bound on the H100: bytes. A frame's uint8 pixels are read at most once
// and the normalized output written once; at 1280x1024 -> 256^2 the two H
// taps of ratio 4 touch half of the frame's rows, and at 3 bytes per pixel a
// tap every 5 pixels still touches every 32-byte sector of those rows.
//
// Design: one thread per output pixel, all three channels. Half-pixel
// bilinear with no antialias, driven by per-axis (i0, i1, w1) tables as in
// image.py:_linear_tables: blend the two H taps at each W tap, then the W
// taps, then /255 and (x - mean) / std, all in float32 with one rounding to
// the output type at the store. (The JAX bf16 path rounds to bf16 after each
// matmul and elementwise op; the tests bound that gap.)
#include "common.cuh"

template <typename T>
__global__ void resize_norm(const uint8_t* __restrict__ x, T* __restrict__ out, int H, int W,
                            int h, int w, const int* __restrict__ hi0,
                            const int* __restrict__ hi1, const float* __restrict__ hw1,
                            const int* __restrict__ wi0, const int* __restrict__ wi1,
                            const float* __restrict__ ww1, float m0, float m1, float m2,
                            float s0, float s1, float s2) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= w) return;
  const uint8_t* img = x + (size_t)n * H * W * 3;
  const int ra = hi0[oy], rb = hi1[oy];
  const int ca = wi0[ox], cb = wi1[ox];
  const float wh = hw1[oy], wv = ww1[ox];
  const float mean[3] = {m0, m1, m2}, stdv[3] = {s0, s1, s2};
  T* o = out + (((size_t)n * h + oy) * w + ox) * 3;
#pragma unroll
  for (int ch = 0; ch < 3; ++ch) {
    const float a = img[((size_t)ra * W + ca) * 3 + ch];
    const float b = img[((size_t)rb * W + ca) * 3 + ch];
    const float c = img[((size_t)ra * W + cb) * 3 + ch];
    const float d = img[((size_t)rb * W + cb) * 3 + ch];
    // a * (1 - w) + b * w per axis, H first (image.py:61, :83)
    const float left = __fadd_rn(__fmul_rn(a, 1.f - wh), __fmul_rn(b, wh));
    const float right = __fadd_rn(__fmul_rn(c, 1.f - wh), __fmul_rn(d, wh));
    const float v = __fadd_rn(__fmul_rn(left, 1.f - wv), __fmul_rn(right, wv));
    o[ch] = from_f<T>(__fdiv_rn(__fsub_rn(__fdiv_rn(v, 255.f), mean[ch]), stdv[ch]));
  }
}

// x: uint8 (N, H, W, 3); out: (N, h, w, 3) float32 or bfloat16; the tables
// are int32 / float32 device arrays of length h (H axis) and w (W axis).
extern "C" int resize_normalize(const void* x, void* out, int N, int H, int W, int h, int w,
                                const void* hi0, const void* hi1, const void* hw1,
                                const void* wi0, const void* wi1, const void* ww1, float m0,
                                float m1, float m2, float s0, float s1, float s2, int dtype,
                                void* stream) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h, N);
  const cudaStream_t st = (cudaStream_t)stream;
  if (dtype == DTYPE_BF16)
    resize_norm<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const uint8_t*)x, (__nv_bfloat16*)out, H, W, h, w, (const int*)hi0, (const int*)hi1,
        (const float*)hw1, (const int*)wi0, (const int*)wi1, (const float*)ww1, m0, m1, m2, s0,
        s1, s2);
  else
    resize_norm<float><<<grid, block, 0, st>>>(
        (const uint8_t*)x, (float*)out, H, W, h, w, (const int*)hi0, (const int*)hi1,
        (const float*)hw1, (const int*)wi0, (const int*)wi1, (const float*)ww1, m0, m1, m2, s0,
        s1, s2);
  return launch_status();
}
