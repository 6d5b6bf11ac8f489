// K4 resize_normalize: uint8 or float32 frames to the normalized network
// input.
//
// Replaces: ops/image.py resize_bilinear (:64), resize_bilinear_mxu (:101)
// and normalize_imagenet (:127) as predictor3d.py:96-108 and
// predictor2d.py:83-92 chain them, for uint8 frames (value_scale 255) and
// float32 frames in [0, 1] (value_scale 1).
//
// Bound on the H100: bytes. A frame's pixels are read at most once and the
// normalized output written once; at 1280x1024 -> 256^2 the two H taps of
// ratio 4 touch half of the frame's rows, and at 3 bytes per pixel a tap
// every 5 pixels still touches every 32-byte sector of those rows (float32
// frames: 12 bytes a pixel, the same rows).
//
// Design: one thread per output pixel, all three channels. Half-pixel
// bilinear with no antialias, driven by per-axis (i0, i1, w1) tables as in
// image.py:_linear_tables: blend the two H taps at each W tap, then the W
// taps, then /255 (uint8 frames only) and (x - mean) / std, all in float32
// with one rounding to the output type at the store. (The JAX bf16 path
// rounds to bf16 after each matmul and elementwise op; the tests bound that
// gap.)
#include <type_traits>

#include "common.cuh"

template <typename In, typename T>
__global__ void resize_norm(const In* __restrict__ x, T* __restrict__ out, int H, int W,
                            int h, int w, const int* __restrict__ hi0,
                            const int* __restrict__ hi1, const float* __restrict__ hw1,
                            const int* __restrict__ wi0, const int* __restrict__ wi1,
                            const float* __restrict__ ww1, float m0, float m1, float m2,
                            float s0, float s1, float s2) {
  const int ox = blockIdx.x * blockDim.x + threadIdx.x;
  const int oy = blockIdx.y;
  const int n = blockIdx.z;
  if (ox >= w) return;
  const In* img = x + (size_t)n * H * W * 3;
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
    float v = __fadd_rn(__fmul_rn(left, 1.f - wv), __fmul_rn(right, wv));
    if constexpr (std::is_same<In, uint8_t>::value) v = __fdiv_rn(v, 255.f);
    o[ch] = from_f<T>(__fdiv_rn(__fsub_rn(v, mean[ch]), stdv[ch]));
  }
}

template <typename In, typename T>
static void launch(const void* x, void* out, int N, int H, int W, int h, int w, const void* hi0,
                   const void* hi1, const void* hw1, const void* wi0, const void* wi1,
                   const void* ww1, float m0, float m1, float m2, float s0, float s1, float s2,
                   cudaStream_t st) {
  const dim3 block(128);
  const dim3 grid((w + 127) / 128, h, N);
  resize_norm<In, T><<<grid, block, 0, st>>>(
      (const In*)x, (T*)out, H, W, h, w, (const int*)hi0, (const int*)hi1, (const float*)hw1,
      (const int*)wi0, (const int*)wi1, (const float*)ww1, m0, m1, m2, s0, s1, s2);
}

// x: uint8 (in_float 0) or float32 (in_float 1) (N, H, W, 3); out: (N, h, w,
// 3) float32 or bfloat16; the tables are int32 / float32 device arrays of
// length h (H axis) and w (W axis).
extern "C" int resize_normalize(const void* x, void* out, int N, int H, int W, int h, int w,
                                const void* hi0, const void* hi1, const void* hw1,
                                const void* wi0, const void* wi1, const void* ww1, float m0,
                                float m1, float m2, float s0, float s1, float s2, int dtype,
                                int in_float, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  if (in_float) {
    if (dtype == DTYPE_BF16)
      launch<float, __nv_bfloat16>(x, out, N, H, W, h, w, hi0, hi1, hw1, wi0, wi1, ww1, m0, m1,
                                   m2, s0, s1, s2, st);
    else
      launch<float, float>(x, out, N, H, W, h, w, hi0, hi1, hw1, wi0, wi1, ww1, m0, m1, m2, s0,
                           s1, s2, st);
  } else {
    if (dtype == DTYPE_BF16)
      launch<uint8_t, __nv_bfloat16>(x, out, N, H, W, h, w, hi0, hi1, hw1, wi0, wi1, ww1, m0,
                                     m1, m2, s0, s1, s2, st);
    else
      launch<uint8_t, float>(x, out, N, H, W, h, w, hi0, hi1, hw1, wi0, wi1, ww1, m0, m1, m2,
                             s0, s1, s2, st);
  }
  return launch_status();
}
