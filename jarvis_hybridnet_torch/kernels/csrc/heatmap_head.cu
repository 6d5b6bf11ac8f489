// K15 heatmap_head: torch's ConvTranspose2d(k=4, s=2, p=1, no bias) on a
// channels-last map, the stride-2 heatmap head of EfficientTrack.
//
// Replaces: jarvis_hybridnet_tpu/models/layers.py ConvTranspose2dTorch
// (:90-135) as the `deconv1` head of models/efficienttrack.py:75-78 uses it,
// a hand-built jnp op (lax.conv_transpose with torch's padding rule) that
// the port ran as cuDNN's ConvTranspose2d (dgrad2d_grouped_direct_kernel).
//
// The function: output pixel (y, x) of (N, 2h, 2w, Cout) reads the 2 x 2
// input pixels (iy, ix) with y = 2 iy - 1 + ky and x = 2 ix - 1 + kx, so
// each output parity (py, px) = (y % 2, x % 2) is a product with K = 4 Cin:
// for output row 2m + py the input rows are m and m - 1 (py = 0: taps 1, 3)
// or m + 1 and m (py = 1: taps 0, 2); columns alike. Sums in float32 over
// the operands in the working type, rounded once.
//
// Rows mode (pad = 1): the output is the padded rows buffer of the 3D
// cascade, (N, 2h + 2, 2w + 2, P): the interior at (1, 1), a one-pixel
// border of zeros, lanes Cout..P - 1 zeros, so the step needs no zero fill
// and no strided copy after the head.
//
// Bound on the H100: bytes. KeypointDetect's head reads 96 x 64^2 x 64 bf16
// (50 MB) and writes 96 x 130^2 x 24 bf16 (78 MB); its 18.5 GFLOP take
// 0.019 ms at the bf16 tensor-core peak.
//
// Design, bf16: warp-level tensor cores (mma.sync.m16n8k16, bf16 in,
// float32 accumulators, operands by ldmatrix). Persistent blocks of 8 warps
// stage the weight once in shared memory, re-laid for the product, then
// walk tiles of 8 x 16 input positions: the tile with a one-pixel halo
// comes in by cp.async (zeros outside the map; pixels and weight rows
// padded by 8 elements, so ldmatrix's 8 rows hit 8 distinct bank groups),
// each warp takes one row of 16 positions, the results are rounded once
// into a staged output tile laid out as the output's pixels, which the block
// writes out row by row in 16-byte vectors.
// - head_mma (Cout >= 8): a block takes 24 output lanes (3 tiles of 8); for
//   each parity, K = (tap row, tap column, channel) runs 4 Cin / 16 steps
//   of one ldmatrix for A, two for B and 3 mma.
// - head_mma_par (Cout <= 2, the one-channel CenterDetect head): the four
//   parities share one product, N = (parity, channel) of 8 lanes and K =
//   the whole 3 x 3 neighbourhood's channels, the weight zero at the taps a
//   parity does not read: 2.25x the products of the function, on tensor
//   cores 15x faster than FFMA.
// Any other case (float32, 2 < Cout < 8) runs head_ffma: persistent blocks
// stage the weight of 8 output lanes in shared memory and walk the input
// positions, a group of 8 threads a position; each thread reads its
// 16-byte channel vectors of the 3 x 3 neighbourhood (the group's loads are
// whole 128-byte lines), sums them with FFMA in float32 (no TF32), and the
// group adds its partial sums by shuffles in a fixed order. Border pixels
// are zeroed by a grid-stride loop.
#include "common.cuh"

constexpr int kTH = 8, kTW = 16;  // input positions a tile (tensor-core kernels): rows x columns
constexpr int kLanes = 24;        // output lanes a block of head_mma (3 tiles of 8)
constexpr int kParLanes = 8;      // head_mma_par's N: 4 parities x 2 channels
constexpr int kMmaThreads = 256;  // one warp a tile row
constexpr int kFfmaThreads = 128;

struct Geo {
  int N, h, w, cin, cout, P, pad;  // input (N, h, w, cin); output lanes P >= cout
  int sci, sco, sky, skx;          // weight (cin, cout, 4, 4) element strides
};

// the tap row (or column) of parity p's j-th input row (column): p = 0
// reads rows m (tap 1) and m - 1 (tap 3), p = 1 rows m + 1 (tap 0) and m
// (tap 2)
__device__ __forceinline__ int tap(int p, int j) { return p ? (j ? 0 : 2) : (j ? 3 : 1); }
__device__ __forceinline__ int shift(int p, int j) { return p ? j : -j; }

// Zero the one-pixel border of the padded output, all P lanes, in a
// grid-stride loop over (image, border pixel, lane).
template <typename T>
__device__ void zero_border(T* __restrict__ out, const Geo& g, long long worker,
                            long long workers) {
  if (!g.pad) return;
  const int Ho = 2 * g.h + 2, Wo = 2 * g.w + 2, B = 2 * Wo + 2 * (Ho - 2);
  const long long total = (long long)g.N * B * g.P;
  for (long long e = worker; e < total; e += workers) {
    const int c = (int)(e % g.P);
    const long long pix = e / g.P;
    const int b = (int)(pix % B);
    const long long n = pix / B;
    int Y, X;
    if (b < Wo) {
      Y = 0, X = b;
    } else if (b < 2 * Wo) {
      Y = Ho - 1, X = b - Wo;
    } else {
      Y = 1 + (b - 2 * Wo) / 2, X = ((b - 2 * Wo) & 1) ? Wo - 1 : 0;
    }
    out[((n * Ho + Y) * Wo + X) * g.P + c] = from_f<T>(0.f);
  }
}

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldmatrix_x2(uint32_t* r, const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// 16 bytes global -> shared, zeros where `valid` is false (src-size 0)
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

// Shared memory of the tensor-core kernels: the weight [rows][ks] (head_mma:
// 4 parities x 24 lanes, K = 4 Cin'; head_mma_par: 8 lanes, K = 9 Cin'),
// the input tile [(kTH + 2) (kTW + 2)][sp], the output tile [2 kTH][2 kTW]
// [lanes]; Cin' is Cin rounded up to 16.
struct MmaPlan {
  int cin_pad, taps, ks, sp, w_rows, lanes, w_elems, x_elems;
  __host__ __device__ MmaPlan(int cin, bool par, int P) {
    cin_pad = (cin + 15) / 16 * 16;
    taps = par ? 9 : 4;
    ks = taps * cin_pad + 8;
    sp = cin_pad + 8;
    w_rows = par ? kParLanes : 4 * kLanes;
    lanes = par ? P : kLanes;
    w_elems = w_rows * ks;
    x_elems = (kTH + 2) * (kTW + 2) * sp;
  }
  __host__ __device__ int bytes() const {
    return (w_elems + x_elems + 4 * kTH * kTW * ((lanes + 7) / 8 * 8)) * 2;
  }
};

// The input tile of positions (m0.., l0..) of image n with its halo, by
// cp.async, 8 channels a 16-byte copy; zeros outside the map and in the
// channels from Cin to Cin'.
__device__ __forceinline__ void load_tile(__nv_bfloat16* xs, const __nv_bfloat16* x,
                                          const Geo& g, const MmaPlan& pl, long long n, int m0,
                                          int l0) {
  const int cv = pl.cin_pad / 8;
  for (int i = threadIdx.x; i < (kTH + 2) * (kTW + 2) * cv; i += blockDim.x) {
    const int v = i % cv, pix = i / cv;
    const int iy = m0 - 1 + pix / (kTW + 2), ix = l0 - 1 + pix % (kTW + 2);
    const bool valid = iy >= 0 && iy < g.h && ix >= 0 && ix < g.w && v * 8 < g.cin;
    const __nv_bfloat16* src = valid ? x + ((n * g.h + iy) * g.w + ix) * g.cin + v * 8 : x;
    cp_async16(xs + pix * pl.sp + v * 8, src, valid);
  }
  cp_async_wait_all();
}

// The staged output tile (rows 2 m0.., columns 2 l0.. of the map, `stride`
// lanes a pixel in shared memory, of which the block writes cw from lane
// c0 on) to the output. Where the tile holds the output's whole pixels
// (stride == cw == P) each output row's segment is one contiguous run in
// both, copied in 16-byte vectors where both ends allow it, else element
// by element; otherwise pixel by pixel.
__device__ __forceinline__ void store_tile(__nv_bfloat16* out, const __nv_bfloat16* os,
                                           const Geo& g, long long n, int m0, int l0, int c0,
                                           int stride, int cw) {
  const int Ho = 2 * g.h + 2 * g.pad, Wo = 2 * g.w + 2 * g.pad;
  const int rows = min(2 * kTH, 2 * (g.h - m0)), cols = min(2 * kTW, 2 * (g.w - l0));
  const long long base = ((n * Ho + 2 * m0 + g.pad) * Wo + 2 * l0 + g.pad) * g.P + c0;
  if (stride == cw && cw == g.P) {
    const int run = cols * g.P;  // elements of a row's segment
    const long long row_step = (long long)Wo * g.P;
    const bool vec = run % 8 == 0 && (2 * kTW * stride) % 8 == 0 && row_step % 8 == 0 &&
                     ((reinterpret_cast<uintptr_t>(out) + base * 2) % 16) == 0;
    if (vec) {
      const int nv = run / 8;
      for (int i = threadIdx.x; i < rows * nv; i += blockDim.x) {
        const int yl = i / nv, v = i % nv;
        *reinterpret_cast<uint4*>(out + base + yl * row_step + v * 8) =
            *reinterpret_cast<const uint4*>(os + yl * 2 * kTW * stride + v * 8);
      }
    } else {
      for (int yl = 0; yl < rows; ++yl)
        for (int e = threadIdx.x; e < run; e += blockDim.x)
          out[base + yl * row_step + e] = os[yl * 2 * kTW * stride + e];
    }
    return;
  }
  for (int i = threadIdx.x; i < rows * cols * cw; i += blockDim.x) {
    const int c = i % cw, pix = i / cw, yl = pix / cols, xl = pix % cols;
    out[base + ((long long)yl * Wo + xl) * g.P + c] = os[(yl * 2 * kTW + xl) * stride + c];
  }
}

__global__ void __launch_bounds__(kMmaThreads, 2)
    head_mma(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
             __nv_bfloat16* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const MmaPlan pl(g.cin, false, g.P);
  __nv_bfloat16* ws = smem;
  __nv_bfloat16* xs = ws + pl.w_elems;
  __nv_bfloat16* os = xs + pl.x_elems;
  const int c0 = blockIdx.y * kLanes;  // the block's first output lane
  // the weight [parity][lane][(tap row, tap column, channel)]: a thread
  // takes a (parity, taps, channel) row and loads its 24 lanes at once
  for (int row = threadIdx.x; row < 16 * pl.cin_pad; row += blockDim.x) {
    const int ci = row % pl.cin_pad, jj = (row / pl.cin_pad) % 4, p = row / (4 * pl.cin_pad);
    const __nv_bfloat16* src = w + ci * g.sci + tap(p >> 1, jj >> 1) * g.sky +
                               tap(p & 1, jj & 1) * g.skx;
    float v[kLanes];
#pragma unroll
    for (int n = 0; n < kLanes; ++n)
      v[n] = ci < g.cin && c0 + n < g.cout ? to_f(src[(c0 + n) * g.sco]) : 0.f;
#pragma unroll
    for (int n = 0; n < kLanes; ++n)
      ws[(p * kLanes + n) * pl.ks + jj * pl.cin_pad + ci] = __float2bfloat16_rn(v[n]);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  // ldmatrix's row of this lane: A position (lane & 7) + 8 (bit 3), channel
  // offset 8 (bit 4); B lane (lane & 7) + 8 (bit 4), channel offset 8 (bit 3)
  const int a_pos = (lane & 7) + (lane & 8), a_k = (lane & 16) >> 1;
  const int b_n = (lane & 7) + ((lane & 16) >> 1), b_k = lane & 8;
  const int th = (g.h + kTH - 1) / kTH, tw = (g.w + kTW - 1) / kTW;
  const long long tiles = (long long)g.N * th * tw;
  const int cw = min(kLanes, g.P - c0);  // lanes this block writes
  // the output tile's lanes a pixel: the output's own where one block
  // writes whole pixels, so that a row of the tile is a run of the output
  const int stride = cw == g.P ? g.P : kLanes;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n = t / (th * tw);
    const int m0 = (int)(t / tw % th) * kTH, l0 = (int)(t % tw) * kTW;
    load_tile(xs, x, g, pl, n, m0, l0);
    __syncthreads();
    const int r = warp;  // the warp's tile row
    for (int p = 0; p < 4; ++p) {
      const int py = p >> 1, px = p & 1;
      float acc[3][4] = {};
      const __nv_bfloat16* wb = ws + (p * kLanes + b_n) * pl.ks + b_k;
      for (int jj = 0; jj < 4; ++jj) {  // the tap (row, column) pair, Cin' channels each
        const int yy = r + 1 + shift(py, jj >> 1), xx = a_pos + 1 + shift(px, jj & 1);
        const __nv_bfloat16* a_row = xs + (yy * (kTW + 2) + xx) * pl.sp + a_k;
        const __nv_bfloat16* b_row = wb + jj * pl.cin_pad;
#pragma unroll 4
        for (int ci0 = 0; ci0 < pl.cin_pad; ci0 += 16) {
          uint32_t a[4], b01[4], b2[2];
          ldmatrix_x4(a, a_row + ci0);
          ldmatrix_x4(b01, b_row + ci0);              // lane tiles 0 and 1
          ldmatrix_x2(b2, b_row + 16 * pl.ks + ci0);  // lane tile 2
          mma_bf16(acc[0], a, b01[0], b01[1]);
          mma_bf16(acc[1], a, b01[2], b01[3]);
          mma_bf16(acc[2], a, b2[0], b2[1]);
        }
      }
      // rounded once into the output tile; lanes at or above Cout are zeros
#pragma unroll
      for (int nt = 0; nt < 3; ++nt) {
        const int nn = nt * 8 + 2 * tig;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          __nv_bfloat16* o = os + ((2 * r + py) * 2 * kTW + 2 * (gid + 8 * half) + px) * stride;
          __nv_bfloat162 v;
          v.x = __float2bfloat16_rn(c0 + nn < g.cout ? acc[nt][2 * half] : 0.f);
          v.y = __float2bfloat16_rn(c0 + nn + 1 < g.cout ? acc[nt][2 * half + 1] : 0.f);
          if (stride % 2 == 0 && nn < stride) {  // a pair on a 4-byte boundary
            *reinterpret_cast<__nv_bfloat162*>(o + nn) = v;
          } else {
            if (nn < stride) o[nn] = v.x;
            if (nn + 1 < stride) o[nn + 1] = v.y;
          }
        }
      }
    }
    __syncthreads();
    store_tile(out, os, g, n, m0, l0, c0, stride, cw);
  }
  if (blockIdx.y == 0)
    zero_border(out, g, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                (long long)gridDim.x * blockDim.x);
}

__global__ void __launch_bounds__(kMmaThreads, 2)
    head_mma_par(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                 __nv_bfloat16* __restrict__ out, Geo g) {
  extern __shared__ __align__(16) __nv_bfloat16 smem[];
  const MmaPlan pl(g.cin, true, g.P);
  __nv_bfloat16* ws = smem;
  __nv_bfloat16* xs = ws + pl.w_elems;
  __nv_bfloat16* os = xs + pl.x_elems;
  const int P = g.P;  // the output tile's lanes a pixel (P <= 8)
  // the weight [lane (parity, channel)][(neighbour row, column, channel)]:
  // neighbour (a, b) of the 3 x 3 feeds parity (py, px) at tap row
  // tap(py, j) where a = 1 + shift(py, j), else 0
  for (int i = threadIdx.x; i < kParLanes * 9 * pl.cin_pad; i += blockDim.x) {
    const int ci = i % pl.cin_pad, nb = (i / pl.cin_pad) % 9, ln = i / (9 * pl.cin_pad);
    const int p = ln / g.cout, co = ln % g.cout, py = p >> 1, px = p & 1;
    const int a = nb / 3 - 1, b = nb % 3 - 1;      // the neighbour's offset
    const int jy = py ? a : -a, jx = px ? b : -b;  // its tap index, if 0 or 1
    float v = 0.f;
    if (p < 4 && ci < g.cin && jy >= 0 && jy <= 1 && jx >= 0 && jx <= 1)
      v = to_f(w[ci * g.sci + co * g.sco + tap(py, jy) * g.sky + tap(px, jx) * g.skx]);
    ws[ln * pl.ks + nb * pl.cin_pad + ci] = __float2bfloat16_rn(v);
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int a_pos = (lane & 7) + (lane & 8), a_k = (lane & 16) >> 1;
  const int b_n = lane & 7, b_k = lane & 8;  // x2: lanes 0-15 give the rows
  const int th = (g.h + kTH - 1) / kTH, tw = (g.w + kTW - 1) / kTW;
  const long long tiles = (long long)g.N * th * tw;
  for (long long t = blockIdx.x; t < tiles; t += gridDim.x) {
    const long long n = t / (th * tw);
    const int m0 = (int)(t / tw % th) * kTH, l0 = (int)(t % tw) * kTW;
    load_tile(xs, x, g, pl, n, m0, l0);
    __syncthreads();
    const int r = warp;
    float acc[4] = {};
    for (int nb = 0; nb < 9; ++nb) {
      const __nv_bfloat16* a_row =
          xs + ((r + nb / 3) * (kTW + 2) + a_pos + nb % 3) * pl.sp + a_k;
      const __nv_bfloat16* b_row = ws + b_n * pl.ks + nb * pl.cin_pad + b_k;
#pragma unroll 4
      for (int ci0 = 0; ci0 < pl.cin_pad; ci0 += 16) {
        uint32_t a[4], b[2];
        ldmatrix_x4(a, a_row + ci0);
        ldmatrix_x2(b, b_row + ci0);
        mma_bf16(acc, a, b[0], b[1]);
      }
    }
    // lanes 2 tig, 2 tig + 1 of N: (parity, channel) pairs
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int q = gid + 8 * half;
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int ln = 2 * tig + e, p = ln / g.cout, co = ln % g.cout;
        if (p < 4)
          os[((2 * r + (p >> 1)) * 2 * kTW + 2 * q + (p & 1)) * P + co] =
              __float2bfloat16_rn(acc[2 * half + e]);
      }
    }
    for (int i = threadIdx.x; g.cout < P && i < 4 * kTH * kTW * (P - g.cout); i += blockDim.x)
      os[(i / (P - g.cout)) * P + g.cout + i % (P - g.cout)] = __float2bfloat16_rn(0.f);
    __syncthreads();
    store_tile(out, os, g, n, m0, l0, 0, P, P);
  }
  zero_border(out, g, (long long)blockIdx.x * blockDim.x + threadIdx.x,
              (long long)gridDim.x * blockDim.x);
}

// Channels a vector load of head_ffma: 16 bytes.
template <typename T>
struct alignas(16) FVec {
  static constexpr int V = 16 / sizeof(T);
  T v[V];
};

constexpr int kGroup = 8;  // lanes of head_ffma that share one input position

// head_ffma's weight in shared memory: [chunk][channel of the chunk][16
// taps][L lanes] as float, a chunk (V channels, one lane's 16-byte load)
// kChunkPad floats apart, so the 8 lanes of a group read 8 banks' worth of
// distinct chunks without conflict.
constexpr int kChunkPad = 4;
template <typename T, int L>
__host__ __device__ constexpr int ffma_chunk_floats() {
  return FVec<T>::V * 16 * L + kChunkPad;
}

template <typename T, int L>
__global__ void __launch_bounds__(kFfmaThreads)
    head_ffma(const T* __restrict__ x, const T* __restrict__ w, T* __restrict__ out, Geo g) {
  constexpr int V = FVec<T>::V, CF = ffma_chunk_floats<T, L>();
  extern __shared__ __align__(16) float wf[];
  const int c0 = blockIdx.y * L;
  const int chunks = g.cin / V;
  // a thread takes a (channel, tap) row and loads its L lanes at once; tap
  // t = ((py * 2 + px) * 2 + jy) * 2 + jx
  for (int row = threadIdx.x; row < g.cin * 16; row += blockDim.x) {
    const int t = row % 16, ci = row / 16;
    const int py = t >> 3, px = (t >> 2) & 1, jy = (t >> 1) & 1, jx = t & 1;
    const T* src = w + ci * g.sci + tap(py, jy) * g.sky + tap(px, jx) * g.skx;
    float v[L];
#pragma unroll
    for (int l = 0; l < L; ++l) v[l] = c0 + l < g.cout ? to_f(src[(c0 + l) * g.sco]) : 0.f;
#pragma unroll
    for (int l = 0; l < L; ++l) wf[(ci / V) * CF + (ci % V) * 16 * L + t * L + l] = v[l];
  }
  __syncthreads();
  const int sub = threadIdx.x % kGroup;  // the group's lane: chunks sub, sub + 8, ...
  const long long quads = (long long)g.N * g.h * g.w;
  const long long per_pass = (long long)gridDim.x * (blockDim.x / kGroup);
  const int Ho = 2 * g.h + 2 * g.pad, Wo = 2 * g.w + 2 * g.pad;
  // every lane of a block runs the same trip count, so the shuffles see all 32
  for (long long q = (long long)blockIdx.x * (blockDim.x / kGroup) + threadIdx.x / kGroup;
       q - threadIdx.x / kGroup < quads; q += per_pass) {
    const bool live = q < quads;
    const int l = (int)(q % g.w), m = (int)(q / g.w % g.h);
    const long long n = q / ((long long)g.w * g.h);
    float acc[4][L] = {};
    for (int c = sub; live && c < chunks; c += kGroup) {
      FVec<T> xv[3][3];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) {
          const int iy = m - 1 + a, ix = l - 1 + b;
          if (iy >= 0 && iy < g.h && ix >= 0 && ix < g.w) {
            xv[a][b] = *reinterpret_cast<const FVec<T>*>(
                x + ((n * g.h + iy) * g.w + ix) * g.cin + c * V);
          } else {
#pragma unroll
            for (int v = 0; v < V; ++v) xv[a][b].v[v] = from_f<T>(0.f);
          }
        }
      const float* wc = wf + c * CF;
#pragma unroll
      for (int v = 0; v < V; ++v) {
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const int py = t >> 3, px = (t >> 2) & 1, jy = (t >> 1) & 1, jx = t & 1;
          const float xin = to_f(xv[1 + shift(py, jy)][1 + shift(px, jx)].v[v]);
#pragma unroll
          for (int k = 0; k < L; ++k)
            acc[t >> 2][k] = fmaf(xin, wc[(v * 16 + t) * L + k], acc[t >> 2][k]);
        }
      }
    }
    // the group's partial sums, over its lanes' chunks, in a fixed order
#pragma unroll
    for (int p = 0; p < 4; ++p)
#pragma unroll
      for (int k = 0; k < L; ++k)
#pragma unroll
        for (int off = 1; off < kGroup; off *= 2)
          acc[p][k] += __shfl_xor_sync(0xffffffffu, acc[p][k], off, kGroup);
    if (live) {
      // lane sub writes output pixel sub (parity) of the position's 4
      for (int p = sub; p < 4; p += kGroup) {
        const int Y = 2 * m + (p >> 1) + g.pad, X = 2 * l + (p & 1) + g.pad;
        T* o = out + ((n * Ho + Y) * Wo + X) * g.P + c0;
#pragma unroll
        for (int k = 0; k < L; ++k)
          if (c0 + k < g.P) o[k] = from_f<T>(c0 + k < g.cout ? acc[p][k] : 0.f);
      }
    }
  }
  if (blockIdx.y == 0)
    zero_border(out, g, (long long)blockIdx.x * blockDim.x + threadIdx.x,
                (long long)gridDim.x * blockDim.x);
}

template <typename K>
static cudaError_t allow_smem(K kernel, int bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
}

template <typename T, int L>
static int launch_ffma(const void* x, const void* w, void* out, const Geo& g, int blocks,
                       cudaStream_t st) {
  const int smem = g.cin / FVec<T>::V * ffma_chunk_floats<T, L>() * 4;
  const cudaError_t e = allow_smem(head_ffma<T, L>, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid(blocks, (g.P + L - 1) / L);
  head_ffma<T, L><<<grid, kFfmaThreads, smem, st>>>((const T*)x, (const T*)w, (T*)out, g);
  return launch_status();
}

// x: (N, h, w, cin) contiguous (channels-last NCHW), cin % 8 == 0, 16-byte
// aligned; w: (cin, cout, 4, 4) with element strides sci, sco, sky, skx;
// out: (N, 2h + 2 pad, 2w + 2 pad, P) contiguous, P >= cout (lanes at or
// above cout are written as zeros; pad 1: the border too). path 1: head_mma
// (bf16, cout >= 8); path 2: head_mma_par (bf16, cout <= 2, P <= 8); path
// 0: head_ffma with lanes (1 or 8) output lanes a thread; each with
// `blocks` persistent blocks in the grid's x dimension.
extern "C" int heatmap_head(const void* x, const void* w, void* out, int N, int h, int wd,
                            int cin, int cout, int P, int pad, int sci, int sco, int sky,
                            int skx, int dtype, int path, int lanes, int blocks, void* stream) {
  const cudaStream_t st = (cudaStream_t)stream;
  const Geo g{N, h, wd, cin, cout, P, pad, sci, sco, sky, skx};
  if (path == 1 || path == 2) {
    if (dtype != DTYPE_BF16) return (int)cudaErrorInvalidValue;
    const int smem = MmaPlan(cin, path == 2, P).bytes();
    const auto kernel = path == 1 ? head_mma : head_mma_par;
    const cudaError_t e = allow_smem(kernel, smem);
    if (e != cudaSuccess) return (int)e;
    const dim3 grid(blocks, path == 1 ? (P + kLanes - 1) / kLanes : 1);
    kernel<<<grid, kMmaThreads, smem, st>>>((const __nv_bfloat16*)x, (const __nv_bfloat16*)w,
                                            (__nv_bfloat16*)out, g);
    return launch_status();
  }
  if (dtype == DTYPE_BF16)
    return lanes == 1 ? launch_ffma<__nv_bfloat16, 1>(x, w, out, g, blocks, st)
                      : launch_ffma<__nv_bfloat16, 8>(x, w, out, g, blocks, st);
  if (dtype == DTYPE_F32)
    return lanes == 1 ? launch_ffma<float, 1>(x, w, out, g, blocks, st)
                      : launch_ffma<float, 8>(x, w, out, g, blocks, st);
  return (int)cudaErrorInvalidValue;
}

// The dynamic shared memory of a tensor-core path (1 or 2) at cin input
// channels and P output lanes, for the wrapper's plan.
extern "C" int heatmap_head_mma_smem(int path, int cin, int P) {
  return MmaPlan(cin, path == 2, P).bytes();
}
