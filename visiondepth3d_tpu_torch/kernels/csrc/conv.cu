// 3x3 stride-1 SAME convolution, NHWC, with fused bias and activation.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_conv.py:_conv3_kernel
// (conv3x3_pallas): the convs of the Real-ESRGAN RRDB trunk and tail and of
// the RIFE residual blocks. It is an implicit GEMM: M = B*H*W output pixels,
// N = O output channels, K = 9*C (tap-major inside each channel chunk).
//
// A block owns an 8 x 32 tile of output pixels of one image and up to 64
// output channels. For each chunk of input channels it stages the tile's
// (8+2) x (32+2) input window (the 1-pixel halo, zero outside the image:
// SAME padding at all four edges, and zero past C) and the chunk's weights
// [9][chunk][BN] in shared memory, then runs the nine taps as shifted views
// of the window, so every input value is read from device memory once per
// block and reused by nine taps and by every output channel. Accumulation
// is float32; bias (rounded to the input type by the wrapper, as the Pallas
// kernel does) and the activation are added in float32, and the result is
// rounded once to the output type.
//
// - bfloat16: warp-level tensor-core products (WMMA 16x16x16, bf16 operands,
//   f32 accumulators). Each warp owns one tile row (two 16-pixel fragments)
//   and all BN channels.
// - float32: CUDA-core FMAs in full float32 (no TF32). Each thread owns one
//   tile column (8 pixels) and BN/8 channels.
//
// What bounds it on the H100: the RDB conv5 (C=192 -> O=64) does 1,728 MACs
// per output channel on 384 bytes of input and 128 of output per pixel in
// bf16, 432 FLOP/byte, above the card's 295 FLOP/byte ridge: compute. The
// RDB conv1 (64 -> 32) does 192 FLOP/byte: bytes. What the design does about
// it: the window is read once per block and reused nine times, the weights
// stay in shared memory for the whole chunk, and the output is written once
// (no im2col buffer in device memory). Not done yet: wgmma, TMA and a
// pipelined (double-buffered) K loop, so neither bound is reached.
//
// The wrapper (kernels/conv.py) passes weights packed [9][Cp][Op] in the
// input type, with Cp and Op the channel counts rounded up to 16 and zero
// padding, and the bias as float32 [Op].

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int TH = 8;   // output rows per block
constexpr int TW = 32;  // output columns per block
constexpr int WIN_H = TH + 2;
constexpr int WIN_W = TW + 2;
constexpr int THREADS = 256;

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v >= 0.0f ? v : v * slope;
  return v;
}

// The WIN_H x WIN_W x CK input window for channels [c0, c0 + CK) into s,
// laid out [WIN_H * WIN_W][CK]; zero outside the image and past C. With
// vec, C is a multiple of the 16-byte vector and x is 16-byte aligned.
template <typename T, int CK>
__device__ __forceinline__ void load_window(const T* __restrict__ x, T* __restrict__ s,
                                            int b, int y0, int x0, int c0, int H, int W,
                                            int C, int vec) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int N = WIN_H * WIN_W * CK;
  if (vec) {
    for (int e = threadIdx.x * VEC; e < N; e += THREADS * VEC) {
      const int pix = e / CK;
      const int c = c0 + e % CK;
      const int gy = y0 - 1 + pix / WIN_W;
      const int gx = x0 - 1 + pix % WIN_W;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        v = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + gy) * W + gx) * C + c);
      *reinterpret_cast<uint4*>(s + e) = v;
    }
  } else {
    for (int e = threadIdx.x; e < N; e += THREADS) {
      const int pix = e / CK;
      const int c = c0 + e % CK;
      const int gy = y0 - 1 + pix / WIN_W;
      const int gx = x0 - 1 + pix % WIN_W;
      float v = 0.0f;
      if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C)
        v = vd3d::load(x, (((size_t)b * H + gy) * W + gx) * C + c);
      vd3d::store(s, e, v);
    }
  }
}

// Weights [9][Cp][Op] rows c0..c0+CK, columns n0..n0+BN into s as
// [9][CK][LD] (LD >= BN); every row is whole 16-byte vectors.
template <typename T, int CK, int BN, int LD>
__device__ __forceinline__ void load_weights(const T* __restrict__ w, T* __restrict__ s,
                                             int c0, int n0, int Cp, int Op) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = BN / VEC;  // vectors per row
  for (int i = threadIdx.x; i < 9 * CK * VPR; i += THREADS) {
    const int row = i / VPR;  // tap * CK + cc
    const int col = (i % VPR) * VEC;
    const int tap = row / CK, cc = row % CK;
    const uint4 v = *reinterpret_cast<const uint4*>(
        w + ((size_t)tap * Cp + c0 + cc) * Op + n0 + col);
    *reinterpret_cast<uint4*>(s + row * LD + col) = v;
  }
}

// ---------------------------------------------------------------- bfloat16

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_wmma_kernel(const __nv_bfloat16* __restrict__ x, const __nv_bfloat16* __restrict__ w,
                    const float* __restrict__ bias, __nv_bfloat16* __restrict__ out, int H,
                    int W, int C, int O, int Cp, int Op, int act, float slope, int vec,
                    int tiles_x) {
  namespace wmma = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  constexpr int CK = 16;
  // 32 bytes per window pixel: a fragment may start at any pixel and WMMA
  // wants 32-byte aligned rows
  constexpr int LDA = CK;
  constexpr int LDB = BN + 8;  // padded against shared-memory bank conflicts
  constexpr int NF = BN / 16;
  __shared__ __align__(128) bf16 sA[WIN_H * WIN_W * LDA];
  __shared__ __align__(128) bf16 sB[9 * CK * LDB];
  __shared__ __align__(128) float sC[THREADS / 32][16 * 16];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[2][NF];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < NF; ++j) wmma::fill_fragment(acc[i][j], 0.0f);

  for (int c0 = 0; c0 < Cp; c0 += CK) {
    load_window<bf16, CK>(x, sA, b, y0, x0, c0, H, W, C, vec);
    load_weights<bf16, CK, BN, LDB>(w, sB, c0, n0, Cp, Op);
    __syncthreads();
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> bfrag[NF];
#pragma unroll
      for (int j = 0; j < NF; ++j)
        wmma::load_matrix_sync(bfrag[j], sB + tap * CK * LDB + j * 16, LDB);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        // output pixels (warp, 16 i .. 16 i + 15) read window (warp + ky, 16 i + kx + r)
        wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> afrag;
        wmma::load_matrix_sync(afrag, sA + ((warp + ky) * WIN_W + i * 16 + kx) * LDA, LDA);
#pragma unroll
        for (int j = 0; j < NF; ++j) wmma::mma_sync(acc[i][j], afrag, bfrag[j], acc[i][j]);
      }
    }
    __syncthreads();
  }

  // epilogue through a per-warp 16 x 16 float32 scratch: bias, activation,
  // one rounding, masked store of the ragged edges
  float* sc = sC[warp];
  const int gy = y0 + warp;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int j = 0; j < NF; ++j) {
      wmma::store_matrix_sync(sc, acc[i][j], 16, wmma::mem_row_major);
      __syncwarp();
      for (int e = lane; e < 256; e += 32) {
        const int gx = x0 + i * 16 + e / 16;
        const int n = n0 + j * 16 + e % 16;
        if (gy < H && gx < W && n < O)
          out[(((size_t)b * H + gy) * W + gx) * O + n] =
              __float2bfloat16_rn(activate(sc[e] + bias[n], act, slope));
      }
      __syncwarp();
    }
  }
}

// ---------------------------------------------------------------- float32

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                   int C, int O, int Cp, int Op, int act, float slope, int vec, int tiles_x) {
  constexpr int CK = 8;
  constexpr int NPT = BN / 8;  // output channels per thread: ng + 8 j
  __shared__ __align__(16) float sA[WIN_H * WIN_W * CK];
  __shared__ __align__(16) float sB[9 * CK * BN];

  const int g = threadIdx.x / 8;   // tile column, 0..31
  const int ng = threadIdx.x % 8;  // channel group
  const int y0 = (blockIdx.x / tiles_x) * TH;
  const int x0 = (blockIdx.x % tiles_x) * TW;
  const int n0 = blockIdx.y * BN;
  const int b = blockIdx.z;

  float acc[TH][NPT];
#pragma unroll
  for (int r = 0; r < TH; ++r)
#pragma unroll
    for (int j = 0; j < NPT; ++j) acc[r][j] = 0.0f;

  for (int c0 = 0; c0 < Cp; c0 += CK) {
    load_window<float, CK>(x, sA, b, y0, x0, c0, H, W, C, vec);
    load_weights<float, CK, BN, BN>(w, sB, c0, n0, Cp, Op);
    __syncthreads();
#pragma unroll 1
    for (int tap = 0; tap < 9; ++tap) {
      const int ky = tap / 3, kx = tap % 3;
#pragma unroll
      for (int cc = 0; cc < CK; ++cc) {
        float bv[NPT];
#pragma unroll
        for (int j = 0; j < NPT; ++j) bv[j] = sB[(tap * CK + cc) * BN + ng + 8 * j];
#pragma unroll
        for (int r = 0; r < TH; ++r) {
          const float a = sA[((r + ky) * WIN_W + g + kx) * CK + cc];
#pragma unroll
          for (int j = 0; j < NPT; ++j) acc[r][j] = fmaf(a, bv[j], acc[r][j]);
        }
      }
    }
    __syncthreads();
  }

  const int gx = x0 + g;
#pragma unroll
  for (int r = 0; r < TH; ++r) {
    const int gy = y0 + r;
#pragma unroll
    for (int j = 0; j < NPT; ++j) {
      const int n = n0 + ng + 8 * j;
      if (gy < H && gx < W && n < O)
        out[(((size_t)b * H + gy) * W + gx) * O + n] = activate(acc[r][j] + bias[n], act, slope);
    }
  }
}

template <int BN>
void launch(const void* x, const void* w, const float* bias, void* out, dim3 grid, int H,
            int W, int C, int O, int Cp, int Op, int act, float slope, int bf16, int vec,
            int tiles_x, cudaStream_t s) {
  if (bf16) {
    conv3x3_wmma_kernel<BN><<<grid, THREADS, 0, s>>>(
        (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bias, (__nv_bfloat16*)out, H, W,
        C, O, Cp, Op, act, slope, vec, tiles_x);
  } else {
    conv3x3_fma_kernel<BN><<<grid, THREADS, 0, s>>>((const float*)x, (const float*)w, bias,
                                                     (float*)out, H, W, C, O, Cp, Op, act,
                                                     slope, vec, tiles_x);
  }
}

}  // namespace

// x [B, H, W, C], out [B, H, W, O] (float32 or bf16); w [9][Cp][Op] in the
// same type; bias float32 [Op]. act: 0 none, 1 relu, 2 leaky relu (slope).
extern "C" int vd3d_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int C, int O, int Cp, int Op, int act,
                            float slope, int bf16, int vec, void* stream) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const int bn = Op % 64 == 0 ? 64 : (Op % 32 == 0 ? 32 : 16);
  const dim3 grid(tiles_x * tiles_y, Op / bn, B);
  cudaStream_t s = (cudaStream_t)stream;
  const float* bp = (const float*)bias;
  if (bn == 64)
    launch<64>(x, w, bp, out, grid, H, W, C, O, Cp, Op, act, slope, bf16, vec, tiles_x, s);
  else if (bn == 32)
    launch<32>(x, w, bp, out, grid, H, W, C, O, Cp, Op, act, slope, bf16, vec, tiles_x, s);
  else
    launch<16>(x, w, bp, out, grid, H, W, C, O, Cp, Op, act, slope, bf16, vec, tiles_x, s);
  return (int)cudaGetLastError();
}
