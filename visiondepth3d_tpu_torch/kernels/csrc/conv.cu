// 3x3 stride-1 SAME convolution, NHWC, with fused bias and activation.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_conv.py:_conv3_kernel
// (conv3x3_pallas): the convs of the Real-ESRGAN RRDB trunk and tail and of
// the RIFE residual blocks. It is an implicit GEMM: M = B*H*W output pixels,
// N = O output channels, K = 9*C (the nine taps of each channel chunk).
// Accumulation is float32; bias (rounded to the input type by the wrapper,
// as the Pallas kernel does) and the activation are added in float32, and
// the result is rounded once to the output type. The input may be a
// channel slice of a wider NHWC tensor (pixels xs values apart) and the
// output is written into one (pixels os values apart), so the dense blocks
// of the RRDB trunk read and write one buffer in place.
//
// - bfloat16 (conv3x3_wgmma_kernel): a block owns a 4 x 32 tile of output
//   pixels of one image (M = 128: two consumer warpgroups of 64 pixels)
//   and BN output channels (N = 8, 16, 32 or 64; all of them up to 64).
//   K walks chunks of CK = 32 input channels times the nine taps. One
//   producer warp fills a ring of two stages, each the chunk's 6 x 34 x 32
//   input window (the tile plus a 1-pixel halo; a TMA tiled load over NHWC
//   whose out-of-bounds zero fill is exactly SAME padding, 64-byte
//   swizzle) and the chunk's weights [9][BN][CK] (one bulk copy of the
//   layout pack_conv3x3 writes, pre-swizzled); the consumers release a
//   stage once its products are done. Operand A of each tap is the window
//   shifted by one pixel, which does not land on wgmma's shared-memory
//   grid, so each warp loads its 16 x 16 A fragments with ldmatrix (the
//   swizzle keeps them free of bank conflicts) and wgmma m64nBNk16 takes A
//   from registers and B from a shared-memory descriptor; the next tap's
//   fragments load while the current tap's products run. Where the input's
//   pixel stride is not a multiple of 16 bytes (conv_first, C = 3) the
//   consumers load the window themselves.
// - float32 (conv3x3_fma_kernel): CUDA-core FMAs in full float32 (no TF32)
//   over 8 x 32 tiles, one chunk of 8 channels at a time; each thread owns
//   one tile column (8 pixels) and BN/8 channels.
//
// What bounds it on the H100: the RDB conv5 (C=192 -> O=64) does 1,728 MACs
// per output channel on 384 bytes of input and 128 of output per pixel in
// bf16, 432 FLOP/byte, above the card's 295 FLOP/byte ridge: operations.
// The RDB conv1 (64 -> 32) does 192 FLOP/byte: bytes. What the design does
// about it: wgmma takes the products at the tensor cores' rate; the window
// is read once per block and reused by nine taps and every output channel;
// the copies of one chunk overlap the products of the other; the output is
// written once (no im2col buffer in device memory). The weights are read
// again by every block (36 KB per chunk at BN = 64, from L2).
//
// Weights, as the wrapper (kernels/conv.py) packs them:
// - bfloat16: [O / BN][Cp / 32][9][BN][32] with Cp, O rounded up to 32 and
//   BN, zero padded; in each 64-byte row (one output channel) the 16-byte
//   group j of 8 input channels sits at j ^ ((n >> 1) & 3), n the row's
//   channel in the block: the 64-byte swizzle of the shared-memory tile.
// - float32: [9][Cp][Op] with Cp, Op rounded up to 16.
// The bias is float32, one per padded output channel.

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TH = 8;   // float32: output rows per block
constexpr int TW = 32;  // float32: output columns per block
constexpr int WIN_H = TH + 2;
constexpr int WIN_W = TW + 2;
constexpr int THREADS = 256;

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v >= 0.0f ? v : v * slope;
  return v;
}

// float32: the WIN_H x WIN_W x CK input window for channels [c0, c0 + CK)
// into s, laid out [WIN_H * WIN_W][CK]; zero outside the image and past C.
// Pixels are xs values apart. With vec, C and xs are multiples of the
// 16-byte vector and x is 16-byte aligned.
template <typename T, int CK>
__device__ __forceinline__ void load_window(const T* __restrict__ x, T* __restrict__ s,
                                            int b, int y0, int x0, int c0, int H, int W,
                                            int C, int xs, int vec) {
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
        v = *reinterpret_cast<const uint4*>(x + (((size_t)b * H + gy) * W + gx) * xs + c);
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
        v = vd3d::load(x, (((size_t)b * H + gy) * W + gx) * xs + c);
      vd3d::store(s, e, v);
    }
  }
}

// float32: weights [9][Cp][Op] rows c0..c0+CK, columns n0..n0+BN into s as
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

constexpr int CK = 32;           // input channels per chunk: 64 bytes per window pixel
constexpr int GTH = 4;           // output rows per block
constexpr int GTW = 32;          // output columns per block
constexpr int GWH = GTH + 2, GWW = GTW + 2;
constexpr int STAGES = 2;
constexpr int G_THREADS = 2 * 128 + 32;  // two consumer warpgroups, one producer warp
constexpr int WIN_BYTES = GWH * GWW * CK * 2;

__host__ __device__ constexpr int round1024(int n) { return (n + 1023) / 1024 * 1024; }

template <int BN>
struct ConvSmem {
  static constexpr int WTS = 9 * BN * CK * 2;  // one chunk's weights
  static constexpr int WIN = 0;
  static constexpr int W = round1024(WIN_BYTES);
  static constexpr int STAGE = W + round1024(WTS);
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + alignment slack
};

template <int BN>
__device__ __forceinline__ void mma_step(float (&acc)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t desc_b) {
  if constexpr (BN == 8) vd3d::wgmma_rs_n8<0>(acc, a, desc_b);
  else if constexpr (BN == 16) vd3d::wgmma_rs_n16<0>(acc, a, desc_b);
  else if constexpr (BN == 32) vd3d::wgmma_rs_n32<0>(acc, a, desc_b);
  else vd3d::wgmma_rs_n64<0>(acc, a, desc_b);
}

// The chunk's input window by the 256 consumer threads, in the layout the
// TMA load writes ([GWH * GWW][CK], 64-byte swizzle), for inputs whose pixel
// stride TMA cannot take.
__device__ __forceinline__ void load_window_threads(const __nv_bfloat16* __restrict__ x,
                                                    unsigned char* win, int b, int y0, int x0,
                                                    int c0, int H, int W, int C, int xs) {
  const unsigned short* xr = reinterpret_cast<const unsigned short*>(x);
  for (int e = threadIdx.x; e < GWH * GWW * 4; e += 256) {
    const int p = e / 4, j = e % 4;
    const int gy = y0 - 1 + p / GWW, gx = x0 - 1 + p % GWW;
    const int c = c0 + 8 * j;
    uint32_t v[4] = {0u, 0u, 0u, 0u};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
      const unsigned short* src = xr + (((size_t)b * H + gy) * W + gx) * xs + c;
#pragma unroll
      for (int q = 0; q < 8; ++q)
        if (c + q < C) v[q / 2] |= (uint32_t)src[q] << (16 * (q % 2));
    }
    *reinterpret_cast<uint4*>(win + vd3d::swizzle<64>(p * 64 + j * 16)) =
        make_uint4(v[0], v[1], v[2], v[3]);
  }
}

template <int BN>
__global__ void __launch_bounds__(G_THREADS, 2)
conv3x3_wgmma_kernel(const __grid_constant__ CUtensorMap mx, const __nv_bfloat16* __restrict__ x,
                     const __nv_bfloat16* __restrict__ w, const float* __restrict__ bias,
                     __nv_bfloat16* __restrict__ out, int H, int W, int C, int xs, int O,
                     int os, int nchunks, int act, float slope, int tma, int pair,
                     int tiles_x) {
  using namespace vd3d;
  using L = ConvSmem<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  const int y0 = (blockIdx.x / tiles_x) * GTH;
  const int x0 = (blockIdx.x % tiles_x) * GTW;
  const int nb = blockIdx.y, b = blockIdx.z;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == 8) {  // the producer warp
    if (lane == 0) {
      const __nv_bfloat16* wb = w + (size_t)nb * nchunks * 9 * BN * CK;
      for (int i = 0; i < nchunks; ++i) {
        const int s = i % STAGES;
        if (i >= STAGES) mbar_wait(&empty[s], (i / STAGES - 1) & 1);
        unsigned char* stage = smem + s * L::STAGE;
        mbar_arrive_expect_tx(&full[s], (tma ? WIN_BYTES : 0) + L::WTS);
        if (tma) tma_load_4d(stage + L::WIN, &mx, &full[s], i * CK, x0 - 1, y0 - 1, b);
        bulk_load(stage + L::W, wb + (size_t)i * 9 * BN * CK, L::WTS, &full[s]);
      }
    }
    return;
  }

  // a consumer warp: 16 pixels of tile row R from column cb; lane gives the
  // ldmatrix row address of matrix lane / 8 (pixels 0-7 or 8-15, channels
  // 0-7 or 8-15 of the k16 step), row lane % 8
  const int g = warp / 4, wl = warp % 4;
  const int R = 2 * g + wl / 2, cb = 16 * (wl % 2);
  const int mi = lane / 8;
  const int px = cb + (mi & 1) * 8 + lane % 8, kh = mi >> 1;

  float acc[BN / 2];
#pragma unroll
  for (int i = 0; i < BN / 2; ++i) acc[i] = 0.0f;

  for (int i = 0; i < nchunks; ++i) {
    const int s = i % STAGES;
    mbar_wait(&full[s], (i / STAGES) & 1);
    unsigned char* stage = smem + s * L::STAGE;
    if (!tma) {
      load_window_threads(x, stage + L::WIN, b, y0, x0, i * CK, H, W, C, xs);
      asm volatile("bar.sync 1, 256;" ::: "memory");
    }
    const uint32_t win = smem_u32(stage + L::WIN), wts = smem_u32(stage + L::W);
    auto a_addr = [&](int tap, int ks) {
      const int p = (R + tap / 3) * GWW + px + tap % 3;
      return win + swizzle<64>(p * 64 + (2 * ks + kh) * 16);
    };
    uint32_t a[2][2][4];  // [tap parity][k16 step]
    ldmatrix_x4(a[0][0], a_addr(0, 0));
    ldmatrix_x4(a[0][1], a_addr(0, 1));
#pragma unroll
    for (int tap = 0; tap < 9; ++tap) {
      const int cur = tap & 1;
      wgmma_fence();
#pragma unroll
      for (int ks = 0; ks < 2; ++ks)
        mma_step<BN>(acc, a[cur][ks], smem_desc<64>(wts + tap * BN * CK * 2 + ks * 32, 16, 512));
      wgmma_commit();
      if (tap < 8) {  // the next tap's fragments, once the previous tap's products are done
        wgmma_wait<1>();
        fence_regs(a[cur ^ 1][0]);
        fence_regs(a[cur ^ 1][1]);
        ldmatrix_x4(a[cur ^ 1][0], a_addr(tap + 1, 0));
        ldmatrix_x4(a[cur ^ 1][1], a_addr(tap + 1, 1));
      }
    }
    wgmma_wait<0>();
    fence_regs(acc);
    fence_regs(a[0][0]);
    fence_regs(a[0][1]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  // epilogue: bias, activation, one rounding; rows lane / 4 and + 8 of the
  // warp's 16 pixels, channels c2, c2 + 1 of every 8-channel block
  const int gy = y0 + R;
  const int c2 = 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int n = nb * BN + 8 * j + c2;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int hr = 0; hr < 2; ++hr) {
      const int gx = x0 + cb + lane / 4 + 8 * hr;
      if (gy >= H || gx >= W) continue;
      const float v0 = activate(acc[4 * j + 2 * hr] + b0, act, slope);
      const float v1 = activate(acc[4 * j + 2 * hr + 1] + b1, act, slope);
      __nv_bfloat16* dst = out + (((size_t)b * H + gy) * W + gx) * os + n;
      if (pair && n + 1 < O) {
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(v0, v1);
      } else {
        if (n < O) dst[0] = __float2bfloat16_rn(v0);
        if (n + 1 < O) dst[1] = __float2bfloat16_rn(v1);
      }
    }
  }
}

template <int BN>
int launch_wgmma(const void* x, const void* w, const float* bias, void* out, int B, int H,
                 int W, int C, int xs, int O, int os, int nchunks, int nblk, int act,
                 float slope, cudaStream_t s) {
  using L = ConvSmem<BN>;
  const int tiles_x = (W + GTW - 1) / GTW, tiles_y = (H + GTH - 1) / GTH;
  const int tma = (uintptr_t)x % 16 == 0 && (xs * 2) % 16 == 0 && C >= CK;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)xs * 2, (cuuint64_t)W * xs * 2,
                                   (cuuint64_t)H * W * xs * 2};
    const cuuint32_t box[4] = {CK, GWW, GWH, 1};
    if (!vd3d::encode_map_4d(&map, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B))
      return (int)cudaErrorInvalidValue;
  }
  const int pair = (uintptr_t)out % 4 == 0 && os % 2 == 0;
  static bool configured[vd3d::MAX_DEVICES] = {};  // the attribute, per device
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_wgmma_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  const dim3 grid(tiles_x * tiles_y, nblk, B);
  conv3x3_wgmma_kernel<BN><<<grid, G_THREADS, L::BYTES, s>>>(
      map, (const __nv_bfloat16*)x, (const __nv_bfloat16*)w, bias, (__nv_bfloat16*)out, H, W,
      C, xs, O, os, nchunks, act, slope, tma, pair, tiles_x);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- float32

template <int BN>
__global__ void __launch_bounds__(THREADS)
conv3x3_fma_kernel(const float* __restrict__ x, const float* __restrict__ w,
                   const float* __restrict__ bias, float* __restrict__ out, int H, int W,
                   int C, int xs, int O, int os, int Cp, int Op, int act, float slope, int vec,
                   int tiles_x) {
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
    load_window<float, CK>(x, sA, b, y0, x0, c0, H, W, C, xs, vec);
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
        out[(((size_t)b * H + gy) * W + gx) * os + n] = activate(acc[r][j] + bias[n], act, slope);
    }
  }
}

template <int BN>
int launch_fma(const void* x, const void* w, const float* bias, void* out, int B, int H, int W,
               int C, int xs, int O, int os, int Cp, int Op, int act, float slope, int vec,
               cudaStream_t s) {
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles_y = (H + TH - 1) / TH;
  const dim3 grid(tiles_x * tiles_y, Op / BN, B);
  conv3x3_fma_kernel<BN><<<grid, THREADS, 0, s>>>((const float*)x, (const float*)w, bias,
                                                   (float*)out, H, W, C, xs, O, os, Cp, Op, act,
                                                   slope, vec, tiles_x);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, >= C] with pixels xs values apart, out [B, H, W, >= O] with
// pixels os values apart (float32 or bf16); w and bias as packed above
// (bf16: Cp = 32 * chunks, Op = BN * blocks; float32: Cp, Op rounded up to
// 16, bn unused). act: 0 none, 1 relu, 2 leaky relu (slope). vec: the
// float32 input may be read in 16-byte vectors.
extern "C" int vd3d_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int C, int xs, int O, int os, int Cp, int Op,
                            int bn, int act, float slope, int bf16, int vec, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* bp = (const float*)bias;
  if (bf16) {
    const int nchunks = Cp / CK, nblk = Op / bn;
#define VD3D_CONV_WGMMA(BN) \
  launch_wgmma<BN>(x, w, bp, out, B, H, W, C, xs, O, os, nchunks, nblk, act, slope, s)
    switch (bn) {
      case 8: return VD3D_CONV_WGMMA(8);
      case 16: return VD3D_CONV_WGMMA(16);
      case 32: return VD3D_CONV_WGMMA(32);
      case 64: return VD3D_CONV_WGMMA(64);
      default: return (int)cudaErrorInvalidValue;
    }
#undef VD3D_CONV_WGMMA
  }
#define VD3D_CONV_FMA(BN) \
  launch_fma<BN>(x, w, bp, out, B, H, W, C, xs, O, os, Cp, Op, act, slope, vec, s)
  const int fbn = Op % 64 == 0 ? 64 : (Op % 32 == 0 ? 32 : 16);
  if (fbn == 64) return VD3D_CONV_FMA(64);
  if (fbn == 32) return VD3D_CONV_FMA(32);
  return VD3D_CONV_FMA(16);
#undef VD3D_CONV_FMA
}
