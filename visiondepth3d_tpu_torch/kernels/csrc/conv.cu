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
// - float32 (conv3x3_tf32_kernel; the tools' default type): the same
//   implicit GEMM on the tensor cores in split TF32 (hopper.cuh): each
//   product is three TF32 products of explicit halves, small x big + big x
//   small + big x big, accumulated in float32, which keeps float32
//   accuracy. One persistent block per SM walks output tiles of 8 x 32
//   pixels (M = 256: each consumer warpgroup two M blocks of 64 pixels, so
//   each weight tile in shared memory serves twice as many pixels) and BN
//   output channels, its ring running on from tile to tile, so the next
//   tile's copies overlap this one's last products and its epilogue (with
//   one block of up to 211 KB an SM nothing else would hide them: the RIFE
//   and tail convs have one to four chunks a tile); K walks chunks of FCK = 16
//   channels (64 bytes a window pixel, 64-byte swizzle) times the nine
//   taps. The ring stage holds the chunk's 10 x 34 x 16
//   window (TMA, zero fill as SAME padding) and its weights' two halves,
//   pre-split by pack_conv3x3 (one bulk copy). The consumers split the
//   landed window once (big in place, small into a buffer of its own):
//   every window value serves up to nine taps, and a split per tap would
//   repeat its CUDA-core work nine times. Each tap's A fragments (the
//   window shifted by one pixel; ldmatrix is for 16-bit elements) are
//   loaded by hand while the previous tap's products run: the weights' K
//   order puts a thread's two fragment columns of a k8 step on adjacent
//   channels, one 8-byte load per pixel and half. wgmma m64nBNk8 takes B
//   from the weights' halves. A producer warpgroup (one warp of it issues
//   the copies) hands its registers to the consumers (setmaxnreg). Inputs
//   whose pixel stride TMA cannot take (C = 3) are loaded by the consumers,
//   split as they land; O = 3 runs on an 8-wide N tile. Numerics: an add
//   inside the tensor cores does not round to nearest, and with every
//   product of every chunk added into one accumulator the error grew with
//   K (measured on the H100: max 8.1e-5, mean 9.6e-6 at rdb_conv5, against
//   the float32 FMA kernel's 1.4e-5 and 6.8e-7). So each chunk's products
//   go into a partial, added to the running sum on the CUDA cores: 1.5e-5
//   and 9.1e-7.

// What bounds it on the H100: the RDB conv5 (C=192 -> O=64) does 1,728 MACs
// per output channel on 384 bytes of input and 128 of output per pixel in
// bf16, 432 FLOP/byte, above the card's 295 FLOP/byte ridge: operations.
// The RDB conv1 (64 -> 32) does 192 FLOP/byte: bytes. What the design does
// about it: wgmma takes the products at the tensor cores' rate; the window
// is read once per block and reused by nine taps and every output channel;
// the copies of one chunk overlap the products of the other; the output is
// written once (no im2col buffer in device memory). The weights are read
// again by every block (36 KB per chunk at BN = 64 in bf16, 72 KB for the
// two float32 halves of a 16-channel chunk, from L2). In float32 each
// product is three TF32 products, a third of TF32's 495 TFLOP/s (165): the
// RDB convs stay bound by operations (conv5 3.5 ms at that rate); the
// window's split (once a chunk) and the fragment loads (each tap) run on
// the CUDA cores and the shared-memory pipe beside the products, and at
// O = 3 (an 8-wide N tile) they, not the products, set the pace.

// Weights, as the wrapper (kernels/conv.py) packs them:
// - bfloat16: [O / BN][Cp / 32][9][BN][32] with Cp, O rounded up to 32 and
//   BN, zero padded; in each 64-byte row (one output channel) the 16-byte
//   group j of 8 input channels sits at j ^ ((n >> 1) & 3), n the row's
//   channel in the block: the 64-byte swizzle of the shared-memory tile.
// - float32: [O / BN][Cp / 16][2][9][BN][16], Cp rounded up to 16, O to BN:
//   per block and chunk of 16 input channels the big then the small TF32
//   half of the nine taps' [BN][16] tiles, the channels of each 8 in the K
//   order 0, 2, 4, 6, 1, 3, 5, 7 (a thread's A columns t and t + 4 are
//   channels 2 t and 2 t + 1), each 64-byte row swizzled as in bf16
//   (16-byte group j of 4 at j ^ ((n >> 1) & 3)).
// The bias is float32, one per padded output channel.

#include <cstring>

#include "common.cuh"
#include "hopper.cuh"

namespace {

__device__ __forceinline__ float activate(float v, int act, float slope) {
  if (act == 1) return fmaxf(v, 0.0f);
  if (act == 2) return v >= 0.0f ? v : v * slope;
  return v;
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

constexpr int FCK = 16;  // float32: input channels per chunk, 64 bytes per window pixel
constexpr int FTH = 8;   // float32: output rows per block
constexpr int FTW = 32;  // float32: output columns per block
constexpr int FWH = FTH + 2, FWW = FTW + 2;
constexpr int F_WIN_BYTES = FWH * FWW * FCK * 4;

template <int BN>
struct ConvSmemF32 {
  static constexpr int PLANE = 9 * BN * FCK * 4;  // one chunk's weights, one TF32 half
  static constexpr int WIN = 0;                   // the landed window, its big half in place
  static constexpr int W = round1024(F_WIN_BYTES);
  static constexpr int STAGE = W + round1024(2 * PLANE);
  static constexpr int WIN_SMALL = STAGES * STAGE;  // the window's small half (one buffer)
  static constexpr int BAR = WIN_SMALL + round1024(F_WIN_BYTES);
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;  // + alignment slack
};

// two consumer warpgroups and a producer warpgroup (one warp of it issues
// the copies), which hands its registers to the consumers
constexpr int F_THREADS = 3 * 128;

// float32: the chunk's input window by the 256 consumer threads, split as it
// lands: its big half in the layout the TMA load writes ([FWH * FWW][FCK],
// 64-byte swizzle), its small half in the same layout in win_small; for
// inputs whose pixel stride TMA cannot take
__device__ __forceinline__ void load_window_threads_f32(const float* __restrict__ x,
                                                        uint32_t win, uint32_t win_small,
                                                        int b, int y0, int x0, int c0, int H,
                                                        int W, int C, int xs) {
  for (int e = threadIdx.x; e < FWH * FWW * 4; e += 256) {
    const int p = e / 4, j = e % 4;
    const int gy = y0 - 1 + p / FWW, gx = x0 - 1 + p % FWW;
    const int c = c0 + 4 * j;
    float v[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    if (gy >= 0 && gy < H && gx >= 0 && gx < W && c < C) {
      const float* src = x + (((size_t)b * H + gy) * W + gx) * xs + c;
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (c + q < C) v[q] = src[q];
    }
    const uint32_t off = vd3d::swizzle<64>(p * 64 + j * 16);
    uint4 small;
    const uint4 big = vd3d::split_tf32(make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]),
                                                  __float_as_uint(v[2]), __float_as_uint(v[3])),
                                       small);
    vd3d::sts128(win + off, big);
    vd3d::sts128(win_small + off, small);
  }
}

// float32: the landed window's halves, big in place, small into win_small
__device__ __forceinline__ void split_window(uint32_t win, uint32_t win_small) {
  for (int i = threadIdx.x; i < F_WIN_BYTES / 16; i += 256) {
    uint4 small;
    vd3d::sts128(win + 16 * i, vd3d::split_tf32(vd3d::lds128(win + 16 * i), small));
    vd3d::sts128(win_small + 16 * i, small);
  }
}

// the output tile t of a persistent block: N blocks fastest (the blocks of
// one pixel tile read the same window, so they run side by side), then
// tile columns, tile rows, images
struct TileF32 {
  int y0, x0, nb, b;
};
__device__ __forceinline__ TileF32 tile_f32(int t, int nblk, int tiles_x, int tiles_y) {
  const int nb = t % nblk;
  t /= nblk;
  const int tx = t % tiles_x;
  t /= tiles_x;
  return {(t % tiles_y) * FTH, tx * FTW, nb, t / tiles_y};
}

template <int BN>
__global__ void __launch_bounds__(F_THREADS, 1)
conv3x3_tf32_kernel(const __grid_constant__ CUtensorMap mx, const float* __restrict__ x,
                    const float* __restrict__ w, const float* __restrict__ bias,
                    float* __restrict__ out, int H, int W, int C, int xs, int O, int os,
                    int nchunks, int act, float slope, int tma, int pair, int nblk,
                    int tiles_x, int tiles_y, int n_tiles) {
  using namespace vd3d;
  using L = ConvSmemF32<BN>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::BAR);
  uint64_t* empty = full + STAGES;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 8);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  // a persistent block: tiles blockIdx.x, + gridDim.x, ...; the ring runs
  // on across tiles (q counts the block's chunks), so the next tile's
  // copies overlap this tile's last products and its epilogue
  if (warp >= 8) {  // the producer warpgroup
    setmaxnreg_dec<40>();
    if (warp == 8 && lane == 0) {
      int q = 0;
      for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
        const TileF32 tl = tile_f32(t, nblk, tiles_x, tiles_y);
        const float* wb = w + (size_t)tl.nb * nchunks * 2 * 9 * BN * FCK;
        for (int i = 0; i < nchunks; ++i, ++q) {
          const int s = q % STAGES;
          if (q >= STAGES) mbar_wait(&empty[s], (q / STAGES - 1) & 1);
          unsigned char* stage = smem + s * L::STAGE;
          mbar_arrive_expect_tx(&full[s], (tma ? F_WIN_BYTES : 0) + 2 * L::PLANE);
          if (tma)
            tma_load_4d(stage + L::WIN, &mx, &full[s], i * FCK, tl.x0 - 1, tl.y0 - 1, tl.b);
          bulk_load(stage + L::W, wb + (size_t)i * 2 * 9 * BN * FCK, 2 * L::PLANE, &full[s]);
        }
      }
    }
    return;
  }
  setmaxnreg_inc<232>();

  // a consumer warp: in M block mb (64 pixels, two tile rows) of warpgroup
  // g, 16 pixels of tile row rw + 2 mb from column cb; this thread's A
  // fragment rows are pixels px and px + 8. Its columns t4 and t4 + 4 of a
  // k8 step are channels 2 t4 and 2 t4 + 1 (pack_conv3x3 orders the
  // weights' K to match), one 8-byte load per pixel and half
  const int g = warp / 4, wl = warp % 4;
  const int rw = 4 * g + wl / 2, cb = 16 * (wl % 2);
  const int t4 = lane % 4, px = cb + lane / 4;
  const uint32_t win_small = smem_u32(smem + L::WIN_SMALL);
  // window byte offset of (pixel p, channels 2 t4, 2 t4 + 1) in k8 step 0;
  // step 1 is 32 bytes on, which the 64-byte swizzle turns into ^ 32
  auto a_off = [&](int p) { return swizzle<64>(p * 64 + t4 * 8); };
  uint32_t fb[2][2][4], fs[2][2][4];  // A fragments [M block][k8 step], big and small

  int q = 0;
  for (int t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const TileF32 tl = tile_f32(t, nblk, tiles_x, tiles_y);
    float acc[2][BN / 2];
#pragma unroll
    for (int mb = 0; mb < 2; ++mb)
#pragma unroll
      for (int i = 0; i < BN / 2; ++i) acc[mb][i] = 0.0f;

    for (int i = 0; i < nchunks; ++i, ++q) {
      // the chunk's products go into a partial of their own, added to acc
      // with round-to-nearest adds: an add in the tensor cores does not
      // round to nearest, and its error (up to an ulp of the accumulator)
      // would otherwise grow with every product of every chunk
      float part[2][BN / 2];
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) part[mb][j] = 0.0f;
      const int s = q % STAGES;
      mbar_wait(&full[s], (q / STAGES) & 1);
      unsigned char* stage = smem + s * L::STAGE;
      const uint32_t win = smem_u32(stage + L::WIN), wts = smem_u32(stage + L::W);
      // both warpgroups are past the last chunk's taps, so win_small is free
      named_barrier(1, 256);
      if (tma) split_window(win, win_small);
      else load_window_threads_f32(x, win, win_small, tl.b, tl.y0, tl.x0, i * FCK, H, W, C, xs);
      named_barrier(1, 256);

      // 18 steps (tap, M block): each loads its A fragments (the window
      // shifted by the tap; both halves) into the M block's registers once
      // the products of that block's previous step are done, while the
      // other block's products run
#pragma unroll
      for (int step = 0; step < 18; ++step) {
        const int tap = step / 2, mb = step % 2;
        if (step >= 2) {
          wgmma_wait<1>();
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            fence_regs(fb[mb][ks]);
            fence_regs(fs[mb][ks]);
          }
        }
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const uint32_t off = a_off((rw + 2 * mb + tap / 3) * FWW + px + 8 * hr + tap % 3);
#pragma unroll
          for (int ks = 0; ks < 2; ++ks) {
            const uint2 vb = lds64(win + (off ^ (32 * ks)));
            const uint2 vs = lds64(win_small + (off ^ (32 * ks)));
            fb[mb][ks][hr] = vb.x;
            fb[mb][ks][2 + hr] = vb.y;
            fs[mb][ks][hr] = vs.x;
            fs[mb][ks][2 + hr] = vs.y;
          }
        }
        wgmma_fence();
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          const uint32_t off = tap * BN * 64 + ks * 32;
          const uint64_t db = smem_desc<64>(wts + off, 16, 512);
          const uint64_t ds = smem_desc<64>(wts + L::PLANE + off, 16, 512);
          wgmma_tf32_rs<BN>(part[mb], fs[mb][ks], db);
          wgmma_tf32_rs<BN>(part[mb], fb[mb][ks], ds);
          wgmma_tf32_rs<BN>(part[mb], fb[mb][ks], db);
        }
        wgmma_commit();
      }
      wgmma_wait<0>();
#pragma unroll
      for (int mb = 0; mb < 2; ++mb) {
        fence_regs(part[mb]);
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[mb][j] += part[mb][j];
      }
#pragma unroll
      for (int mb = 0; mb < 2; ++mb)
#pragma unroll
        for (int ks = 0; ks < 2; ++ks) {
          fence_regs(fb[mb][ks]);
          fence_regs(fs[mb][ks]);
        }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);
    }

    // epilogue: bias, activation; rows lane / 4 and + 8 of the warp's 16
    // pixels, channels c2, c2 + 1 of every 8-channel block
    const int c2 = 2 * t4;
#pragma unroll
    for (int mb = 0; mb < 2; ++mb) {
      const int gy = tl.y0 + rw + 2 * mb;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = tl.nb * BN + 8 * j + c2;
        const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
        for (int hr = 0; hr < 2; ++hr) {
          const int gx = tl.x0 + px + 8 * hr;
          if (gy >= H || gx >= W) continue;
          const float v0 = activate(acc[mb][4 * j + 2 * hr] + b0, act, slope);
          const float v1 = activate(acc[mb][4 * j + 2 * hr + 1] + b1, act, slope);
          float* dst = out + (((size_t)tl.b * H + gy) * W + gx) * os + n;
          if (pair && n + 1 < O) {
            *reinterpret_cast<float2*>(dst) = make_float2(v0, v1);
          } else {
            if (n < O) dst[0] = v0;
            if (n + 1 < O) dst[1] = v1;
          }
        }
      }
    }
  }
}

template <int BN>
int launch_tf32(const void* x, const void* w, const float* bias, void* out, int B, int H,
                int W, int C, int xs, int O, int os, int nchunks, int nblk, int act,
                float slope, cudaStream_t s) {
  using L = ConvSmemF32<BN>;
  const int tiles_x = (W + FTW - 1) / FTW, tiles_y = (H + FTH - 1) / FTH;
  const int tma = (uintptr_t)x % 16 == 0 && (xs * 4) % 16 == 0 && C >= FCK;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  if (tma) {
    const cuuint64_t dims[4] = {(cuuint64_t)C, (cuuint64_t)W, (cuuint64_t)H, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)xs * 4, (cuuint64_t)W * xs * 4,
                                   (cuuint64_t)H * W * xs * 4};
    const cuuint32_t box[4] = {FCK, FWW, FWH, 1};
    if (!vd3d::encode_map_4d(&map, x, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_64B,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
  }
  const int pair = (uintptr_t)out % 8 == 0 && os % 2 == 0;
  // the attribute and the SM count, per device: one persistent block an SM
  static int sms[vd3d::MAX_DEVICES] = {};
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (sms[dev] == 0) {
    cudaError_t e = cudaFuncSetAttribute(conv3x3_tf32_kernel<BN>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, L::BYTES);
    if (e == cudaSuccess)
      e = cudaDeviceGetAttribute(&sms[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
  }
  const long long n_tiles = (long long)tiles_x * tiles_y * nblk * B;
  if (n_tiles > 0x7fffffff) return (int)cudaErrorInvalidValue;
  const int grid = (int)(n_tiles < sms[dev] ? n_tiles : sms[dev]);
  conv3x3_tf32_kernel<BN><<<grid, F_THREADS, L::BYTES, s>>>(
      map, (const float*)x, (const float*)w, bias, (float*)out, H, W, C, xs, O, os, nchunks,
      act, slope, tma, pair, nblk, tiles_x, tiles_y, (int)n_tiles);
  return (int)cudaGetLastError();
}

}  // namespace

// x [B, H, W, >= C] with pixels xs values apart, out [B, H, W, >= O] with
// pixels os values apart (float32 or bf16); w and bias as packed above
// (bf16: Cp = 32 * chunks; float32: Cp = 16 * chunks; Op = bn * blocks).
// act: 0 none, 1 relu, 2 leaky relu (slope).
extern "C" int vd3d_conv3x3(const void* x, const void* w, const void* bias, void* out,
                            int B, int H, int W, int C, int xs, int O, int os, int Cp, int Op,
                            int bn, int act, float slope, int bf16, void* stream) {
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
  const int nchunks = Cp / FCK, nblk = Op / bn;
#define VD3D_CONV_TF32(BN) \
  launch_tf32<BN>(x, w, bp, out, B, H, W, C, xs, O, os, nchunks, nblk, act, slope, s)
  switch (bn) {
    case 8: return VD3D_CONV_TF32(8);
    case 16: return VD3D_CONV_TF32(16);
    case 32: return VD3D_CONV_TF32(32);
    case 64: return VD3D_CONV_TF32(64);
    default: return (int)cudaErrorInvalidValue;
  }
#undef VD3D_CONV_TF32
}
