// Dual-eye bounded-disparity DIBR warp.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_warp.py:_warp_kernel
// (stereo_warp_pallas). On the TPU the lane-axis gather was slow, so that
// kernel swept every tap of the disparity bound with lane rolls. Here a
// gather is cheap: the hat weight is nonzero at two taps only, so each
// thread reads the shift once, works out both eyes' source columns in
// float32, and does a 2-tap gather of the frame (3 channels) and the shaped
// depth per eye. Bound: device memory bytes (one read of frame, depth and
// shift, four writes); the row's taps are adjacent, so the gathers stay in
// the same cache lines as the coalesced neighbours' reads.
//
// Positions are float32 whatever the image type: bf16 cannot resolve
// column indices past 256.

#include "common.cuh"

namespace {

template <typename T>
__device__ __forceinline__ void warp_eye(const T* __restrict__ frame,
                                         const T* __restrict__ depth,
                                         size_t row, float src, int w,
                                         T* __restrict__ out, T* __restrict__ dout,
                                         size_t px) {
  const float wm1 = (float)(w - 1);
  src = fminf(fmaxf(src, 0.0f), wm1);
  int x0 = (int)floorf(src);
  x0 = min(max(x0, 0), w - 1);
  const int x1 = min(x0 + 1, w - 1);
  const float frac = src - (float)x0;
  const float keep = 1.0f - frac;
  const size_t p0 = row + x0, p1 = row + x1;
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float a = vd3d::load(frame, p0 * 3 + c);
    const float b = vd3d::load(frame, p1 * 3 + c);
    vd3d::store(out, px * 3 + c, a * keep + b * frac);
  }
  vd3d::store(dout, px, vd3d::load(depth, p0) * keep + vd3d::load(depth, p1) * frac);
}

template <typename T>
__global__ void stereo_warp_kernel(const T* __restrict__ frame,
                                   const T* __restrict__ depth,
                                   const float* __restrict__ shift,
                                   T* __restrict__ left, T* __restrict__ right,
                                   T* __restrict__ dleft, T* __restrict__ dright,
                                   int h, int w) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y;
  if (x >= w || y >= h) return;
  const size_t row = (size_t)y * w;
  const size_t px = row + x;
  // shift * (W - 1) / 2 in this order, as the plain version computes it
  const float delta = shift[px] * (float)(w - 1) / 2.0f;
  const float xf = (float)x;
  warp_eye(frame, depth, row, xf + delta, w, left, dleft, px);
  warp_eye(frame, depth, row, xf - delta, w, right, dright, px);
}

}  // namespace

extern "C" int vd3d_stereo_warp(const void* frame, const void* depth,
                                const void* shift, void* left, void* right,
                                void* dleft, void* dright, int h, int w,
                                int bf16, void* stream) {
  const dim3 block(256);
  const dim3 grid((w + block.x - 1) / block.x, h);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    stereo_warp_kernel<T><<<grid, block, 0, s>>>(
        (const T*)frame, (const T*)depth, (const float*)shift, (T*)left,
        (T*)right, (T*)dleft, (T*)dright, h, w);
  } else {
    stereo_warp_kernel<float><<<grid, block, 0, s>>>(
        (const float*)frame, (const float*)depth, (const float*)shift,
        (float*)left, (float*)right, (float*)dleft, (float*)dright, h, w);
  }
  return (int)cudaGetLastError();
}
