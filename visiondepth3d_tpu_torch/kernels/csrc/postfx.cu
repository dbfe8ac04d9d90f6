// Fused feather + heal post-warp pass, both eyes in one launch.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_postfx.py:
// _postfx_kernel (feather_heal_pallas). Semantics are those of
// ops/edges.py: feather_shift_edges followed by heal_missing_pixels, with
// zero padding at the image border for every blur and gradient, dx = 0 at
// column 0 and dy = 0 at row 0.
//
// As separate tensor ops the chain streams each frame through device memory
// about a dozen times (gradient, k x k blur, lerp, gray gradient, 5x5 blur,
// lerp, 3x3 blur, lerp). Here one block owns a TILE_H x TILE_W output tile
// of one eye (grid z = eye) and keeps every intermediate in shared memory:
// it reads the warped depth over the tile plus a halo of 5 + k/2 (the
// stencil chain's reach), the warped and original frames over the tile
// plus 4, and writes the tile once. Bound: device memory bytes; the halo
// re-reads are served from L2. All arithmetic is float32; stores round to
// the image type.

#include "common.cuh"

namespace {

constexpr int TILE_H = 16;
constexpr int TILE_W = 32;
constexpr int MAX_KH = 7;  // blur_ksize <= 15
constexpr int THREADS = 256;
// regions, as halos around the tile:
//   E: edge mask em            halo 4 + kh   (kh = blur_ksize / 2)
//   B: feathered frame out_f   halo 4        (grad 1 + blur5 2 + blur3 1)
//   C: heal mask "missing"     halo 3
//   D: blurred mask m, healed  halo 1
constexpr int E_H = TILE_H + 2 * (4 + MAX_KH), E_W = TILE_W + 2 * (4 + MAX_KH);
constexpr int B_H = TILE_H + 8, B_W = TILE_W + 8;
constexpr int C_H = TILE_H + 6, C_W = TILE_W + 6;
constexpr int D_H = TILE_H + 2, D_W = TILE_W + 2;

template <typename T>
__global__ void __launch_bounds__(THREADS)
feather_heal_kernel(const T* __restrict__ left, const T* __restrict__ right,
                    const T* __restrict__ frame, const T* __restrict__ dleft,
                    const T* __restrict__ dright, T* __restrict__ out_left,
                    T* __restrict__ out_right, int h, int w, int ksize,
                    float feather_strength, float heal_strength,
                    float heal_threshold, int do_feather, int do_heal) {
  __shared__ float em[E_H * E_W];
  __shared__ float rowsum[E_H * B_W];
  __shared__ float outf[3 * B_H * B_W];
  __shared__ float missing[C_H * C_W];
  __shared__ float mask[D_H * D_W];
  __shared__ float healed[3 * D_H * D_W];

  const int eye = blockIdx.z;
  const T* warped = eye ? right : left;
  const T* dwarp = eye ? dright : dleft;
  T* out = eye ? out_right : out_left;
  const int oy = blockIdx.y * TILE_H, ox = blockIdx.x * TILE_W;
  const int tid = threadIdx.x;
  const int kh = ksize / 2;
  const int he = 4 + kh;                      // E halo
  const int eh = TILE_H + 2 * he, ew = TILE_W + 2 * he;

  auto inside = [&](int y, int x) { return y >= 0 && y < h && x >= 0 && x < w; };

  // ---- feather: em over E, k-window sums, out_f over B ----
  if (do_feather) {
    for (int i = tid; i < eh * ew; i += THREADS) {
      const int y = oy - he + i / ew, x = ox - he + i % ew;
      float v = 0.0f;
      if (inside(y, x)) {
        const size_t p = (size_t)y * w + x;
        const float d = vd3d::load(dwarp, p);
        const float dx = x > 0 ? d - vd3d::load(dwarp, p - 1) : 0.0f;
        const float dy = y > 0 ? d - vd3d::load(dwarp, p - w) : 0.0f;
        v = fminf(fmaxf(sqrtf(dx * dx + dy * dy) * feather_strength, 0.0f), 1.0f);
      }
      em[i] = v;
    }
    __syncthreads();
    // horizontal k-sums for rows of E, columns of B (B col j = E col j + kh)
    for (int i = tid; i < eh * B_W; i += THREADS) {
      const int r = i / B_W, c = i % B_W;
      float s = 0.0f;
      for (int o = 0; o < ksize; ++o) s += em[r * ew + c + o];
      rowsum[i] = s;
    }
    __syncthreads();
  }
  const float area = (float)(ksize * ksize);
  for (int i = tid; i < B_H * B_W; i += THREADS) {
    const int r = i / B_W, c = i % B_W;
    const int y = oy - 4 + r, x = ox - 4 + c;
    if (!inside(y, x)) {
      outf[i] = outf[B_H * B_W + i] = outf[2 * B_H * B_W + i] = 0.0f;
      continue;
    }
    const size_t p = (size_t)y * w + x;
    float blend = 0.0f;
    if (do_feather) {
      float s = 0.0f;
      for (int o = 0; o < ksize; ++o) s += rowsum[(r + o) * B_W + c];
      blend = s / area;
    }
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float a = vd3d::load(warped, p * 3 + ch);
      float v = a;
      if (do_feather) {
        const float o = vd3d::load(frame, p * 3 + ch);
        v = fminf(fmaxf(a * (1.0f - blend) + o * blend, 0.0f), 1.0f);
      }
      outf[ch * B_H * B_W + i] = v;
    }
  }
  __syncthreads();

  if (!do_heal) {
    for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
      const int r = i / TILE_W, c = i % TILE_W;
      const int y = oy + r, x = ox + c;
      if (!inside(y, x)) continue;
      const size_t p = (size_t)y * w + x;
      const int b = (r + 4) * B_W + c + 4;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) vd3d::store(out, p * 3 + ch, outf[ch * B_H * B_W + b]);
    }
    return;
  }

  // ---- heal: gray gradient threshold over C ----
  for (int i = tid; i < C_H * C_W; i += THREADS) {
    const int r = i / C_W, c = i % C_W;
    const int y = oy - 3 + r, x = ox - 3 + c;
    float v = 0.0f;
    if (inside(y, x)) {
      const int b = (r + 1) * B_W + c + 1;  // same pixel in B
      auto gray = [&](int j) {
        return (outf[j] + outf[B_H * B_W + j] + outf[2 * B_H * B_W + j]) / 3.0f;
      };
      const float g = gray(b);
      const float dx = x > 0 ? g - gray(b - 1) : 0.0f;
      const float dy = y > 0 ? g - gray(b - B_W) : 0.0f;
      v = sqrtf(dx * dx + dy * dy) > heal_threshold ? 1.0f : 0.0f;
    }
    missing[i] = v;
  }
  __syncthreads();
  // 5x5 mean of the mask over D, then the heal blend
  for (int i = tid; i < D_H * D_W; i += THREADS) {
    const int r = i / D_W, c = i % D_W;
    const int y = oy - 1 + r, x = ox - 1 + c;
    if (!inside(y, x)) {
      mask[i] = 0.0f;
      healed[i] = healed[D_H * D_W + i] = healed[2 * D_H * D_W + i] = 0.0f;
      continue;
    }
    float s = 0.0f;
    for (int dr = 0; dr < 5; ++dr)
      for (int dc = 0; dc < 5; ++dc) s += missing[(r + dr) * C_W + c + dc];
    const float m = fminf(s / 25.0f, 1.0f);
    mask[i] = m;
    const size_t p = (size_t)y * w + x;
    const int b = (r + 3) * B_W + c + 3;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float o = vd3d::load(frame, p * 3 + ch);
      healed[ch * D_H * D_W + i] =
          (1.0f - heal_strength * m) * outf[ch * B_H * B_W + b] + heal_strength * m * o;
    }
  }
  __syncthreads();
  // 3x3 soften of the healed frame, blended by 0.3 * m, over the tile
  for (int i = tid; i < TILE_H * TILE_W; i += THREADS) {
    const int r = i / TILE_W, c = i % TILE_W;
    const int y = oy + r, x = ox + c;
    if (!inside(y, x)) continue;
    const size_t p = (size_t)y * w + x;
    const int d = (r + 1) * D_W + c + 1;
    const float m = mask[d];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* hp = healed + ch * D_H * D_W;
      float s = 0.0f;
      for (int dr = -1; dr <= 1; ++dr)
        for (int dc = -1; dc <= 1; ++dc) s += hp[d + dr * D_W + dc];
      const float v = (1.0f - 0.3f * m) * hp[d] + 0.3f * m * (s / 9.0f);
      vd3d::store(out, p * 3 + ch, fminf(fmaxf(v, 0.0f), 1.0f));
    }
  }
}

}  // namespace

extern "C" int vd3d_feather_heal(const void* left, const void* right,
                                 const void* frame, const void* dleft,
                                 const void* dright, void* out_left,
                                 void* out_right, int h, int w, int ksize,
                                 float feather_strength, float heal_strength,
                                 float heal_threshold, int do_feather,
                                 int do_heal, int bf16, void* stream) {
  if (ksize < 1 || ksize / 2 > MAX_KH) return (int)cudaErrorInvalidValue;
  const dim3 grid((w + TILE_W - 1) / TILE_W, (h + TILE_H - 1) / TILE_H, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    feather_heal_kernel<T><<<grid, THREADS, 0, s>>>(
        (const T*)left, (const T*)right, (const T*)frame, (const T*)dleft,
        (const T*)dright, (T*)out_left, (T*)out_right, h, w, ksize,
        feather_strength, heal_strength, heal_threshold, do_feather, do_heal);
  } else {
    feather_heal_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)left, (const float*)right, (const float*)frame,
        (const float*)dleft, (const float*)dright, (float*)out_left,
        (float*)out_right, h, w, ksize, feather_strength, heal_strength,
        heal_threshold, do_feather, do_heal);
  }
  return (int)cudaGetLastError();
}
