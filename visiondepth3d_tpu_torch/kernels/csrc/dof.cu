// Fused depth of field + color grade, both eyes in one launch.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_dof.py:
// dof_grade_pallas (_dof_kernel). Semantics are those of ops/dof.py:
// apply_dof (an LOD stack of separable Gaussian blurs with reflect padding,
// rows first, then a per-pixel lerp between the two levels that the blur
// index |depth - focal| / focus_width selects) followed by
// ops/grade.py:apply_color_grade, for each eye.
//
// As separate tensor ops every blur level streams the frame through device
// memory twice per tap (9 + 9 taps at sigma 2), and the lerp and the grade
// once more each. Here one block owns a TH x TW output tile of one eye
// (grid z = eye): it loads the tile plus a `reach`-wide halo once, through
// reflect indexing (no padded copy in device memory, unlike the TPU
// version), runs each level's vertical pass from shared memory into a
// second shared buffer and the horizontal pass per pixel in registers,
// accumulates the two selected levels, grades, and writes the tile once.
// Bound: at sigma 2 about 110 float32 operations per value against 28
// bytes per pixel in bf16, so the CUDA-core arithmetic, not device memory,
// is the floor (PERF.md). All arithmetic is float32; stores round once to
// the image type. The focal depth is read from device memory (a tracker's
// output), never from the host.

#include "common.cuh"

namespace {

constexpr int TH = 16;
constexpr int TW = 32;
constexpr int THREADS = 256;
constexpr int MAX_REACH = 10;   // dof_strength <= 5: ceil(2 * 5)
constexpr int MAX_LEVELS = 8;
constexpr int MAX_TAPS = 2 * MAX_REACH + 1;
constexpr int IH = TH + 2 * MAX_REACH;
constexpr int IW = TW + 2 * MAX_REACH;
constexpr int PIX = (TH * TW) / THREADS;  // output pixels per thread
static_assert(MAX_LEVELS * MAX_TAPS <= THREADS, "one thread per tap copies the taps");

struct DofParams {
  float taps[MAX_LEVELS][MAX_TAPS];  // level l: 2 * half[l] + 1 weights
  int half[MAX_LEVELS];              // 0: the unblurred level
  int n;                             // levels
  int reach;                         // max half
  float fw_eps;                      // focus_width + 1e-6
  float idx_max;                     // n - 1 - 1e-6
  float sat, con, bri;
  int grade;
};

// jnp.pad(mode="reflect"): index -1 reads 1, n reads n - 2; periodic beyond
__device__ __forceinline__ int reflect(int i, int n) {
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i >= n ? p - i : i;
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
dof_grade_kernel(const T* __restrict__ left, const T* __restrict__ right,
                 const float* __restrict__ depth, const float* __restrict__ focal,
                 T* __restrict__ out_left, T* __restrict__ out_right, int h, int w,
                 const DofParams P) {
  __shared__ float tile[3][IH][IW];
  __shared__ float sv[3][TH][IW];
  // the taps in shared memory: indexing the parameter block with a run-time
  // index would give every thread a local copy of it
  __shared__ float stap[MAX_LEVELS][MAX_TAPS];
  __shared__ int shalf[MAX_LEVELS];

  const int eye = blockIdx.z;
  const T* src = eye ? right : left;
  T* dst = eye ? out_right : out_left;
  const int oy = blockIdx.y * TH, ox = blockIdx.x * TW;
  const int tid = threadIdx.x;
  const int R = P.reach;
  const int ih = TH + 2 * R, iw = TW + 2 * R;

  // constant indices after unrolling: each read is one constant-bank load
#pragma unroll
  for (int i = 0; i < MAX_LEVELS * MAX_TAPS; ++i)
    if (i == tid) stap[i / MAX_TAPS][i % MAX_TAPS] = P.taps[i / MAX_TAPS][i % MAX_TAPS];
#pragma unroll
  for (int i = 0; i < MAX_LEVELS; ++i)
    if (i == tid) shalf[i] = P.half[i];
  for (int i = tid; i < ih * iw; i += THREADS) {
    const int r = i / iw, c = i % iw;
    const size_t p = (size_t)reflect(oy - R + r, h) * w + reflect(ox - R + c, w);
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) tile[ch][r][c] = vd3d::load(src, p * 3 + ch);
  }

  // blur index of this thread's pixels (ops/dof.py:apply_dof)
  const float f = *focal;
  int lower[PIX];
  float alpha[PIX], acc[PIX][3];
#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int j = tid + k * THREADS;
    const int y = oy + j / TW, x = ox + j % TW;
    lower[k] = -2;  // outside the image: no level matches
    alpha[k] = 0.0f;
    acc[k][0] = acc[k][1] = acc[k][2] = 0.0f;
    if (y < h && x < w) {
      const float diff = fabsf(depth[(size_t)y * w + x] - f);
      const float bw = fminf(fmaxf(diff / P.fw_eps, 0.0f), 1.0f);
      const float idx = fminf(fmaxf(bw * (float)(P.n - 1), 0.0f), P.idx_max);
      const float lo = fminf(fmaxf(floorf(idx), 0.0f), (float)(P.n - 2));
      lower[k] = (int)lo;
      alpha[k] = idx - lo;
    }
  }
  __syncthreads();

  for (int l = 0; l < P.n; ++l) {
    const int hf = shalf[l];
    const float* tp = stap[l];
    if (hf > 0) {
      // vertical pass over rows of the tile, columns of the tile +- hf
      const int cols = TW + 2 * hf, c0 = R - hf;
      for (int i = tid; i < TH * cols; i += THREADS) {
        const int r = i / cols, c = c0 + i % cols;
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          float s = 0.0f;
          for (int t = 0; t <= 2 * hf; ++t) s += tp[t] * tile[ch][r + R - hf + t][c];
          sv[ch][r][c] = s;
        }
      }
      __syncthreads();
    }
#pragma unroll
    for (int k = 0; k < PIX; ++k) {
      float wgt;
      if (lower[k] == l) wgt = 1.0f - alpha[k];
      else if (lower[k] == l - 1) wgt = alpha[k];
      else continue;
      const int j = tid + k * THREADS;
      const int r = j / TW, c = j % TW;
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        float v;
        if (hf == 0) {
          v = tile[ch][r + R][c + R];
        } else {
          v = 0.0f;
          for (int t = 0; t <= 2 * hf; ++t) v += tp[t] * sv[ch][r][c + R - hf + t];
        }
        acc[k][ch] += v * wgt;
      }
    }
    if (hf > 0) __syncthreads();  // sv is rewritten by the next level
  }

#pragma unroll
  for (int k = 0; k < PIX; ++k) {
    const int j = tid + k * THREADS;
    const int y = oy + j / TW, x = ox + j % TW;
    if (y >= h || x >= w) continue;
    float o[3];
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) o[ch] = fminf(fmaxf(acc[k][ch], 0.0f), 1.0f);
    if (P.grade) {
      const float luma = 0.2126f * o[0] + 0.7152f * o[1] + 0.0722f * o[2];
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) {
        const float s = luma + (o[ch] - luma) * P.sat;
        const float c = 0.5f + (s - 0.5f) * P.con;
        o[ch] = fminf(fmaxf(c + P.bri, 0.0f), 1.0f);
      }
    }
    const size_t p = (size_t)y * w + x;
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) vd3d::store(dst, p * 3 + ch, o[ch]);
  }
}

}  // namespace

// left/right/out [H, W, 3] float32 or bf16; depth [H, W] float32; focal one
// float32 on the device. taps [n][2 * MAX_REACH + 1] and halves [n] are
// host arrays (copied into the kernel's parameter block).
extern "C" int vd3d_dof_grade(const void* left, const void* right, const void* depth,
                              const void* focal, void* out_left, void* out_right, int h,
                              int w, const float* taps, const int* halves, int n,
                              float fw_eps, float idx_max, float sat, float con, float bri,
                              int grade, int bf16, void* stream) {
  if (n < 2 || n > MAX_LEVELS) return (int)cudaErrorInvalidValue;
  DofParams P = {};
  P.n = n;
  P.reach = 0;
  for (int l = 0; l < n; ++l) {
    if (halves[l] < 0 || halves[l] > MAX_REACH) return (int)cudaErrorInvalidValue;
    P.half[l] = halves[l];
    P.reach = halves[l] > P.reach ? halves[l] : P.reach;
    for (int t = 0; t < MAX_TAPS; ++t) P.taps[l][t] = taps[l * MAX_TAPS + t];
  }
  P.fw_eps = fw_eps;
  P.idx_max = idx_max;
  P.sat = sat;
  P.con = con;
  P.bri = bri;
  P.grade = grade;
  const dim3 grid((w + TW - 1) / TW, (h + TH - 1) / TH, 2);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16) {
    using T = __nv_bfloat16;
    dof_grade_kernel<T><<<grid, THREADS, 0, s>>>(
        (const T*)left, (const T*)right, (const float*)depth, (const float*)focal,
        (T*)out_left, (T*)out_right, h, w, P);
  } else {
    dof_grade_kernel<float><<<grid, THREADS, 0, s>>>(
        (const float*)left, (const float*)right, (const float*)depth, (const float*)focal,
        (float*)out_left, (float*)out_right, h, w, P);
  }
  return (int)cudaGetLastError();
}
