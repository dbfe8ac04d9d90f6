// Fused feather + heal post-warp pass, both eyes in one launch.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_postfx.py:
// _postfx_kernel (feather_heal_pallas). Semantics are those of
// ops/edges.py: feather_shift_edges followed by heal_missing_pixels, with
// zero padding at the image border for every blur and gradient, dx = 0 at
// column 0 and dy = 0 at row 0.
//
// Bound: device memory bytes (3 frames and 2 depths read, 2 frames
// written), but the chain is ten stencil stages deep, so what sets the time
// is how often each value is recomputed and moved through shared memory.
// The design is a row-streaming stencil:
// - A CTA owns a strip of TW output columns (128 in bf16, 96 in f32) and
//   a segment of rows, both eyes, and marches down the segment RB = 4 rows
//   per step; two CTAs share an SM. Every
//   stage of the chain (depth -> edge mask em -> vertical k-sums ->
//   horizontal k-sums and the feather lerp -> gray -> heal mask -> 5x5
//   count and the heal blend -> 3x3 soften -> output) produces RB new rows
//   per step, lagged behind the stage before it by the rows it reaches
//   down, and keeps in a shared-memory ring only the rows later stages
//   still read. Only the column halo (5 + k/2 on each side: 1.14x at
//   k = 9 and TW = 128, 1.19x at 96) and a warm-up of ceil((k + 6) / RB) steps per segment are
//   computed twice.
// - The step's input rows (both eyes, the original frame once for both,
//   both depths) come by TMA boxes into a two-stage mbarrier ring, so the
//   next step's loads run under this step's arithmetic. A box starts
//   16-byte aligned in the row (an unaligned start never completes its
//   mbarrier), so it starts a few values early; TMA fills everything
//   outside the image with zeros, which is the chain's padding. Pitches
//   TMA cannot take are loaded by the threads into the same layout.
// - Horizontal passes take runs of 4 columns per thread from 16-byte
//   aligned float4 reads; vertical passes take one column per thread.
// Rounding follows the plain version on the card op by op
// (ops/filters.py:box_blur sums the k rows first, then the k columns, each
// in order; every product and sum is rounded as the separate tensor ops
// round it, no contraction into FMAs; the gray mean is grouped as
// PyTorch's CUDA reduction groups it), so the heal mask, a threshold on a
// gradient, takes the same decisions. Two shortcuts keep that exactness
// with fewer instructions: the divisions by 9 and 25 are a product and one
// FMA correction (equal to IEEE division, see div_const), and the mask
// compares dx^2 + dy^2 with the least square whose rounded root exceeds
// the threshold. The 0/1 mask's 5x5 count is exact in any order. All
// arithmetic is float32; stores round to the image type.

#include <cmath>

#include "common.cuh"
#include "hopper.cuh"

namespace {

// The shape: the strip width depends on the image type. Two CTAs share an
// SM in both types, which f32's larger stages allow only at 96 columns;
// bf16 is fastest at 128 (chip_smoke.py --phases card,k2shapes sweeps the
// shape through these -D overrides).
#ifndef VD3D_K2_TW_BF16
#define VD3D_K2_TW_BF16 128
#endif
#ifndef VD3D_K2_TW_F32
#define VD3D_K2_TW_F32 96
#endif
#ifndef VD3D_K2_RB
#define VD3D_K2_RB 4
#endif
#ifndef VD3D_K2_CTAS
#define VD3D_K2_CTAS 2
#endif
constexpr int RB = VD3D_K2_RB;   // rows per step
constexpr int MAX_K = 15;
constexpr int CO = RB + 4;       // feathered frame ring rows (3 planes)
constexpr int CG = RB + 1;       // gray ring rows
constexpr int CM = RB + 4;       // heal mask ring rows (bytes)
constexpr int CMM = RB + 1;      // the mask's 5x5 count ring rows (bytes)
constexpr int CH = RB + 2;       // healed frame ring rows (3 planes)
constexpr int CTAS = VD3D_K2_CTAS;  // CTAs per SM the registers are capped for

template <typename T>
struct Shape {
  static constexpr int TW = sizeof(T) == 2 ? VD3D_K2_TW_BF16 : VD3D_K2_TW_F32;  // output columns per strip
  static constexpr int EP = TW + 24;  // em / V row pitch: columns c in [-4 - k/2, TW + 3 + k - 1 - k/2]
  static constexpr int NP = TW + 16;  // the other rings' row pitch: column c at c + 8
  static constexpr int RUNS = (TW + 8) / 4;  // runs of 4 columns over c in [-4, TW + 4)
  static constexpr int MAX_EW = TW + 7 + MAX_K;  // em / V columns at k = 15
  // every phase has one item per thread: runs of both eyes' RB rows, or em columns
  static constexpr int ITEMS = 2 * RB * RUNS > 2 * MAX_EW ? 2 * RB * RUNS : 2 * MAX_EW;
  static constexpr int THREADS = (ITEMS + 31) / 32 * 32;
  // a staged half row: 4-pixel runs (12 values) and 16-byte boxes (24 bf16),
  // two of them covering columns [-4, TW + 4) and the alignment shift (< 24)
  static constexpr int EH = (3 * (TW + 8) + 23 + 47) / 48 * 24;
  static constexpr int DROW = (TW + 8 + MAX_K + 7 + 7) / 8 * 8;  // staged depth row, shift included
  static_assert(EH <= 256 && DROW <= 256, "one TMA box per half row");
  static_assert(TW % 4 == 0 && RB >= 1, "runs of 4 columns");
};

template <typename T>
struct Rings {  // both eyes; the em ring (RB + k - 1 rows of EP floats) follows
  static constexpr int EP = Shape<T>::EP, NP = Shape<T>::NP;
  float v[2][RB][EP];
  float outf[2][CO][3][NP];
  float gray[2][CG][NP];
  float healed[2][CH][3][NP];
  uint8_t miss[2][CM][NP];
  uint8_t count[2][CMM][NP];
};

struct Geometry {
  int h, w, k, p, ka;  // blur_ksize, its rows above (k / 2) and below (k - 1 - k / 2)
  int strips, seg_rows, warm, steps;  // warm-up steps; steps per CTA
  int ew;              // em / V columns: TW + 7 + k
  int ce;              // em ring rows: RB + k - 1
  int es_align, ds_align;  // a staged row starts on a multiple of these values
  int tma, vec;
  int off_eye[2][2], off_frame[2], off_dep[2];  // byte offsets in a stage
  int stage_bytes, tx_bytes, bytes;
  float fs, hs, area;
  float thr_sq;  // the least dx^2 + dy^2 whose rounded square root exceeds the threshold
  int feather, heal;
};

__device__ __forceinline__ int slot(int y, int cap) {
  const int s = y % cap;
  return s < 0 ? s + cap : s;
}

// the slot d rows after the one at slot s, |d| < cap
__device__ __forceinline__ int step_slot(int s, int d, int cap) {
  s += d;
  return s < 0 ? s + cap : (s >= cap ? s - cap : s);
}

__device__ __forceinline__ int floor_to(int v, int a) {
  const int q = v >= 0 ? v / a : -((-v + a - 1) / a);
  return q * a;
}

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }
__device__ __forceinline__ void st4(float* p, const float (&v)[4]) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}

// sqrt(dx * dx + dy * dy), each step rounded as the tensor ops round it
__device__ __forceinline__ float grad_mag(float dx, float dy) {
  return __fsqrt_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)));
}

// x / c for c = 9 or 25, rounded as IEEE division rounds it: the product
// by r = RN(1 / c) and one FMA correction. For these two divisors this
// equals x / c for every float x in [0, 1024]
// (tests/test_torch_kernels.py::test_postfx_division_by_9_and_25_is_exact);
// the other divisors (k * k) take __fdiv_rn.
__device__ __forceinline__ float div_const(float x, float c, float r) {
  const float q = __fmul_rn(x, r);
  return __fmaf_rn(__fmaf_rn(-q, c, x), r, q);
}

// clamp(box_blur(mask, 5), 0, 1) from the 5x5 count of the 0/1 mask
__device__ __forceinline__ float mask_mean(int count) {
  return fminf(div_const((float)count, 25.0f, 1.0f / 25.0f), 1.0f);
}

// (1 - t) * a + t * b with t = s * m, as the plain version rounds it
__device__ __forceinline__ float blend(float a, float b, float t) {
  return __fadd_rn(__fmul_rn(__fsub_rn(1.0f, t), a), __fmul_rn(t, b));
}

// 12 consecutive staged values (4 pixels x 3 channels) from value e of row
// r of a staged region (two half-row boxes of EH values per row, at
// half[0] and half[1]); e is a multiple of 12, so the run never straddles
// the halves and starts 8-byte (bf16) or 16-byte (f32) aligned
template <typename T>
__device__ __forceinline__ void load_px12(const unsigned char* half0, const unsigned char* half1,
                                          int r, int e, float (&v)[12]) {
  constexpr int EH = Shape<T>::EH;
  const int hi = e >= EH;
  const T* p = reinterpret_cast<const T*>(hi ? half1 : half0) + r * EH + (e - hi * EH);
  if constexpr (sizeof(T) == 2) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const uint2 u = reinterpret_cast<const uint2*>(p)[j];
      const __nv_bfloat162 a = *reinterpret_cast<const __nv_bfloat162*>(&u.x);
      const __nv_bfloat162 b = *reinterpret_cast<const __nv_bfloat162*>(&u.y);
      v[4 * j] = __low2float(a), v[4 * j + 1] = __high2float(a);
      v[4 * j + 2] = __low2float(b), v[4 * j + 3] = __high2float(b);
    }
  } else {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float4 f = reinterpret_cast<const float4*>(p)[j];
      v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z, v[4 * j + 3] = f.w;
    }
  }
}

// V rows F .. F + RB - 1 of one column: the k-row sums of em in order,
// top row first (box_blur's first pass). s0: the em ring slot of row F - p.
template <typename T, int K>
__device__ __forceinline__ void vsum(const float* emcol, int s0, int ce, float* vcol) {
  constexpr int EP = Shape<T>::EP;
  float e[RB + K - 1];
  int s = s0;
#pragma unroll
  for (int i = 0; i < RB + K - 1; ++i) {
    e[i] = emcol[s * EP];
    s = s + 1 == ce ? 0 : s + 1;
  }
#pragma unroll
  for (int r = 0; r < RB; ++r) {
    float a = e[r];
#pragma unroll
    for (int t = 1; t < K; ++t) a = __fadd_rn(a, e[r + t]);
    vcol[r * EP] = a;
  }
}

// The feather weight of 4 columns: the k-column sums of V in order, left
// column first (box_blur's second pass), over k * k. vrow: V at column
// c0 - p of the run, 16-byte aligned.
template <int K>
__device__ __forceinline__ void hsum(const float* vrow, float area, float (&b)[4]) {
  constexpr int N = (K + 6) / 4 * 4;  // 4 + K - 1 values, whole float4s
  float v[N];
#pragma unroll
  for (int j = 0; j < N / 4; ++j) {
    const float4 f = ld4(vrow + 4 * j);
    v[4 * j] = f.x, v[4 * j + 1] = f.y, v[4 * j + 2] = f.z, v[4 * j + 3] = f.w;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    float a = v[q];
#pragma unroll
    for (int t = 1; t < K; ++t) a = __fadd_rn(a, v[q + t]);
    b[q] = __fdiv_rn(a, area);
  }
}

#define VD3D_K_SWITCH(k, CALL)                                                          \
  switch (k) {                                                                          \
    case 1: CALL(1); break;   case 2: CALL(2); break;   case 3: CALL(3); break;         \
    case 4: CALL(4); break;   case 5: CALL(5); break;   case 6: CALL(6); break;         \
    case 7: CALL(7); break;   case 8: CALL(8); break;   case 9: CALL(9); break;         \
    case 10: CALL(10); break; case 11: CALL(11); break; case 12: CALL(12); break;       \
    case 13: CALL(13); break; case 14: CALL(14); break; default: CALL(15); break;       \
  }

// The step's input rows into stage `st` by the threads (pitches TMA cannot
// take), in the TMA boxes' layout, zeros outside the image.
template <typename T>
__device__ void load_stage(unsigned char* st, const T* __restrict__ left,
                           const T* __restrict__ right, const T* __restrict__ frame,
                           const T* __restrict__ dleft, const T* __restrict__ dright,
                           const Geometry& G, int es, int ds, int F, int E) {
  constexpr int THREADS = Shape<T>::THREADS, EH = Shape<T>::EH, DROW = Shape<T>::DROW;
  const int w3 = 3 * G.w;
  auto rows_of = [&](const int (&off)[2], const T* src, int rows, int y0) {
    for (int i = threadIdx.x; i < 2 * rows * EH; i += THREADS) {
      const int hi = i / (rows * EH), rem = i - hi * rows * EH;
      const int r = rem / EH, e = es + hi * EH + (rem - r * EH), y = y0 + r;
      reinterpret_cast<T*>(st + off[hi])[rem] =
          (y >= 0 && y < G.h && e >= 0 && e < w3) ? src[(size_t)y * w3 + e] : T(0.0f);
    }
  };
  rows_of(G.off_eye[0], left, RB, F);
  rows_of(G.off_eye[1], right, RB, F);
  rows_of(G.off_frame, frame, RB + 2, F - 2);
  for (int eye = 0; eye < 2; ++eye) {
    T* dst = reinterpret_cast<T*>(st + G.off_dep[eye]);
    const T* src = eye ? dright : dleft;
    for (int i = threadIdx.x; i < (RB + 1) * DROW; i += THREADS) {
      const int r = i / DROW, x = ds + (i - r * DROW), y = E - 1 + r;
      dst[i] = (y >= 0 && y < G.h && x >= 0 && x < G.w) ? src[(size_t)y * G.w + x] : T(0.0f);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(Shape<T>::THREADS, CTAS)
feather_heal_kernel(const __grid_constant__ CUtensorMap map_l,
                    const __grid_constant__ CUtensorMap map_r,
                    const __grid_constant__ CUtensorMap map_f,
                    const __grid_constant__ CUtensorMap map_dl,
                    const __grid_constant__ CUtensorMap map_dr, const T* __restrict__ left,
                    const T* __restrict__ right, const T* __restrict__ frame,
                    const T* __restrict__ dleft, const T* __restrict__ dright,
                    T* __restrict__ out_left, T* __restrict__ out_right,
                    const __grid_constant__ Geometry G) {
  constexpr int TW = Shape<T>::TW, EP = Shape<T>::EP, RUNS = Shape<T>::RUNS;
  constexpr int THREADS = Shape<T>::THREADS, EH = Shape<T>::EH, DROW = Shape<T>::DROW;
  extern __shared__ unsigned char dyn[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);  // one mbarrier per stage
  unsigned char* stage0 = base + 128;
  Rings<T>& R = *reinterpret_cast<Rings<T>*>(base + 128 + 2 * G.stage_bytes);
  float* em_ring = reinterpret_cast<float*>(base + 128 + 2 * G.stage_bytes + sizeof(Rings<T>));
  const int CE = G.ce;
  {  // rows and pad columns no phase writes read as zeros
    uint32_t* z = reinterpret_cast<uint32_t*>(&R);
    const int words = (int)(sizeof(Rings<T>) / 4) + 2 * CE * EP;
    for (int i = threadIdx.x; i < words; i += THREADS) z[i] = 0u;
  }

  const int tid = threadIdx.x;
  const int strip = blockIdx.x % G.strips, seg = blockIdx.x / G.strips;
  const int x0 = strip * TW;
  const int seg0 = seg * G.seg_rows, seg1 = min(seg0 + G.seg_rows, G.h);
  const int es = floor_to(3 * (x0 - 4), G.es_align);       // first staged frame value
  const int ds = floor_to(x0 - 5 - G.p, G.ds_align);       // first staged depth column
  // step j: output rows from Rj = seg0 + (j - warm) RB; the healed rows
  // lead them by 1, the heal mask, gray and feathered rows by 3, em by
  // 3 + ka
  auto rows_out = [&](int j) { return seg0 + (j - G.warm) * RB; };
  auto stage = [&](int s) { return stage0 + s * G.stage_bytes; };

  auto prefetch = [&](int j, int s) {  // thread 0: step j's rows into stage s
    const int F = rows_out(j) + 3, E = F + G.ka;
    unsigned char* st = stage(s);
    vd3d::fence_proxy_async();
    vd3d::mbar_arrive_expect_tx(&bar[s], (uint32_t)G.tx_bytes);
    for (int b = 0; b < 2; ++b) {
      vd3d::tma_load_2d(st + G.off_eye[0][b], &map_l, &bar[s], es + b * EH, F);
      vd3d::tma_load_2d(st + G.off_eye[1][b], &map_r, &bar[s], es + b * EH, F);
      vd3d::tma_load_2d(st + G.off_frame[b], &map_f, &bar[s], es + b * EH, F - 2);
    }
    vd3d::tma_load_2d(st + G.off_dep[0], &map_dl, &bar[s], ds, E - 1);
    vd3d::tma_load_2d(st + G.off_dep[1], &map_dr, &bar[s], ds, E - 1);
  };

  if (G.tma) {
    if (tid == 0) {
      vd3d::mbar_init(&bar[0], 1);
      vd3d::mbar_init(&bar[1], 1);
      vd3d::mbar_fence_init();
      prefetch(0, 0);
    }
    __syncthreads();
  }

  for (int j = 0; j < G.steps; ++j) {
    const int Ro = rows_out(j), F = Ro + 3, E = F + G.ka, H = Ro + 1;
    // each ring's slot of its stage's first row this step
    const int sE = slot(E, CE), sO = slot(F, CO), sG = slot(F, CG), sM = slot(F, CM);
    const int sMM = slot(H, CMM), sH = slot(H, CH);
    // the warm-up's first steps compute rows no output reads: skip each
    // phase until it reaches its first needed row
    const bool need_em = E + RB > seg0 - 4 - G.p, need_f = F + RB > seg0 - 4;
    const bool need_mask = F + RB > seg0 - 3, need_heal = H + RB > seg0 - 1;
    const int s = G.tma ? (j & 1) : 0;
    const unsigned char* st = stage(s);
    if (G.tma) {
      if (tid == 0 && j + 1 < G.steps) prefetch(j + 1, s ^ 1);
      vd3d::mbar_wait(&bar[s], (uint32_t)((j >> 1) & 1));
    } else {
      load_stage(stage(0), left, right, frame, dleft, dright, G, es, ds, F, E);
      __syncthreads();
    }

    // ---- em rows E .. E + RB - 1 and V rows F .. F + RB - 1, one column
    // per thread (its em ring column is its own: no barrier between them)
    if (G.feather && need_em && tid < 2 * G.ew) {
      const int eye = tid >= G.ew, ce = tid - eye * G.ew;
      const int x = x0 + ce - 4 - G.p;
      const T* dst = reinterpret_cast<const T*>(st + G.off_dep[eye]) + (x - ds);
      float* emcol = em_ring + eye * CE * EP + ce;
      float du = vd3d::load(dst, 0);
      const bool in_x = x >= 0 && x < G.w;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        const int y = E + r;
        const float d = vd3d::load(dst, (size_t)(r + 1) * DROW);
        float em = 0.0f;
        if (in_x && y >= 0 && y < G.h) {
          const float dx = x > 0 ? __fsub_rn(d, vd3d::load(dst, (size_t)(r + 1) * DROW - 1)) : 0.0f;
          const float dy = y > 0 ? __fsub_rn(d, du) : 0.0f;
          em = fminf(fmaxf(__fmul_rn(grad_mag(dx, dy), G.fs), 0.0f), 1.0f);
        }
        emcol[step_slot(sE, r, CE) * EP] = em;
        du = d;
      }
      const int s0 = step_slot(sE, 1 - G.k, CE);  // row F - p = E - k + 1
      float* vcol = &R.v[eye][0][ce];
#define VD3D_VSUM(K) vsum<T, K>(emcol, s0, CE, vcol)
      VD3D_K_SWITCH(G.k, VD3D_VSUM)
#undef VD3D_VSUM
    }
    if (G.feather && need_em) __syncthreads();

    // ---- feathered frame, gray: rows F .., columns [-4, TW + 4)
    if (need_f && tid < 2 * RB * RUNS) {
      const int eye = tid / (RB * RUNS), rem = tid - eye * RB * RUNS;
      const int r = rem / RUNS, c0 = 4 * (rem - r * RUNS) - 4, y = F + r;
      float b[4] = {0.0f, 0.0f, 0.0f, 0.0f};
      if (G.feather) {
        const float* vrow = &R.v[eye][r][c0 + 4];
#define VD3D_HSUM(K) hsum<K>(vrow, G.area, b)
        VD3D_K_SWITCH(G.k, VD3D_HSUM)
#undef VD3D_HSUM
      }
      float a[12], o[12];
      const int e = 3 * (x0 + c0) - es;
      load_px12<T>(st + G.off_eye[eye][0], st + G.off_eye[eye][1], r, e, a);
      load_px12<T>(st + G.off_frame[0], st + G.off_frame[1], r + 2, e, o);
      float f[3][4], g[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float av = a[3 * q + ch];
          f[ch][q] = G.feather ? fminf(fmaxf(blend(av, o[3 * q + ch], b[q]), 0.0f), 1.0f) : av;
        }
        // the channel mean as PyTorch's CUDA mean takes it: two threads
        // hold r + b and g, and the sum is multiplied by fl(1 / 3)
        g[q] = __fmul_rn(__fadd_rn(__fadd_rn(f[0][q], f[2][q]), f[1][q]), 1.0f / 3.0f);
      }
      const int so = step_slot(sO, r, CO);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) st4(&R.outf[eye][so][ch][c0 + 8], f[ch]);
      st4(&R.gray[eye][step_slot(sG, r, CG)][c0 + 8], g);
    }
    __syncthreads();

    if (G.heal && need_mask) {
      // ---- heal mask: rows F .., columns [-4, TW + 4) (needed: [-3, TW + 3))
      if (tid < 2 * RB * RUNS) {
        const int eye = tid / (RB * RUNS), rem = tid - eye * RB * RUNS;
        const int r = rem / RUNS, c0 = 4 * (rem - r * RUNS) - 4, y = F + r;
        const float* grow = R.gray[eye][step_slot(sG, r, CG)];
        const float4 gv = ld4(grow + c0 + 8);
        const float4 gu = ld4(R.gray[eye][step_slot(sG, r - 1, CG)] + c0 + 8);
        const float gl = grow[c0 + 7];
        const float g[5] = {gl, gv.x, gv.y, gv.z, gv.w}, up[4] = {gu.x, gu.y, gu.z, gu.w};
        uint32_t mk = 0;  // one 0/1 byte per column
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + c0 + q;
          const float dx = x > 0 ? __fsub_rn(g[q + 1], g[q]) : 0.0f;
          const float dy = y > 0 ? __fsub_rn(g[q + 1], up[q]) : 0.0f;
          const bool in = x >= 0 && x < G.w && y >= 0 && y < G.h;
          // sqrt(s) > threshold as s >= thr_sq: the rounded square root
          // is monotone
          const float s2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
          mk |= (uint32_t)(in && s2 >= G.thr_sq) << (8 * q);
        }
        *reinterpret_cast<uint32_t*>(&R.miss[eye][step_slot(sM, r, CM)][c0 + 8]) = mk;
      }
      __syncthreads();
    }
    if (G.heal && need_heal) {
      // ---- 5x5 count of the mask and the heal blend: rows H .. (H = F - 2)
      if (tid < 2 * RB * RUNS) {
        const int eye = tid / (RB * RUNS), rem = tid - eye * RB * RUNS;
        const int r = rem / RUNS, c0 = 4 * (rem - r * RUNS) - 4, y = H + r;
        // column counts of columns c0 - 4 .. c0 + 7, one byte each (<= 5)
        uint32_t cw[3] = {0u, 0u, 0u};
#pragma unroll
        for (int dr = -2; dr <= 2; ++dr) {
          const uint32_t* mrow =
              reinterpret_cast<const uint32_t*>(&R.miss[eye][step_slot(sM, r - 2 + dr, CM)][c0 + 4]);
#pragma unroll
          for (int jj = 0; jj < 3; ++jj) cw[jj] += mrow[jj];
        }
        int cs[12];
#pragma unroll
        for (int i = 0; i < 12; ++i) cs[i] = (cw[i / 4] >> (8 * (i % 4))) & 0xff;
        float o[12];
        load_px12<T>(st + G.off_frame[0], st + G.off_frame[1], r, 3 * (x0 + c0) - es, o);
        const int so = step_slot(sO, r - 2, CO);
        float f[3][4], hv[3][4];
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) {
          const float4 v = ld4(&R.outf[eye][so][ch][c0 + 8]);
          f[ch][0] = v.x, f[ch][1] = v.y, f[ch][2] = v.z, f[ch][3] = v.w;
        }
        uint32_t counts = 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int x = x0 + c0 + q;
          const bool in = x >= 0 && x < G.w && y >= 0 && y < G.h;
          const int cnt = cs[q + 2] + cs[q + 3] + cs[q + 4] + cs[q + 5] + cs[q + 6];
          counts |= (uint32_t)cnt << (8 * q);
          const float t = __fmul_rn(G.hs, mask_mean(cnt));
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) hv[ch][q] = in ? blend(f[ch][q], o[3 * q + ch], t) : 0.0f;
        }
        *reinterpret_cast<uint32_t*>(&R.count[eye][step_slot(sMM, r, CMM)][c0 + 8]) = counts;
        const int sh = step_slot(sH, r, CH);
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) st4(&R.healed[eye][sh][ch][c0 + 8], hv[ch]);
      }
      __syncthreads();
    }

    // ---- output rows Ro .. Ro + RB - 1, columns [0, TW)
    if (tid < 2 * RB * (TW / 4)) {
      const int eye = tid / (RB * (TW / 4)), rem = tid - eye * RB * (TW / 4);
      const int r = rem / (TW / 4), c0 = 4 * (rem - r * (TW / 4)), y = Ro + r;
      const int x = x0 + c0;
      if (y >= seg0 && y < seg1 && x < G.w) {
        float v[4][3];
        if (G.heal) {
          const uint32_t counts =
              *reinterpret_cast<const uint32_t*>(&R.count[eye][step_slot(sMM, r - 1, CMM)][c0 + 8]);
          float mm[4];
#pragma unroll
          for (int q = 0; q < 4; ++q) mm[q] = mask_mean((counts >> (8 * q)) & 0xff);
          const int s_up = step_slot(sH, r - 2, CH), s_mid = step_slot(sH, r - 1, CH);
          const int s_dn = step_slot(sH, r, CH);
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            float hm[12], vs[12];  // columns c0 - 4 .. c0 + 7
#pragma unroll
            for (int jj = 0; jj < 3; ++jj) {
              const float4 a = ld4(&R.healed[eye][s_up][ch][c0 + 4 + 4 * jj]);
              const float4 b = ld4(&R.healed[eye][s_mid][ch][c0 + 4 + 4 * jj]);
              const float4 c = ld4(&R.healed[eye][s_dn][ch][c0 + 4 + 4 * jj]);
              const float av[4] = {a.x, a.y, a.z, a.w}, bv[4] = {b.x, b.y, b.z, b.w};
              const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                hm[4 * jj + i] = bv[i];
                vs[4 * jj + i] = __fadd_rn(__fadd_rn(av[i], bv[i]), cv[i]);
              }
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              const float soft =
                  div_const(__fadd_rn(__fadd_rn(vs[q + 3], vs[q + 4]), vs[q + 5]), 9.0f, 1.0f / 9.0f);
              const float t = __fmul_rn(0.3f, mm[q]);
              v[q][ch] = fminf(fmaxf(blend(hm[q + 4], soft, t), 0.0f), 1.0f);
            }
          }
        } else {
          const int so = step_slot(sO, r - 3, CO);
#pragma unroll
          for (int q = 0; q < 4; ++q)
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) v[q][ch] = R.outf[eye][so][ch][c0 + 8 + q];
        }
        T* dst = (eye ? out_right : out_left) + ((size_t)y * G.w + x) * 3;
        if (G.vec && x + 4 <= G.w) {
          if constexpr (sizeof(T) == 2) {
            uint32_t u[6];
#pragma unroll
            for (int i = 0; i < 6; ++i) {
              const __nv_bfloat162 bb = __floats2bfloat162_rn(v[(2 * i) / 3][(2 * i) % 3],
                                                              v[(2 * i + 1) / 3][(2 * i + 1) % 3]);
              u[i] = *reinterpret_cast<const uint32_t*>(&bb);
            }
#pragma unroll
            for (int i = 0; i < 3; ++i)
              reinterpret_cast<uint2*>(dst)[i] = make_uint2(u[2 * i], u[2 * i + 1]);
          } else {
#pragma unroll
            for (int i = 0; i < 3; ++i)
              reinterpret_cast<float4*>(dst)[i] =
                  make_float4(v[(4 * i) / 3][(4 * i) % 3], v[(4 * i + 1) / 3][(4 * i + 1) % 3],
                              v[(4 * i + 2) / 3][(4 * i + 2) % 3],
                              v[(4 * i + 3) / 3][(4 * i + 3) % 3]);
          }
        } else {
          const int n = min(4, G.w - x);
          for (int q = 0; q < n; ++q)
#pragma unroll
            for (int ch = 0; ch < 3; ++ch) vd3d::store(dst, q * 3 + ch, v[q][ch]);
        }
      }
    }
    __syncthreads();  // the stage and the rows later steps overwrite are free
  }
}

int round128(int b) { return (b + 127) / 128 * 128; }

// G holds everything but what depends on the shape, which this fills in
template <typename T>
int launch(const void* left, const void* right, const void* frame, const void* dleft,
           const void* dright, void* out_left, void* out_right, Geometry G, cudaStream_t s) {
  constexpr int TW = Shape<T>::TW, EP = Shape<T>::EP, THREADS = Shape<T>::THREADS;
  constexpr int EH = Shape<T>::EH, DROW = Shape<T>::DROW, size = sizeof(T);
  G.strips = (G.w + TW - 1) / TW;
  G.ew = TW + 7 + G.k;
  // a stage: each eye's rows F .. F + RB - 1 and the frame's F - 2 ..
  // F + RB - 1 as two half-row boxes, each depth's E - 1 .. E + RB - 1
  int off = 0;
  for (int e = 0; e < 2; ++e)
    for (int b = 0; b < 2; ++b) {
      G.off_eye[e][b] = off;
      off += round128(RB * EH * size);
    }
  for (int b = 0; b < 2; ++b) {
    G.off_frame[b] = off;
    off += round128((RB + 2) * EH * size);
  }
  for (int e = 0; e < 2; ++e) {
    G.off_dep[e] = off;
    off += round128((RB + 1) * DROW * size);
  }
  G.stage_bytes = off;
  G.tx_bytes = (4 * RB * EH + 2 * (RB + 2) * EH + 2 * (RB + 1) * DROW) * size;
  G.bytes = 128 /* alignment */ + 128 /* mbarriers */ + 2 * G.stage_bytes + (int)sizeof(Rings<T>) +
            2 * G.ce * EP * 4 /* the em ring */;
  const auto kern = feather_heal_kernel<T>;
  // per device: the attribute, the SM count and the CTAs per SM by blur
  // size (the em ring's rows)
  static int sms_of[vd3d::MAX_DEVICES] = {};
  static int per_sm_of[vd3d::MAX_DEVICES][MAX_K + 1] = {};
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  int* per_sm = per_sm_of[dev];
  if (sms == 0) {
    int n = 0;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         G.bytes + (MAX_K - G.k) * 2 * EP * 4);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms = n;
  }
  if (per_sm[G.k] == 0) {
    cudaError_t e =
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[G.k], kern, THREADS, G.bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[G.k] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  // segments: as many as fill the card in one wave, a multiple of RB rows each
  const int row_steps = (G.h + RB - 1) / RB;
  int segs = per_sm[G.k] * sms / G.strips;
  segs = segs < 1 ? 1 : (segs > row_steps ? row_steps : segs);
  const int seg_steps = (row_steps + segs - 1) / segs;
  G.seg_rows = seg_steps * RB;
  segs = (G.h + G.seg_rows - 1) / G.seg_rows;
  G.steps = G.warm + seg_steps;
  CUtensorMap maps[5] = {};
  if (G.tma) {
    const bool bf16 = sizeof(T) == 2;
    const void* frames[3] = {left, right, frame};
    const cuuint32_t box_rows[3] = {RB, RB, RB + 2};
    for (int i = 0; i < 3; ++i)
      if (!vd3d::encode_map_2d(&maps[i], frames[i], bf16, (cuuint64_t)G.w * 3, (cuuint64_t)G.h,
                               (cuuint64_t)G.w * 3 * sizeof(T), EH, box_rows[i]))
        return (int)cudaErrorInvalidValue;
    const void* depths[2] = {dleft, dright};
    for (int i = 0; i < 2; ++i)
      if (!vd3d::encode_map_2d(&maps[3 + i], depths[i], bf16, (cuuint64_t)G.w, (cuuint64_t)G.h,
                               (cuuint64_t)G.w * sizeof(T), DROW, RB + 1))
        return (int)cudaErrorInvalidValue;
  }
  kern<<<G.strips * segs, THREADS, G.bytes, s>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], (const T*)left, (const T*)right,
      (const T*)frame, (const T*)dleft, (const T*)dright, (T*)out_left, (T*)out_right, G);
  return (int)cudaGetLastError();
}

}  // namespace

// left/right/frame/out [H, W, 3], dleft/dright [H, W]: one image type
// (float32, or bfloat16 with bf16 = 1), contiguous. 1 <= ksize <= 15.
extern "C" int vd3d_feather_heal(const void* left, const void* right,
                                 const void* frame, const void* dleft,
                                 const void* dright, void* out_left,
                                 void* out_right, int h, int w, int ksize,
                                 float feather_strength, float heal_strength,
                                 float heal_threshold, int do_feather,
                                 int do_heal, int bf16, void* stream) {
  if (ksize < 1 || ksize > MAX_K || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
  const int size = bf16 ? 2 : 4;
  Geometry G = {};
  G.h = h;
  G.w = w;
  G.k = ksize;
  G.p = ksize / 2;
  G.ka = ksize - 1 - G.p;
  G.warm = (ksize + 6 + RB - 1) / RB;
  G.ce = RB + ksize - 1;
  G.es_align = bf16 ? 24 : 12;  // 4 pixels and 16 bytes
  G.ds_align = 16 / size;
  auto aligned = [](const void* p) { return ((size_t)p & 15) == 0; };
  G.tma = ((size_t)w * 3 * size) % 16 == 0 && ((size_t)w * size) % 16 == 0 && aligned(left) &&
          aligned(right) && aligned(frame) && aligned(dleft) && aligned(dright);
  G.vec = w % 4 == 0 && aligned(out_left) && aligned(out_right);
  G.fs = feather_strength;
  G.hs = heal_strength;
  // the least s >= 0 with RN(sqrt(s)) > heal_threshold (host sqrtf is the
  // same IEEE square root as the kernel's): the mask is s >= thr_sq
  // (NaN where no square root exceeds it)
  float t2 = heal_threshold > 0.0f ? heal_threshold * heal_threshold : 0.0f;
  if (!(heal_threshold < INFINITY)) {
    t2 = NAN;
  } else {
    while (t2 > 0.0f && sqrtf(t2) > heal_threshold) t2 = nextafterf(t2, 0.0f);
    while (!(sqrtf(t2) > heal_threshold)) t2 = nextafterf(t2, INFINITY);
  }
  G.thr_sq = t2;
  G.area = (float)(ksize * ksize);
  G.feather = do_feather;
  G.heal = do_heal;
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(left, right, frame, dleft, dright, out_left, out_right, G, s);
  return launch<float>(left, right, frame, dleft, dright, out_left, out_right, G, s);
}
