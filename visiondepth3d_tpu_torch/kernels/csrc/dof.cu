// Fused depth of field + color grade, both eyes in one launch.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_dof.py:
// dof_grade_pallas (_dof_kernel). Semantics are those of ops/dof.py:
// apply_dof (an LOD stack of separable Gaussian blurs with reflect padding,
// rows first, then a per-pixel lerp between the two levels that the blur
// index |depth - focal| / focus_width selects) followed by
// ops/grade.py:apply_color_grade, for each eye.
//
// Bound: at sigma 2 about 110 float32 operations per value against 28
// bytes per pixel in bf16, so the CUDA-core arithmetic, not device memory,
// is the floor (PERF.md). The design spends arithmetic only where a pixel
// reads it and feeds it from shared memory without waiting:
// - Persistent CTAs walk 32x64-pixel tiles of both eyes. A tile's window
//   (the tile and a `reach`-wide halo, [32 + 2R] rows x [(64 + 2R) * 3]
//   interleaved values) comes by one TMA box over the eye's [H, W * 3]
//   view into a two-stage mbarrier ring, so the next tile's load runs
//   under this tile's arithmetic. Border tiles (where reflect padding
//   applies) and rows whose pitch is no multiple of 16 bytes are loaded by
//   the threads through reflect indexing into the same layout.
// - Only the levels a tile reads are blurred: a block reduction of the
//   pixels' lower level indices gives [lmin, lmax + 1]; every other level
//   has weight 0 at every pixel of the tile, so the sum is unchanged.
// - Both separable passes are register-blocked: a thread of the vertical
//   pass slides down 16 rows of one (column, channel) of the window and
//   keeps the 16 outputs in registers (32 rows spilled at 128 registers); a
//   thread of the horizontal pass slides across 8 pixels of a row. Each
//   shared value is read once per strip, with no bank conflicts (odd row
//   pitch, planes 11 apart mod 32). The tap loops are unrolled per
//   half-width (1 .. 10). Symmetric taps are not paired: a pair costs an
//   add and an FMA, the same two instructions as two FMAs.
// All arithmetic is float32; stores round once to the image type. The
// focal depth is read from device memory (a tracker's output), never from
// the host.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int TH = 32;
constexpr int TW = 64;
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int PX = 8;  // pixels of one row per thread
constexpr int RS = 16;  // rows per strip of the vertical pass
constexpr int MAX_REACH = 10;  // dof_strength <= 5: ceil(2 * 5)
constexpr int MAX_LEVELS = 8;
constexpr int MAX_TAPS = 2 * MAX_REACH + 1;
constexpr unsigned FULL = 0xffffffffu;
static_assert(MAX_LEVELS * MAX_TAPS <= THREADS, "one thread per tap copies the taps");
static_assert(TH * TW == PX * THREADS, "8 pixels per thread");

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

// The call's geometry and shared-memory layout (set from its reach).
struct Geometry {
  int h, w, tiles_x, per_eye, total;
  int tma;          // interior tiles come by TMA
  int vec;          // outputs take 16-byte stores
  int bh, bw;       // the window: rows, elements per row (padded to 16 bytes)
  int shift;        // the window's first element in a row: TMA boxes start 16-byte aligned
  int win_bytes;    // the window part of a ring stage, a multiple of 128
  int stage_bytes;  // window + the tile's depth
  int svp, pl;      // vertical-pass output: row pitch (odd), plane (11 mod 32), floats
  int bytes;        // dynamic shared memory
};

// jnp.pad(mode="reflect"): index -1 reads 1, n reads n - 2; periodic beyond
__device__ __forceinline__ int reflect(int i, int n) {
  if ((unsigned)i < (unsigned)n) return i;
  if (n == 1) return 0;
  const int p = 2 * (n - 1);
  i %= p;
  if (i < 0) i += p;
  return i >= n ? p - i : i;
}

// the window (through reflect indexing) and depth of a tile that TMA does
// not load (a border tile, or any tile of a row pitch TMA cannot take), in
// the layout the TMA boxes give
template <typename T>
__device__ void load_tile(T* win, float* sdep, const T* __restrict__ src,
                          const float* __restrict__ depth, int oy, int ox, int R,
                          const Geometry& G) {
  const int w3 = (TW + 2 * R) * 3;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int i = warp; i < G.bh; i += WARPS) {
    const T* row = src + (size_t)reflect(oy - R + i, G.h) * G.w * 3;
    T* dst = win + i * G.bw;
#pragma unroll 4
    for (int q = lane; q < w3; q += 32) {
      const int px = q / 3;
      dst[q] = row[reflect(ox - R + px, G.w) * 3 + (q - 3 * px)];
    }
  }
  for (int e = threadIdx.x; e < TH * TW; e += THREADS) {
    const int y = oy + e / TW, x = ox + e % TW;
    sdep[e] = (y < G.h && x < G.w) ? __ldg(depth + (size_t)y * G.w + x) : 0.0f;
  }
}

// the lerp weight of level l at pixel k: lower indices packed 3 bits each
// (7: outside the image), alpha the fraction toward lower + 1
__device__ __forceinline__ float level_weight(uint32_t lowers, const float (&alpha)[PX], int k,
                                              int l) {
  const int lo = (lowers >> (3 * k)) & 7;
  return (lo == l ? 1.0f - alpha[k] : 0.0f) + (lo == l - 1 ? alpha[k] : 0.0f);
}

// One level of the stack into the thread's accumulators: the vertical pass
// (window -> sv), the horizontal pass (sv -> registers) and the lerp.
template <typename T, int HF>
__device__ __forceinline__ void blur_level(const T* win, float* sv, const float* taps, int l,
                                           int R, const Geometry& G, int pr, int pc,
                                           uint32_t lowers, const float (&alpha)[PX],
                                           float (&acc)[PX][3]) {
  if constexpr (HF == 0) {
    const T* p = win + (pr + R) * G.bw + (pc + R) * 3;
#pragma unroll
    for (int k = 0; k < PX; ++k) {
      const float wgt = level_weight(lowers, alpha, k, l);
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) acc[k][ch] = fmaf(vd3d::load(p, k * 3 + ch), wgt, acc[k][ch]);
    }
  } else {
    constexpr int NT = 2 * HF + 1;
    float tp[NT];
#pragma unroll
    for (int t = 0; t < NT; ++t) tp[t] = taps[t];
    // vertical: item i takes window column (R - HF) + (i % COLS) / 3,
    // channel i % 3, output rows (i / COLS) * RS .. + RS - 1
    constexpr int COLS = 3 * (TW + 2 * HF);
    for (int item = threadIdx.x; item < COLS * (TH / RS); item += THREADS) {
      const int strip = item / COLS, ci = item - strip * COLS;
      const T* col = win + (R - HF + strip * RS) * G.bw + (R - HF) * 3 + ci;
      float* dst = sv + (ci % 3) * G.pl + strip * RS * G.svp + (R - HF) + ci / 3;
      float o[RS];
#pragma unroll
      for (int r = 0; r < RS; ++r) o[r] = 0.0f;
#pragma unroll
      for (int i = 0; i < RS + 2 * HF; ++i) {
        const float v = vd3d::load(col, (size_t)i * G.bw);
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int r = i - t;
          if (r >= 0 && r < RS) o[r] = fmaf(tp[t], v, o[r]);
        }
      }
#pragma unroll
      for (int r = 0; r < RS; ++r) dst[r * G.svp] = o[r];
    }
    __syncthreads();
    // horizontal over this thread's 8 pixels, then the lerp
#pragma unroll
    for (int ch = 0; ch < 3; ++ch) {
      const float* row = sv + ch * G.pl + pr * G.svp + pc + R - HF;
      float o[PX];
#pragma unroll
      for (int k = 0; k < PX; ++k) o[k] = 0.0f;
#pragma unroll
      for (int i = 0; i < PX + 2 * HF; ++i) {
        const float v = row[i];
#pragma unroll
        for (int t = 0; t < NT; ++t) {
          const int k = i - t;
          if (k >= 0 && k < PX) o[k] = fmaf(tp[t], v, o[k]);
        }
      }
#pragma unroll
      for (int k = 0; k < PX; ++k)
        acc[k][ch] = fmaf(o[k], level_weight(lowers, alpha, k, l), acc[k][ch]);
    }
    __syncthreads();  // sv is rewritten by the next level
  }
}

template <typename T>
__device__ __forceinline__ void store_pixels(T* d, const float (&o)[PX][3], bool vec, int n) {
  if (vec) {
    if constexpr (sizeof(T) == 2) {
      uint32_t u[PX * 3 / 2];
#pragma unroll
      for (int j = 0; j < PX * 3 / 2; ++j) {
        const __nv_bfloat162 b =
            __floats2bfloat162_rn(o[(2 * j) / 3][(2 * j) % 3], o[(2 * j + 1) / 3][(2 * j + 1) % 3]);
        u[j] = *reinterpret_cast<const uint32_t*>(&b);
      }
#pragma unroll
      for (int j = 0; j < 3; ++j)
        reinterpret_cast<uint4*>(d)[j] = make_uint4(u[4 * j], u[4 * j + 1], u[4 * j + 2], u[4 * j + 3]);
    } else {
#pragma unroll
      for (int j = 0; j < 6; ++j)
        reinterpret_cast<float4*>(d)[j] =
            make_float4(o[(4 * j) / 3][(4 * j) % 3], o[(4 * j + 1) / 3][(4 * j + 1) % 3],
                        o[(4 * j + 2) / 3][(4 * j + 2) % 3], o[(4 * j + 3) / 3][(4 * j + 3) % 3]);
    }
    return;
  }
#pragma unroll
  for (int k = 0; k < PX; ++k)
    if (k < n)
#pragma unroll
      for (int ch = 0; ch < 3; ++ch) vd3d::store(d, k * 3 + ch, o[k][ch]);
}

template <typename T>
__global__ void __launch_bounds__(THREADS, 2)
dof_grade_kernel(const __grid_constant__ CUtensorMap map_l,
                 const __grid_constant__ CUtensorMap map_r,
                 const __grid_constant__ CUtensorMap map_d, const T* __restrict__ left,
                 const T* __restrict__ right, const float* __restrict__ depth,
                 const float* __restrict__ focal, T* __restrict__ out_left,
                 T* __restrict__ out_right, const __grid_constant__ Geometry G,
                 const __grid_constant__ DofParams P) {
  extern __shared__ unsigned char dyn[];
  unsigned char* base = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(dyn) + 127) & ~static_cast<uintptr_t>(127));
  uint64_t* bar = reinterpret_cast<uint64_t*>(base);  // one mbarrier per stage
  float* sv = reinterpret_cast<float*>(base + 128 + 2 * G.stage_bytes);
  // the taps in shared memory: indexing the parameter block with a run-time
  // index would give every thread a local copy of it
  __shared__ float stap[MAX_LEVELS][MAX_TAPS];
  __shared__ int shalf[MAX_LEVELS];
  __shared__ int s_lo[WARPS], s_hi[WARPS];

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // this thread's pixels: tile row pr, columns pc .. pc + 7 (a warp covers
  // 8 rows x 32 columns)
  const int pr = 8 * (warp & 3) + (lane >> 2);
  const int pc = 32 * (warp >> 2) + PX * (lane & 3);
  const int R = P.reach;

  // constant indices after unrolling: each read is one constant-bank load
#pragma unroll
  for (int i = 0; i < MAX_LEVELS * MAX_TAPS; ++i)
    if (i == tid) stap[i / MAX_TAPS][i % MAX_TAPS] = P.taps[i / MAX_TAPS][i % MAX_TAPS];
#pragma unroll
  for (int i = 0; i < MAX_LEVELS; ++i)
    if (i == tid) shalf[i] = P.half[i];
  if (tid == 0) {
    vd3d::mbar_init(&bar[0], 1);
    vd3d::mbar_init(&bar[1], 1);
    vd3d::mbar_fence_init();
  }
  __syncthreads();
  const float f = *focal;

  auto stage = [&](int s) { return base + 128 + s * G.stage_bytes; };
  auto origin = [&](int tile, int& eye, int& oy, int& ox) {
    eye = tile >= G.per_eye;
    const int t = tile - eye * G.per_eye;
    const int ty = t / G.tiles_x;
    oy = ty * TH;
    ox = (t - ty * G.tiles_x) * TW;
  };
  auto by_tma = [&](int oy, int ox) {
    return G.tma && oy >= R && ox >= R && oy + TH + R <= G.h && ox + TW + R <= G.w;
  };
  // thread 0: the window and depth of `tile` into stage s, if they come by TMA
  auto prefetch = [&](int tile, int s) {
    int eye, oy, ox;
    origin(tile, eye, oy, ox);
    if (!by_tma(oy, ox)) return;
    vd3d::fence_proxy_async();
    vd3d::mbar_arrive_expect_tx(&bar[s], (uint32_t)(G.bh * G.bw * sizeof(T) + TH * TW * 4));
    vd3d::tma_load_2d(stage(s), eye ? &map_r : &map_l, &bar[s], (ox - R) * 3 - G.shift, oy - R);
    vd3d::tma_load_2d(stage(s) + G.win_bytes, &map_d, &bar[s], ox, oy);
  };

  if (tid == 0 && (int)blockIdx.x < G.total) prefetch(blockIdx.x, 0);
  uint32_t phase = 0;  // bit s: the parity stage s waits for next
  int k = 0;
  for (int tile = blockIdx.x; tile < G.total; tile += gridDim.x, ++k) {
    const int s = k & 1;
    T* win = reinterpret_cast<T*>(stage(s)) + G.shift;
    const float* sdep = reinterpret_cast<const float*>(stage(s) + G.win_bytes);
    if (tid == 0 && tile + (int)gridDim.x < G.total) prefetch(tile + gridDim.x, s ^ 1);
    int eye, oy, ox;
    origin(tile, eye, oy, ox);
    if (by_tma(oy, ox)) {
      vd3d::mbar_wait(&bar[s], (phase >> s) & 1u);
      phase ^= 1u << s;
    } else {
      load_tile(win, const_cast<float*>(sdep), eye ? right : left, depth, oy, ox, R, G);
      __syncthreads();
    }

    // blur index of this thread's pixels (ops/dof.py:apply_dof)
    const int y = oy + pr, x0 = ox + pc;
    const float4 d0 = reinterpret_cast<const float4*>(sdep + pr * TW + pc)[0];
    const float4 d1 = reinterpret_cast<const float4*>(sdep + pr * TW + pc)[1];
    const float d[PX] = {d0.x, d0.y, d0.z, d0.w, d1.x, d1.y, d1.z, d1.w};
    uint32_t lowers = 0;
    float alpha[PX], acc[PX][3];
    int lmin = 1 << 20, lmax = -1;
#pragma unroll
    for (int j = 0; j < PX; ++j) {
      int lo = 7;  // outside the image: no level it reads is stored
      alpha[j] = 0.0f;
      acc[j][0] = acc[j][1] = acc[j][2] = 0.0f;
      if (y < G.h && x0 + j < G.w) {
        const float diff = fabsf(d[j] - f);
        const float bw = fminf(fmaxf(diff / P.fw_eps, 0.0f), 1.0f);
        const float idx = fminf(fmaxf(bw * (float)(P.n - 1), 0.0f), P.idx_max);
        const float lf = fminf(fmaxf(floorf(idx), 0.0f), (float)(P.n - 2));
        lo = (int)lf;
        alpha[j] = idx - lf;
        lmin = min(lmin, lo);
        lmax = max(lmax, lo);
      }
      lowers |= (uint32_t)lo << (3 * j);
    }
    lmin = __reduce_min_sync(FULL, lmin);
    lmax = __reduce_max_sync(FULL, lmax);
    if (lane == 0) {
      s_lo[warp] = lmin;
      s_hi[warp] = lmax;
    }
    __syncthreads();
#pragma unroll
    for (int i = 0; i < WARPS; ++i) {
      lmin = min(lmin, s_lo[i]);
      lmax = max(lmax, s_hi[i]);
    }
    // the tile reads levels lmin .. lmax + 1 only
    const int last = min(lmax + 1, P.n - 1);
    for (int l = lmin; l <= last; ++l) {
      const float* tp = stap[l];
      switch (shalf[l]) {
        case 0: blur_level<T, 0>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 1: blur_level<T, 1>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 2: blur_level<T, 2>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 3: blur_level<T, 3>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 4: blur_level<T, 4>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 5: blur_level<T, 5>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 6: blur_level<T, 6>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 7: blur_level<T, 7>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 8: blur_level<T, 8>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        case 9: blur_level<T, 9>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
        default: blur_level<T, 10>(win, sv, tp, l, R, G, pr, pc, lowers, alpha, acc); break;
      }
    }

    if (y < G.h) {
      float o[PX][3];
#pragma unroll
      for (int j = 0; j < PX; ++j) {
#pragma unroll
        for (int ch = 0; ch < 3; ++ch) o[j][ch] = fminf(fmaxf(acc[j][ch], 0.0f), 1.0f);
        if (P.grade) {
          const float luma = 0.2126f * o[j][0] + 0.7152f * o[j][1] + 0.0722f * o[j][2];
#pragma unroll
          for (int ch = 0; ch < 3; ++ch) {
            const float sat = luma + (o[j][ch] - luma) * P.sat;
            const float c = 0.5f + (sat - 0.5f) * P.con;
            o[j][ch] = fminf(fmaxf(c + P.bri, 0.0f), 1.0f);
          }
        }
      }
      const int n = G.w - x0;
      store_pixels((eye ? out_right : out_left) + ((size_t)y * G.w + x0) * 3, o,
                   G.vec && n >= PX, n);
    }
    __syncthreads();  // the stage, sv and the range slots are free again
  }
}

// The window and vertical-pass layout of reach R for element size `size`.
void set_layout(Geometry& G, int R, int size) {
  const int per16 = 16 / size;
  G.bh = TH + 2 * R;
  G.shift = ((-3 * R) % per16 + per16) % per16;  // (ox - R) * 3 mod per16; ox % 64 == 0
  G.bw = (G.shift + (TW + 2 * R) * 3 + per16 - 1) / per16 * per16;  // <= 256: one TMA box
  G.win_bytes = (G.bh * G.bw * size + 127) / 128 * 128;
  G.stage_bytes = G.win_bytes + TH * TW * 4;
  G.svp = TW + 2 * R + 1;
  G.pl = TH * G.svp + ((11 - TH * G.svp % 32) + 32) % 32;
  G.bytes = 128 /* alignment */ + 128 /* mbarriers */ + 2 * G.stage_bytes + 3 * G.pl * 4;
}

template <typename T>
int launch(const void* left, const void* right, const void* depth, const void* focal,
           void* out_left, void* out_right, Geometry G, const DofParams& P, cudaStream_t s) {
  const auto kern = dof_grade_kernel<T>;
  // per device: the attribute, the SM count and the CTAs per SM by reach
  static int sms_of[vd3d::MAX_DEVICES] = {};
  static int per_sm_of[vd3d::MAX_DEVICES][MAX_REACH + 1] = {};
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  int& sms = sms_of[dev];
  int* per_sm = per_sm_of[dev];
  if (sms == 0) {
    Geometry widest = G;
    set_layout(widest, MAX_REACH, sizeof(T));
    int n = 0;
    cudaError_t e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         widest.bytes);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) return (int)e;
    sms = n;
  }
  const int R = P.reach;
  if (per_sm[R] == 0) {
    cudaError_t e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm[R], kern, THREADS,
                                                                  G.bytes);
    if (e != cudaSuccess) return (int)e;
    if (per_sm[R] < 1) return (int)cudaErrorInvalidConfiguration;
  }
  CUtensorMap maps[3] = {};
  if (G.tma) {
    const void* src[2] = {left, right};
    for (int i = 0; i < 2; ++i)
      if (!vd3d::encode_map_2d(&maps[i], src[i], sizeof(T) == 2, (cuuint64_t)G.w * 3,
                               (cuuint64_t)G.h, (cuuint64_t)G.w * 3 * sizeof(T),
                               (cuuint32_t)G.bw, (cuuint32_t)G.bh))
        return (int)cudaErrorInvalidValue;
    if (!vd3d::encode_map_2d(&maps[2], depth, false, (cuuint64_t)G.w, (cuuint64_t)G.h,
                             (cuuint64_t)G.w * 4, TW, TH))
      return (int)cudaErrorInvalidValue;
  }
  const int grid = G.total < per_sm[R] * sms ? G.total : per_sm[R] * sms;
  dof_grade_kernel<T><<<grid, THREADS, G.bytes, s>>>(
      maps[0], maps[1], maps[2], (const T*)left, (const T*)right, (const float*)depth,
      (const float*)focal, (T*)out_left, (T*)out_right, G, P);
  return (int)cudaGetLastError();
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
  if (n < 2 || n > MAX_LEVELS || h < 1 || w < 1) return (int)cudaErrorInvalidValue;
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
  const int size = bf16 ? 2 : 4;
  Geometry G = {};
  G.h = h;
  G.w = w;
  G.tiles_x = (w + TW - 1) / TW;
  G.per_eye = G.tiles_x * ((h + TH - 1) / TH);
  G.total = 2 * G.per_eye;
  auto aligned = [](const void* p) { return ((size_t)p & 15) == 0; };
  G.tma = ((size_t)w * 3 * size) % 16 == 0 && w % 4 == 0 && aligned(left) &&
          aligned(right) && aligned(depth);
  G.vec = w % 8 == 0 && aligned(out_left) && aligned(out_right);
  set_layout(G, P.reach, size);
  cudaStream_t s = (cudaStream_t)stream;
  if (bf16)
    return launch<__nv_bfloat16>(left, right, depth, focal, out_left, out_right, G, P, s);
  return launch<float>(left, right, depth, focal, out_left, out_right, G, P, s);
}
