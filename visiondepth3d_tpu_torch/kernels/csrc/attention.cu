// Attention softmax(Q K^T / sqrt(d)) V over BNHD tensors: self-attention
// (Nq = Nk) or a band of query rows against the whole sequence (Nq < Nk,
// the row-sharded depth model's form).
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_attention.py:
// vmem_attention (_attn_kernel): logits and the softmax statistics in
// float32, P V accumulated in float32, one rounding of the output. Key
// columns past Nk are masked to -1e30 before the row max; query rows past
// Nq are not stored. Q and O are [B, Nq, H, D], K and V [B, Nk, H, D], read
// and written in place with the token stride H * D (no transposed or padded
// copies). Every query row sees the same key tiles in the same order
// whatever Nq is, so row i of a band q[:, a:b] is row a + i of the whole
// sequence's output.
//
// The TPU kernel keeps one (batch, head)'s whole K and V resident in VMEM.
// At the depth model's shape (N = 1370, D = 64, bf16) that is 350 KB, more
// than the 227 KB of shared memory of one H100 SM, so here K and V stream
// through shared memory in tiles of 64 keys.
//
// - bfloat16 (attention_wgmma_kernel): one pass with an online softmax
//   (FlashAttention's schedule). A block owns 128 query rows of one
//   (batch, head): two consumer warpgroups of 64 rows and one producer
//   warp. The producer loads Q once and streams K and V through a ring of
//   two 64-key stages by TMA (tensor maps over the BNHD tensors in place,
//   box [1, 64, 1, min(D, 64)], swizzled to the row width; query rows past
//   Nq and keys past Nk come in as zeros), signalling each stage on an mbarrier; the consumers
//   release a stage once their P V has read it. Each consumer computes
//   S = Q K^T with wgmma m64n64k16 from shared memory, masks it in
//   registers, keeps the running row max m and sum l (reduced over the
//   four threads that share a row), forms P = exp(s - m) in float32 (one
//   FMA and one ex2.approx per logit) and rounds it to bf16 in registers,
//   where it is wgmma's A operand for O += P V (V MN-major from shared
//   memory). O is rescaled by
//   exp(m_old - m_new) as m grows and divided by l once at the end.
//   Numerics: the TPU kernel rounds the normalized probabilities to bf16;
//   this one rounds the unnormalized P, in [0, 1], and divides afterwards
//   (the plain version keeps the TPU rounding point; the two agree within
//   the bf16 gate, max 1.6e-2 and mean 1e-3).
// - float32 (attention_fma_kernel, parity runs): two passes over the key
//   tiles on CUDA-core FMAs in full float32 (no TF32), 256 threads with a
//   4 x 4 register tile each; pass 1 keeps the online row max and sum,
//   pass 2 forms the normalized probabilities (the TPU rounding point).
//
// What bounds it on the H100: at [8, 1370, 6, 64] bf16 the two products
// are 23 GFLOP per call (0.023 ms at the tensor cores' peak) against 34 MB
// of Q, K, V and O (0.010 ms), and 90 M exponentials (about 0.02 ms on the
// special-function units): operations. One pass does two products and one
// exponential per logit, and the copies overlap the math through the ring.
// Not done yet: the overlap of one tile's softmax with the next tile's S
// inside a warpgroup.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BQ = 64;  // float32: query rows per block
constexpr int BK = 64;  // keys per tile
constexpr float MASKED = -1e30f;
static_assert(BQ == BK, "the float32 kernel stages Q and K tiles alike");

__device__ __forceinline__ size_t row_offset(int b, int n, int h, int N, int H, int D) {
  return (((size_t)b * N + n) * H + h) * D;
}

// ---------------------------------------------------------------- bfloat16

constexpr int WG = 2;                       // consumer warpgroups, 64 query rows each
constexpr int STAGES = 2;                   // the K / V ring
constexpr int WG_THREADS = WG * 128 + 32;   // and one producer warp
constexpr float LOG2E = 1.4426950408889634f;

// Shared-memory layout: each 64-row tile of Q, K or V is D / DB atoms of
// [64][DB] bf16 (one TMA box each), swizzled by SW = 2 DB bytes.
template <int D>
struct Tiles {
  static constexpr int DB = D < 64 ? D : 64;
  static constexpr int SW = 2 * DB;
  static constexpr int ATOMS = D / DB;
  static constexpr int ATOM = 64 * SW;
  static constexpr int TILE = ATOMS * ATOM;
  static constexpr int Q = 0;
  static constexpr int K = Q + WG * TILE;
  static constexpr int V = K + STAGES * TILE;
  static constexpr int BAR = V + STAGES * TILE;
  static constexpr int BYTES = BAR + 8 * (1 + 2 * STAGES) + 1024;  // + alignment slack
};

// 2^x on the special-function unit, flushing results below 2^-126 to zero
// (probabilities that small do not reach a bf16 output)
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// O[:, 64 a .. 64 a + N) += P V for one k16 step, V's atom at desc_b
template <int N>
__device__ __forceinline__ void pv_step(float (&o)[N / 2], const uint32_t (&p)[4],
                                        uint64_t desc_b) {
  if constexpr (N == 16) vd3d::wgmma_rs_n16<1>(o, p, desc_b);
  else if constexpr (N == 32) vd3d::wgmma_rs_n32<1>(o, p, desc_b);
  else vd3d::wgmma_rs_n64<1>(o, p, desc_b);
}

template <int D>
__global__ void __launch_bounds__(WG_THREADS, D == 128 ? 1 : 2)
attention_wgmma_kernel(const __grid_constant__ CUtensorMap mq,
                       const __grid_constant__ CUtensorMap mk,
                       const __grid_constant__ CUtensorMap mv, __nv_bfloat16* __restrict__ o,
                       int Nq, int Nk, int H, float scale_log2) {
  using namespace vd3d;
  using T = Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* full = qbar + 1;
  uint64_t* empty = full + STAGES;
  const int q0 = blockIdx.x * (WG * 64), h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Nk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], WG * 4);  // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp == WG * 4) {  // the producer warp
    if (lane == 0) {
      mbar_arrive_expect_tx(qbar, WG * T::TILE);
      for (int g = 0; g < WG; ++g)
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load_4d(smem + T::Q + g * T::TILE + a * T::ATOM, &mq, qbar, a * T::DB, h,
                      q0 + 64 * g, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::TILE);
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(smem + T::K + s * T::TILE + a * T::ATOM, &mk, &full[s], a * T::DB, h,
                      t * BK, b);
          tma_load_4d(smem + T::V + s * T::TILE + a * T::ATOM, &mv, &full[s], a * T::DB, h,
                      t * BK, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 g + r0 and r0 + 8 of the block belong to
  // this thread, with columns c2, c2 + 1 of every 8-column block
  const int g = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int c2 = 2 * (lane % 4);
  const uint32_t sQ = smem_u32(smem + T::Q + g * T::TILE);
  const uint32_t sK0 = smem_u32(smem + T::K), sV0 = smem_u32(smem + T::V);
  constexpr uint32_t SBO = 8 * T::SW;  // 8-row groups

  float acc[T::ATOMS][T::DB / 2];
#pragma unroll
  for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
    for (int i = 0; i < T::DB / 2; ++i) acc[a][i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  mbar_wait(qbar, 0);
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&full[s], (t / STAGES) & 1);
    const uint32_t sK = sK0 + s * T::TILE, sV = sV0 + s * T::TILE;

    // S = Q K^T over the tile's 64 keys, both K-major
    float sc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < D / 16; ++ks) {
      const uint32_t off = (ks * 16 / T::DB) * T::ATOM + (ks * 16 % T::DB) * 2;
      wgmma_ss_n64(sc, smem_desc<T::SW>(sQ + off, 16, SBO), smem_desc<T::SW>(sK + off, 16, SBO),
                   1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);

    // mask keys past Nk; the running max m is kept on the unscaled logits,
    // and exp(scale (s - m)) = 2^(s log2e scale - m log2e scale) is one FMA
    // and one ex2 per logit
    const int kbase = t * BK;
    const bool ragged = kbase + BK > Nk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool valid = !ragged || kbase + 8 * j + c2 + e < Nk;
        sc[4 * j + e] = valid ? sc[4 * j + e] : MASKED;
        sc[4 * j + 2 + e] = valid ? sc[4 * j + 2 + e] : MASKED;
        mx0 = fmaxf(mx0, sc[4 * j + e]);
        mx1 = fmaxf(mx1, sc[4 * j + 2 + e]);
      }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float alpha0 = fast_exp2((m0 - mx0) * scale_log2);
    const float alpha1 = fast_exp2((m1 - mx1) * scale_log2);
    const float ms0 = mx0 * scale_log2, ms1 = mx1 * scale_log2;
    m0 = mx0;
    m1 = mx1;

    // P = exp(s - m), rounded to bf16 straight into A fragments: k step kk
    // covers keys 16 kk .. 16 kk + 15, the 8-column blocks 2 kk and 2 kk + 1
    uint32_t p[4][4];
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        const int j = 2 * kk + hf;
        const float e00 = fast_exp2(fmaf(sc[4 * j], scale_log2, -ms0));
        const float e01 = fast_exp2(fmaf(sc[4 * j + 1], scale_log2, -ms0));
        const float e10 = fast_exp2(fmaf(sc[4 * j + 2], scale_log2, -ms1));
        const float e11 = fast_exp2(fmaf(sc[4 * j + 3], scale_log2, -ms1));
        s0 += e00 + e01;
        s1 += e10 + e11;
        p[kk][2 * hf] = pack_bf16(e00, e01);
        p[kk][2 * hf + 1] = pack_bf16(e10, e11);
      }
    l0 = l0 * alpha0 + s0;  // per-thread partial sums; reduced once at the end
    l1 = l1 * alpha1 + s1;
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
      for (int j = 0; j < T::DB / 8; ++j) {
        acc[a][4 * j] *= alpha0;
        acc[a][4 * j + 1] *= alpha0;
        acc[a][4 * j + 2] *= alpha1;
        acc[a][4 * j + 3] *= alpha1;
      }

    // O += P V, V MN-major: k step kk starts 16 rows down the tile
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int a = 0; a < T::ATOMS; ++a)
        pv_step<T::DB>(acc[a], p[kk],
                       smem_desc<T::SW>(sV + a * T::ATOM + kk * 16 * T::SW, T::ATOM, SBO));
    wgmma_commit();
    wgmma_wait<0>();
#pragma unroll
    for (int a = 0; a < T::ATOMS; ++a) fence_regs(acc[a]);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) fence_regs(p[kk]);
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int n0 = q0 + 64 * g + r0, n1 = n0 + 8;
#pragma unroll
  for (int a = 0; a < T::ATOMS; ++a)
#pragma unroll
    for (int j = 0; j < T::DB / 8; ++j) {
      const int d = 64 * a + 8 * j + c2;
      if (n0 < Nq)
        *reinterpret_cast<uint32_t*>(o + row_offset(b, n0, h, Nq, H, D) + d) =
            pack_bf16(acc[a][4 * j] * inv0, acc[a][4 * j + 1] * inv0);
      if (n1 < Nq)
        *reinterpret_cast<uint32_t*>(o + row_offset(b, n1, h, Nq, H, D) + d) =
            pack_bf16(acc[a][4 * j + 2] * inv1, acc[a][4 * j + 3] * inv1);
    }
}

// ---------------------------------------------------------------- float32

constexpr int FMA_THREADS = 256;  // 16 x 16 threads, 4 x 4 register tiles

template <int D>
struct FmaSmem {
  static constexpr int LDQ = D + 1;
  static constexpr int LDS = BK + 1;
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDQ * 4;
  static constexpr int V = K + BK * LDQ * 4;
  static constexpr int S = V + BK * D * 4;
  static constexpr int BYTES = S + BQ * LDS * 4;
};

template <int D>
__global__ void __launch_bounds__(FMA_THREADS)
attention_fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, float* __restrict__ o, int Nq, int Nk,
                     int H, float scale) {
  using L = FmaSmem<D>;
  constexpr int DJ = D / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  float* sQ = reinterpret_cast<float*>(smem + L::Q);
  float* sK = reinterpret_cast<float*>(smem + L::K);
  float* sV = reinterpret_cast<float*>(smem + L::V);
  float* sS = reinterpret_cast<float*>(smem + L::S);
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;

  // Q and K rows with a padded stride (scalar loads), V as whole rows
  auto load_padded = [&](const float* x, float* s, int r0, int N) {
    for (int i = tid; i < BQ * D; i += FMA_THREADS) {
      const int rr = i / D, d = i % D;
      s[rr * L::LDQ + d] = r0 + rr < N ? x[row_offset(b, r0 + rr, h, N, H, D) + d] : 0.0f;
    }
  };
  load_padded(q, sQ, q0, Nq);

  // S tile (rows ty * 4 + i, keys tx + 16 j) into sS, scaled and masked
  auto scores = [&](int k0) {
    float acc[4][4] = {};
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * L::LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = sK[(tx + 16 * j) * L::LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(qv[i], kv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sS[(ty * 4 + i) * L::LDS + tx + 16 * j] =
            k0 + tx + 16 * j < Nk ? acc[i][j] * scale : MASKED;
  };

  // row statistics: four lanes per row, 16 keys each
  const int sr = tid / 4, sc = (tid % 4) * (BK / 4);
  float m = -INFINITY, l = 0.0f;
  const int n_tiles = (Nk + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_padded(k, sK, t * BK, Nk);
    __syncthreads();
    scores(t * BK);
    __syncthreads();
    float mt = MASKED;
    for (int c = sc; c < sc + BK / 4; ++c) mt = fmaxf(mt, sS[sr * L::LDS + c]);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt);
    float sum = 0.0f;
    for (int c = sc; c < sc + BK / 4; ++c) sum += expf(sS[sr * L::LDS + c] - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    sum += __shfl_xor_sync(0xffffffffu, sum, 2);
    l = l * expf(m - m_new) + sum;
    m = m_new;
  }

  float acc[4][DJ] = {};
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_padded(k, sK, k0, Nk);
    for (int i = tid; i < BK * D; i += FMA_THREADS) {
      const int rr = i / D, d = i % D;
      sV[i] = k0 + rr < Nk ? v[row_offset(b, k0 + rr, h, Nk, H, D) + d] : 0.0f;
    }
    __syncthreads();
    scores(k0);
    __syncthreads();
    for (int c = sc; c < sc + BK / 4; ++c)
      sS[sr * L::LDS + c] = expf(sS[sr * L::LDS + c] - m) / l;
    __syncthreads();
    for (int c = 0; c < BK; ++c) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sS[(ty * 4 + i) * L::LDS + c];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = sV[c * D + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int n = q0 + ty * 4 + i;
    if (n >= Nq) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[row_offset(b, n, h, Nq, H, D) + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
int launch_wgmma(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk,
                 int H, float scale, cudaStream_t s) {
  using T = Tiles<D>;
  const cuuint32_t box[4] = {(cuuint32_t)T::DB, 1, (cuuint32_t)BK, 1};
  const CUtensorMapSwizzle swz = T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B
                                 : T::SW == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                                               : CU_TENSOR_MAP_SWIZZLE_32B;
  // Q's map covers the Nq query rows, K's and V's the Nk keys
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t n = i == 0 ? Nq : Nk;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, n, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 2, (cuuint64_t)H * D * 2, n * H * D * 2};
    if (!vd3d::encode_map_4d(&maps[i], ptrs[i], dims, strides, box, swz))
      return (int)cudaErrorInvalidValue;
  }
  static bool configured[vd3d::MAX_DEVICES] = {};  // the attribute, per device
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(attention_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  const dim3 grid((Nq + WG * 64 - 1) / (WG * 64), H, B);
  attention_wgmma_kernel<D><<<grid, WG_THREADS, T::BYTES, s>>>(
      maps[0], maps[1], maps[2], (__nv_bfloat16*)o, Nq, Nk, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk, int H,
           float scale, int bf16, cudaStream_t s) {
  if (bf16) return launch_wgmma<D>(q, k, v, o, B, Nq, Nk, H, scale, s);
  const dim3 grid((Nq + BQ - 1) / BQ, H, B);
  constexpr int bytes = FmaSmem<D>::BYTES;
  static bool configured[vd3d::MAX_DEVICES] = {};  // the attribute, per device
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(attention_fma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  attention_fma_kernel<D><<<grid, FMA_THREADS, bytes, s>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, Nq, Nk, H, scale);
  return (int)cudaGetLastError();
}

}  // namespace

// q, o [B, Nq, H, D] and k, v [B, Nk, H, D] contiguous, float32 or bf16,
// 16-byte aligned; 1 <= Nq <= Nk; D in {16, 32, 64, 128}.
extern "C" int vd3d_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int Nq, int Nk, int H, int D, float scale, int bf16,
                              void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  if (Nq < 1 || Nq > Nk) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, Nq, Nk, H, scale, bf16, s);
    case 32: return launch<32>(q, k, v, o, B, Nq, Nk, H, scale, bf16, s);
    case 64: return launch<64>(q, k, v, o, B, Nq, Nk, H, scale, bf16, s);
    case 128: return launch<128>(q, k, v, o, B, Nq, Nk, H, scale, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
