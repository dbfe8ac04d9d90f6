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
// - float32 (attention_tf32_kernel; the parity runs, depth in float32
//   with the opt-in): the same one-pass schedule and ring, with float
//   tiles, on the tensor cores in split TF32 (hopper.cuh): each product is
//   three TF32 products of explicit halves, small x big + big x small +
//   big x big. Q is split once: its big half into A fragments in
//   registers, its small half in place in shared memory. The producer is a
//   warpgroup: one warp issues the copies, and three split each landed key
//   tile in its ring stage, K (big in place, small into a plane of its own)
//   and V transposed into its two halves [D][keys] (TF32 wgmma takes B
//   only K-major, and V lands MN-major), then signal the consumers on a
//   second mbarrier; the consumers never wait for each other, so one
//   warpgroup's softmax runs beside the other's products. The transpose
//   also orders the keys as the S accumulator hands P to the A fragment,
//   so P (float32, split in registers; no bf16 rounding) feeds P V with no
//   shuffle. A tile holds 64 keys (32 at D = 128, where Q and two stages
//   would not fit otherwise). The producer warpgroup hands its registers
//   to the consumers (setmaxnreg).
//   Numerics: an add inside the tensor cores does not round to nearest
//   (measured on the H100: with every product added into one accumulator,
//   K7's error against the plain version at [24, 2040, 20, 64] reached
//   2.3e-5, past its 1e-5 gate). So the big x big products of S collect
//   apart from the cross terms, and each tile's P V goes into a partial
//   that is added to O (rescaled) on the CUDA cores, round to nearest: the
//   running O never takes a tensor-core add (max 1.8e-6 there). O is divided by l
//   once at the end. Against the plain version (float32; it normalizes P
//   first, and its cast of P is the identity) within 1e-5.
//
// What bounds it on the H100: at [8, 1370, 6, 64] bf16 the two products
// are 23 GFLOP per call (0.023 ms at the tensor cores' peak) against 34 MB
// of Q, K, V and O (0.010 ms), and 90 M exponentials (about 0.02 ms on the
// special-function units): operations. One pass does two products and one
// exponential per logit, and the copies overlap the math through the ring.
// In float32 the products cost three TF32 products each: 69 GFLOP at 495
// TFLOP/s, 0.14 ms, against 68 MB (0.020 ms): operations again; beside
// them the exponentials and P's split run on the consumers' CUDA cores
// between their products, K's and V's split on the producer's.
// Not done yet: the overlap of one tile's softmax with the next tile's S
// inside a warpgroup.

#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int BK = 64;  // bfloat16: keys per tile
constexpr float MASKED = -1e30f;

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

// Shared-memory layout of the float32 body. Q, K and V land as the bf16
// tiles do, with float elements: D / DB atoms of [rows][DB] floats,
// swizzled by SW = 4 DB bytes (128 from D = 32 on). A ring stage holds a
// key tile's K and V as they land and their TF32 halves: K's big half is
// its landed tile (rounded in place), its small half ST_KS; V is
// transposed into ST_VB and ST_VS, [D][BK keys] K-major (TF32 wgmma reads
// B only K-major), atoms of 32 keys with the 128-byte swizzle. Q's tile
// holds its small half once split (its big half is in registers). At
// D = 128 a key tile holds 32 keys, so two stages fit beside Q.
template <int D>
struct F32Tiles {
  static constexpr int BK = D == 128 ? 32 : 64;  // keys per tile
  static constexpr int DB = D < 32 ? D : 32;
  static constexpr int SW = 4 * DB;
  static constexpr int ATOMS = D / DB;
  static constexpr int Q_ATOM = 64 * SW;
  static constexpr int Q_TILE = ATOMS * Q_ATOM;  // one warpgroup's 64 query rows
  static constexpr int K_ATOM = BK * SW;
  static constexpr int K_TILE = ATOMS * K_ATOM;  // a key tile of K or V
  static constexpr int VT_ATOM = D * 128;
  static constexpr int VT_TILE = BK / 32 * VT_ATOM;
  static constexpr int ST_K = 0, ST_V = K_TILE, ST_KS = 2 * K_TILE;
  static constexpr int ST_VB = 3 * K_TILE, ST_VS = ST_VB + VT_TILE;
  static constexpr int STAGE = ST_VS + VT_TILE;
  static constexpr int Q = 0;
  static constexpr int RING = Q + WG * Q_TILE;
  static constexpr int BAR = RING + STAGES * STAGE;
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;  // + alignment slack
};

// the producer warpgroup's warps after the first (which issues the copies)
// split each landed tile
constexpr int SPLIT_THREADS = 3 * 32;

// The landed key tile's TF32 halves: big rounded in place, small into ks
// (the same layout), by the splitting threads
template <typename T>
__device__ __forceinline__ void split_k_tile(uint32_t k, uint32_t ks, int tid) {
  for (int i = tid; i < T::K_TILE / 16; i += SPLIT_THREADS) {
    uint4 small;
    vd3d::sts128(k + 16 * i, vd3d::split_tf32(vd3d::lds128(k + 16 * i), small));
    vd3d::sts128(ks + 16 * i, small);
  }
}

// The landed value tile [BK keys][D] transposed into its TF32 halves
// vb, vs [D][BK], K-major for P V. Column c = 8 G + c' of vb holds key
// 8 G + 2 (c' % 4) + c' / 4: the keys in the order the S accumulator hands
// P to the A fragment (a thread holds keys 2 t and 2 t + 1 of each 8-key
// block, the fragment wants columns t and t + 4). A task is 4 keys x 4
// values of d: four float4 reads of key rows, four float4 writes of d rows
// per half. The 8 lanes of a quarter warp take the 8 column quads cq of a
// 32-key atom and d quads 2 apart in pairs, so at D >= 32 both the reads
// (128-byte swizzle: chunk dq ^ (key % 8)) and the writes (chunk cq ^ (d %
// 8)) hit 8 different 16-byte bank groups.
template <typename T, int D>
__device__ __forceinline__ void split_v_tile(uint32_t v, uint32_t vb, uint32_t vs, int tid) {
  constexpr int CQ = T::BK / 4, DQ = D / 4;
  for (int task = tid; task < CQ * DQ; task += SPLIT_THREADS) {
    const int l = task % 8;
    const int cq = (task / 8) % (CQ / 8) * 8 + l;
    const int dq = (task / CQ + 2 * (l >> 1)) % DQ;
    const int d0 = 4 * dq, key0 = 8 * (cq >> 1) + (cq & 1);
    uint4 r[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      r[j] = vd3d::lds128(v + (d0 / T::DB) * T::K_ATOM +
                          vd3d::swizzle<T::SW>((key0 + 2 * j) * T::SW + (d0 % T::DB) * 4));
    const uint4 col[4] = {make_uint4(r[0].x, r[1].x, r[2].x, r[3].x),
                          make_uint4(r[0].y, r[1].y, r[2].y, r[3].y),
                          make_uint4(r[0].z, r[1].z, r[2].z, r[3].z),
                          make_uint4(r[0].w, r[1].w, r[2].w, r[3].w)};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      uint4 small;
      const uint4 big = vd3d::split_tf32(col[i], small);
      const uint32_t off =
          (cq / 8) * T::VT_ATOM + vd3d::swizzle<128>((d0 + i) * 128 + (cq % 8) * 16);
      vd3d::sts128(vb + off, big);
      vd3d::sts128(vs + off, small);
    }
  }
}

// float32: two consumer warpgroups and a producer warpgroup (one warp issues
// the copies, three split the tiles), which hands registers to the
// consumers (setmaxnreg: 56 a thread for it, 224 for them; the block holds
// 168 a thread from its launch, and the two moves must fit in that pool:
// 128 x 56 + 256 x 224 = 384 x 168)
constexpr int TF32_THREADS = (WG + 1) * 128;

template <int D>
__global__ void __launch_bounds__(TF32_THREADS, 1)
attention_tf32_kernel(const __grid_constant__ CUtensorMap mq,
                      const __grid_constant__ CUtensorMap mk,
                      const __grid_constant__ CUtensorMap mv, float* __restrict__ o, int Nq,
                      int Nk, int H, float scale_log2) {
  using namespace vd3d;
  using T = F32Tiles<D>;
  constexpr int BK = T::BK;
  constexpr int KS = D / 8;  // k8 steps of S = Q K^T
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + T::BAR);
  uint64_t* full = qbar + 1;        // a tile landed
  uint64_t* ready = full + STAGES;  // a tile split
  uint64_t* empty = ready + STAGES; // a tile's products done
  const int q0 = blockIdx.x * (WG * 64), h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (Nk + BK - 1) / BK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&ready[s], SPLIT_THREADS / 32);  // lane 0 of every splitting warp
      mbar_init(&empty[s], WG * 4);              // lane 0 of every consumer warp
    }
    mbar_fence_init();
  }
  __syncthreads();

  if (warp >= WG * 4) {  // the producer warpgroup
    setmaxnreg_dec<56>();
    if (warp > WG * 4) {  // three warps split each landed tile
      const int sid = threadIdx.x - (WG * 4 + 1) * 32;
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        mbar_wait(&full[s], (t / STAGES) & 1);
        const uint32_t st = smem_u32(smem + T::RING + s * T::STAGE);
        split_k_tile<T>(st + T::ST_K, st + T::ST_KS, sid);
        split_v_tile<T, D>(st + T::ST_V, st + T::ST_VB, st + T::ST_VS, sid);
        fence_proxy_async();  // the generic writes, before wgmma reads them
        __syncwarp();
        if (lane == 0) mbar_arrive(&ready[s]);
      }
    } else if (lane == 0) {  // one thread issues the copies
      mbar_arrive_expect_tx(qbar, WG * T::Q_TILE);
      for (int g = 0; g < WG; ++g)
        for (int a = 0; a < T::ATOMS; ++a)
          tma_load_4d(smem + T::Q + g * T::Q_TILE + a * T::Q_ATOM, &mq, qbar, a * T::DB, h,
                      q0 + 64 * g, b);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % STAGES;
        if (t >= STAGES) mbar_wait(&empty[s], (t / STAGES - 1) & 1);
        mbar_arrive_expect_tx(&full[s], 2 * T::K_TILE);
        unsigned char* st = smem + T::RING + s * T::STAGE;
        for (int a = 0; a < T::ATOMS; ++a) {
          tma_load_4d(st + T::ST_K + a * T::K_ATOM, &mk, &full[s], a * T::DB, h, t * BK, b);
          tma_load_4d(st + T::ST_V + a * T::K_ATOM, &mv, &full[s], a * T::DB, h, t * BK, b);
        }
      }
    }
    return;
  }

  // a consumer warpgroup: rows 64 g + r0 and r0 + 8 of the block belong to
  // this thread, with columns c2, c2 + 1 of every 8-column block of S and O
  setmaxnreg_inc<224>();
  const int g = warp / 4;
  const int r0 = 16 * (warp % 4) + lane / 4;
  const int t4 = lane % 4, c2 = 2 * t4;
  const uint32_t sQ = smem_u32(smem + T::Q + g * T::Q_TILE);
  constexpr uint32_t SBO = 8 * T::SW;  // 8-row groups of Q and K
  auto kd_off = [](int ks, int atom) {  // k8 step ks of a [rows][D] tile
    return (uint32_t)((ks * 8 / T::DB) * atom + (ks * 8 % T::DB) * 4);
  };

  // Q split once: its big half into A fragments in registers (k step ks
  // holds (r0, 8 ks + t4), (r0 + 8, 8 ks + t4), (r0, 8 ks + t4 + 4), (r0 + 8,
  // 8 ks + t4 + 4); over the warpgroup they cover its tile once), its small
  // half written back in place, read by wgmma from shared memory
  mbar_wait(qbar, 0);
  uint32_t qb[KS][4];
#pragma unroll
  for (int ks = 0; ks < KS; ++ks)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = r0 + 8 * (e & 1), d = 8 * ks + t4 + 4 * (e >> 1);
      const uint32_t p =
          sQ + (d / T::DB) * T::Q_ATOM + swizzle<T::SW>(r * T::SW + (d % T::DB) * 4);
      uint32_t small;
      split_tf32(__uint_as_float(lds32(p)), qb[ks][e], small);
      sts32(p, small);
    }
  fence_proxy_async();  // the generic writes, before wgmma reads them
  named_barrier(1 + g, 128);

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.0f, l1 = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % STAGES;
    mbar_wait(&ready[s], (t / STAGES) & 1);
    const uint32_t st = smem_u32(smem + T::RING + s * T::STAGE);
    const uint32_t kBig = st + T::ST_K, kSmall = st + T::ST_KS;
    const uint32_t vBig = st + T::ST_VB, vSmall = st + T::ST_VS;

    // S = Q K^T over the tile's keys. An add in the tensor cores does not
    // round to nearest: its error, up to an ulp of the accumulator, grows
    // with every product added at the accumulator's size. So the cross
    // terms (small x big, big x small: 2^-11 of the products) collect in
    // sc and the big x big products in sb, summed on the CUDA cores
    float sc[BK / 2], sb[BK / 2];
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] = sb[i] = 0.0f;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      const uint32_t off = kd_off(ks, T::K_ATOM);
      wgmma_tf32_ss<BK>(sc, smem_desc<T::SW>(sQ + kd_off(ks, T::Q_ATOM), 16, SBO),
                        smem_desc<T::SW>(kBig + off, 16, SBO));
      wgmma_tf32_rs<BK>(sc, qb[ks], smem_desc<T::SW>(kSmall + off, 16, SBO));
    }
#pragma unroll
    for (int ks = 0; ks < KS; ++ks)
      wgmma_tf32_rs<BK>(sb, qb[ks], smem_desc<T::SW>(kBig + kd_off(ks, T::K_ATOM), 16, SBO));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(sb);
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) sc[i] += sb[i];

    // mask keys past Nk; the running max m is kept on the unscaled logits;
    // p = 2^((s - m) scale log2e), with s - m formed first
    const int kbase = t * BK;
    const bool ragged = kbase + BK > Nk;
    float mx0 = m0, mx1 = m1;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
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
    m0 = mx0;
    m1 = mx1;

    // P = exp(s - m) in float32, in place of S
    float s0 = 0.0f, s1 = 0.0f;
#pragma unroll
    for (int j = 0; j < BK / 8; ++j) {
      sc[4 * j] = fast_exp2((sc[4 * j] - mx0) * scale_log2);
      sc[4 * j + 1] = fast_exp2((sc[4 * j + 1] - mx0) * scale_log2);
      sc[4 * j + 2] = fast_exp2((sc[4 * j + 2] - mx1) * scale_log2);
      sc[4 * j + 3] = fast_exp2((sc[4 * j + 3] - mx1) * scale_log2);
      s0 += sc[4 * j] + sc[4 * j + 1];
      s1 += sc[4 * j + 2] + sc[4 * j + 3];
    }
    l0 = l0 * alpha0 + s0;  // per-thread partial sums; reduced once at the end
    l1 = l1 * alpha1 + s1;

    // the tile's P V into a partial of its own, then O = O alpha + partial
    // with one rounding: the running O never takes a tensor-core add. Two
    // halves of the keys, P split into A fragments half by half (a0 / a1
    // key 8 kk + 2 t4 of rows r0 / r0 + 8, a2 / a3 key 8 kk + 2 t4 + 1;
    // split_v_tile orders V's rows to match), each half's cross terms
    // before its big x big; k step kk reads columns 8 kk .. 8 kk + 7 of V's
    // halves
    constexpr int KH = BK / 16;  // k steps a half
    float pv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) pv[i] = 0.0f;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      uint32_t pb[KH][4], ps[KH][4];
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int j = hf * KH + k;
        split_tf32(sc[4 * j], pb[k][0], ps[k][0]);
        split_tf32(sc[4 * j + 2], pb[k][1], ps[k][1]);
        split_tf32(sc[4 * j + 1], pb[k][2], ps[k][2]);
        split_tf32(sc[4 * j + 3], pb[k][3], ps[k][3]);
      }
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int kk = hf * KH + k;
        const uint32_t off = (kk * 8 / 32) * T::VT_ATOM + (kk * 8 % 32) * 4;
        wgmma_tf32_rs<D>(pv, ps[k], smem_desc<128>(vBig + off, 16, 1024));
        wgmma_tf32_rs<D>(pv, pb[k], smem_desc<128>(vSmall + off, 16, 1024));
      }
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        const int kk = hf * KH + k;
        const uint32_t off = (kk * 8 / 32) * T::VT_ATOM + (kk * 8 % 32) * 4;
        wgmma_tf32_rs<D>(pv, pb[k], smem_desc<128>(vBig + off, 16, 1024));
      }
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(pv);
#pragma unroll
      for (int k = 0; k < KH; ++k) {
        fence_regs(pb[k]);
        fence_regs(ps[k]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // the stage's K and V halves read
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      acc[4 * j] = fmaf(acc[4 * j], alpha0, pv[4 * j]);
      acc[4 * j + 1] = fmaf(acc[4 * j + 1], alpha0, pv[4 * j + 1]);
      acc[4 * j + 2] = fmaf(acc[4 * j + 2], alpha1, pv[4 * j + 2]);
      acc[4 * j + 3] = fmaf(acc[4 * j + 3], alpha1, pv[4 * j + 3]);
    }
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  const float inv0 = 1.0f / l0, inv1 = 1.0f / l1;
  const int n0 = q0 + 64 * g + r0, n1 = n0 + 8;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    const int d = 8 * j + c2;
    if (n0 < Nq)
      *reinterpret_cast<float2*>(o + row_offset(b, n0, h, Nq, H, D) + d) =
          make_float2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
    if (n1 < Nq)
      *reinterpret_cast<float2*>(o + row_offset(b, n1, h, Nq, H, D) + d) =
          make_float2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
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
int launch_tf32(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk,
                int H, float scale, cudaStream_t s) {
  using T = F32Tiles<D>;
  const CUtensorMapSwizzle swz =
      T::SW == 128 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B;
  // Q's map covers the Nq query rows in boxes of 64, K's and V's the Nk
  // keys in boxes of BK
  CUtensorMap maps[3];
  const void* ptrs[3] = {q, k, v};
  for (int i = 0; i < 3; ++i) {
    const cuuint64_t n = i == 0 ? Nq : Nk;
    const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, n, (cuuint64_t)B};
    const cuuint64_t strides[3] = {(cuuint64_t)D * 4, (cuuint64_t)H * D * 4, n * H * D * 4};
    const cuuint32_t box[4] = {(cuuint32_t)T::DB, 1, (cuuint32_t)(i == 0 ? 64 : T::BK), 1};
    if (!vd3d::encode_map_4d(&maps[i], ptrs[i], dims, strides, box, swz,
                             CU_TENSOR_MAP_DATA_TYPE_FLOAT32))
      return (int)cudaErrorInvalidValue;
  }
  static bool configured[vd3d::MAX_DEVICES] = {};  // the attribute, per device
  const int dev = vd3d::current_device();
  if (dev < 0) return (int)cudaErrorInvalidDevice;
  if (!configured[dev]) {
    cudaError_t e = cudaFuncSetAttribute(attention_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, T::BYTES);
    if (e != cudaSuccess) return (int)e;
    configured[dev] = true;
  }
  const dim3 grid((Nq + WG * 64 - 1) / (WG * 64), H, B);
  attention_tf32_kernel<D><<<grid, TF32_THREADS, T::BYTES, s>>>(
      maps[0], maps[1], maps[2], (float*)o, Nq, Nk, H, scale * LOG2E);
  return (int)cudaGetLastError();
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int Nq, int Nk, int H,
           float scale, int bf16, cudaStream_t s) {
  if (bf16) return launch_wgmma<D>(q, k, v, o, B, Nq, Nk, H, scale, s);
  return launch_tf32<D>(q, k, v, o, B, Nq, Nk, H, scale, s);
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
