// Self-attention softmax(Q K^T / sqrt(d)) V over BNHD tensors, in two passes
// over key tiles.
//
// Replaces the TPU kernel visiondepth3d_tpu/ops/pallas_attention.py:
// vmem_attention (_attn_kernel). Same numerics: logits and the softmax
// statistics in float32, the normalized probabilities rounded to the input
// type before P V, P V accumulated in float32, one rounding of the output.
// Key columns past N are masked to -1e30; query rows past N are not stored.
// Q, K, V and O are read and written in place as [B, N, H, D] with the token
// stride H * D (no transposed or padded copies).
//
// The TPU kernel keeps one (batch, head)'s whole K and V resident in VMEM.
// At the depth model's shape (N = 1370, D = 64, bf16) that is 350 KB, more
// than the 227 KB of shared memory of one H100 SM, so here K and V stream
// through shared memory in tiles of 64 keys. A block owns 64 query rows of
// one (batch, head):
//   pass 1: S = Q K^T per key tile, the running row max m and the running
//           sum l of exp(s - m) (an online update);
//   pass 2: S again, p = exp(s - m) / l rounded to the input type, O += P V.
// The second pass costs a third matrix product and a second exponential
// per logit; in exchange P is formed already normalized (the TPU kernel's
// rounding point) and no accumulator has to be rescaled.
//
// - bfloat16: WMMA 16x16x16 tensor-core products (bf16 operands, f32
//   accumulators), four warps of 16 query rows each.
// - float32: CUDA-core FMAs in full float32 (no TF32), 256 threads with a
//   4 x 4 register tile each.
//
// What bounds it on the H100: at [16, 1370, 6, 64] bf16 the two products
// are 46 GFLOP per call (0.047 ms at the tensor cores' peak) against 67 MB
// of Q, K, V and O (0.020 ms), and 2 x 180 M exponentials (about 0.04 ms
// per pass on the special-function units): operations. Not done yet: a
// one-pass online softmax, wgmma, TMA, and double-buffered tiles.

#include <mma.h>

#include "common.cuh"

namespace {

constexpr int BQ = 64;  // query rows per block
constexpr int BK = 64;  // keys per tile
constexpr float MASKED = -1e30f;
static_assert(BQ == BK, "the float32 kernel stages Q and K tiles alike");

__device__ __forceinline__ size_t row_offset(int b, int n, int h, int N, int H, int D) {
  return (((size_t)b * N + n) * H + h) * D;
}

// rows [r0, r0 + rows) of one (b, h) of a BNHD tensor into s[rows][ld]
// (zero past N), in 16-byte vectors
template <typename T, int D>
__device__ __forceinline__ void load_rows(const T* __restrict__ x, T* __restrict__ s, int ld,
                                          int b, int h, int r0, int rows, int N, int H,
                                          int nthreads) {
  constexpr int VEC = 16 / sizeof(T);
  constexpr int VPR = D / VEC;
  for (int i = threadIdx.x; i < rows * VPR; i += nthreads) {
    const int r = i / VPR, c = (i % VPR) * VEC;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (r0 + r < N)
      v = *reinterpret_cast<const uint4*>(x + row_offset(b, r0 + r, h, N, H, D) + c);
    *reinterpret_cast<uint4*>(s + r * ld + c) = v;
  }
}

// ---------------------------------------------------------------- bfloat16

constexpr int WMMA_THREADS = 128;  // four warps x 16 query rows

template <int D>
struct WmmaSmem {
  static constexpr int LDK = D + 8;                       // bf16, K and V tiles
  static constexpr int LDS = (BK > D ? BK : D) + 4;       // f32 scores / output
  static constexpr int LDP = BK + 8;                      // bf16 probabilities
  static constexpr int Q = 0;
  static constexpr int K = Q + BQ * LDK * 2;
  static constexpr int V = K + BK * LDK * 2;
  static constexpr int S = V + BK * LDK * 2;
  static constexpr int P = S + 4 * 16 * LDS * 4;
  static constexpr int BYTES = P + 4 * 16 * LDP * 2;
};

template <int D>
__global__ void __launch_bounds__(WMMA_THREADS)
attention_wmma_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                      int N, int H, float scale) {
  namespace wmma = nvcuda::wmma;
  using bf16 = __nv_bfloat16;
  using L = WmmaSmem<D>;
  constexpr int DF = D / 16, KF = BK / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem + L::Q);
  bf16* sK = reinterpret_cast<bf16*>(smem + L::K);
  bf16* sV = reinterpret_cast<bf16*>(smem + L::V);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  float* sS = reinterpret_cast<float*>(smem + L::S) + warp * 16 * L::LDS;
  bf16* sP = reinterpret_cast<bf16*>(smem + L::P) + warp * 16 * L::LDP;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;

  load_rows<bf16, D>(q, sQ, L::LDK, b, h, q0, BQ, N, H, WMMA_THREADS);
  __syncthreads();
  wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> qf[DF];
#pragma unroll
  for (int kk = 0; kk < DF; ++kk)
    wmma::load_matrix_sync(qf[kk], sQ + warp * 16 * L::LDK + kk * 16, L::LDK);

  // S = Q K^T for the warp's 16 rows and the tile's BK keys, into sS
  auto scores = [&]() {
#pragma unroll
    for (int j = 0; j < KF; ++j) {
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.0f);
#pragma unroll
      for (int kk = 0; kk < DF; ++kk) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::col_major> kf;
        wmma::load_matrix_sync(kf, sK + j * 16 * L::LDK + kk * 16, L::LDK);
        wmma::mma_sync(acc, qf[kk], kf, acc);
      }
      wmma::store_matrix_sync(sS + j * 16, acc, L::LDS, wmma::mem_row_major);
    }
    __syncwarp();
  };

  // two lanes per row: lane owns row lane / 2, columns (lane % 2) * 32 + [0, 32)
  const int r = lane / 2, c0 = (lane % 2) * (BK / 2);
  float m = -INFINITY, l = 0.0f;
  const int n_tiles = (N + BK - 1) / BK;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_rows<bf16, D>(k, sK, L::LDK, b, h, k0, BK, N, H, WMMA_THREADS);
    __syncthreads();
    scores();
    float mt = MASKED;
    for (int c = c0; c < c0 + BK / 2; ++c)
      mt = fmaxf(mt, k0 + c < N ? sS[r * L::LDS + c] * scale : MASKED);
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    const float m_new = fmaxf(m, mt);
    float sum = 0.0f;
    for (int c = c0; c < c0 + BK / 2; ++c)
      sum += expf((k0 + c < N ? sS[r * L::LDS + c] * scale : MASKED) - m_new);
    sum += __shfl_xor_sync(0xffffffffu, sum, 1);
    l = l * expf(m - m_new) + sum;
    m = m_new;
    __syncwarp();
  }

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> of[DF];
#pragma unroll
  for (int jd = 0; jd < DF; ++jd) wmma::fill_fragment(of[jd], 0.0f);
  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * BK;
    __syncthreads();
    load_rows<bf16, D>(k, sK, L::LDK, b, h, k0, BK, N, H, WMMA_THREADS);
    load_rows<bf16, D>(v, sV, L::LDK, b, h, k0, BK, N, H, WMMA_THREADS);
    __syncthreads();
    scores();
    for (int c = c0; c < c0 + BK / 2; ++c) {
      const float s = k0 + c < N ? sS[r * L::LDS + c] * scale : MASKED;
      sP[r * L::LDP + c] = __float2bfloat16_rn(expf(s - m) / l);
    }
    __syncwarp();
#pragma unroll
    for (int kk = 0; kk < KF; ++kk) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> pf;
      wmma::load_matrix_sync(pf, sP + kk * 16, L::LDP);
#pragma unroll
      for (int jd = 0; jd < DF; ++jd) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> vf;
        wmma::load_matrix_sync(vf, sV + kk * 16 * L::LDK + jd * 16, L::LDK);
        wmma::mma_sync(of[jd], pf, vf, of[jd]);
      }
    }
    __syncwarp();
  }

#pragma unroll
  for (int jd = 0; jd < DF; ++jd)
    wmma::store_matrix_sync(sS + jd * 16, of[jd], L::LDS, wmma::mem_row_major);
  __syncwarp();
  for (int e = lane; e < 16 * D; e += 32) {
    const int rr = e / D, d = e % D, n = q0 + warp * 16 + rr;
    if (n < N) o[row_offset(b, n, h, N, H, D) + d] = __float2bfloat16_rn(sS[rr * L::LDS + d]);
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
                     const float* __restrict__ v, float* __restrict__ o, int N, int H,
                     float scale) {
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
  auto load_padded = [&](const float* x, float* s, int r0) {
    for (int i = tid; i < BQ * D; i += FMA_THREADS) {
      const int rr = i / D, d = i % D;
      s[rr * L::LDQ + d] = r0 + rr < N ? x[row_offset(b, r0 + rr, h, N, H, D) + d] : 0.0f;
    }
  };
  load_padded(q, sQ, q0);

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
            k0 + tx + 16 * j < N ? acc[i][j] * scale : MASKED;
  };

  // row statistics: four lanes per row, 16 keys each
  const int sr = tid / 4, sc = (tid % 4) * (BK / 4);
  float m = -INFINITY, l = 0.0f;
  const int n_tiles = (N + BK - 1) / BK;
  for (int t = 0; t < n_tiles; ++t) {
    __syncthreads();
    load_padded(k, sK, t * BK);
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
    load_padded(k, sK, k0);
    for (int i = tid; i < BK * D; i += FMA_THREADS) {
      const int rr = i / D, d = i % D;
      sV[i] = k0 + rr < N ? v[row_offset(b, k0 + rr, h, N, H, D) + d] : 0.0f;
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
    if (n >= N) continue;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[row_offset(b, n, h, N, H, D) + tx + 16 * j] = acc[i][j];
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int N, int H,
           float scale, int bf16, cudaStream_t s) {
  const dim3 grid((N + BQ - 1) / BQ, H, B);
  if (bf16) {
    constexpr int bytes = WmmaSmem<D>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(attention_wmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attention_wmma_kernel<D><<<grid, WMMA_THREADS, bytes, s>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (__nv_bfloat16*)o, N, H, scale);
  } else {
    constexpr int bytes = FmaSmem<D>::BYTES;
    cudaError_t e = cudaFuncSetAttribute(attention_fma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return (int)e;
    attention_fma_kernel<D><<<grid, FMA_THREADS, bytes, s>>>(
        (const float*)q, (const float*)k, (const float*)v, (float*)o, N, H, scale);
  }
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, o [B, N, H, D] contiguous, float32 or bf16, 16-byte aligned;
// D in {16, 32, 64, 128}.
extern "C" int vd3d_attention(const void* q, const void* k, const void* v, void* o, int B,
                              int N, int H, int D, float scale, int bf16, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, B, N, H, scale, bf16, s);
    case 32: return launch<32>(q, k, v, o, B, N, H, scale, bf16, s);
    case 64: return launch<64>(q, k, v, o, B, N, H, scale, bf16, s);
    case 128: return launch<128>(q, k, v, o, B, N, H, scale, bf16, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
