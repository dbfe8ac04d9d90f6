// Per-frame depth statistics: the quantile pair and the subject statistics.
//
// Replace the TPU kernels visiondepth3d_tpu/ops/pallas_stats.py:
// _qpair_kernel (quantile_pair_pallas) and _subject_kernel
// (subject_stats_pallas). Both TPU kernels hold the whole map in VMEM and
// run 12 bisection passes over it, each deciding `count(x <= mid) / n < q`.
// Every bisection midpoint is a multiple of 2^-12, so those counts are
// prefix sums of one histogram with 4096 right-closed bins,
// bin = ceil(x * 4096) - 1. Here one grid-wide pass builds that histogram
// (shared-memory counts per block, then int32 atomics into device memory)
// and a one-block kernel replays the 12 decisions from its prefix sums, in
// IEEE float32 exactly as the bisection does: the results are bit-identical.
// Bound: one read of the map (device memory bytes); the replay is a few
// microseconds of one block. Nothing returns to the host.

#include "common.cuh"

namespace {

constexpr int QBINS = 4096;       // the 12-step bisection grid
constexpr int QHIST = QBINS + 1;  // + one bin above 1 (and NaN): never counted
constexpr int SUBJECT_BINS = 64;
constexpr int ITERS = 12;
constexpr int HIST_THREADS = 256;
constexpr int SCAN_THREADS = 1024;  // QBINS / 4 bins per thread

__device__ __forceinline__ int qbin(float v) {
  if (!(v <= 1.0f)) return QBINS;
  if (v <= 0.0f) return 0;
  return (int)ceilf(v * (float)QBINS) - 1;  // v * 4096 is exact
}

// SUBJECT: count only the valid band 0.05 < v < 0.95, and also build the
// 64-bin floor(v * 64) histogram (left-closed bins: not nested in the grid).
template <bool SUBJECT>
__global__ void __launch_bounds__(HIST_THREADS)
hist_kernel(const float* __restrict__ x, int rows, int cols, long long ld,
            int* __restrict__ qhist, int* __restrict__ hist64) {
  __shared__ int sq[QHIST];
  __shared__ int s64[SUBJECT_BINS];
  for (int i = threadIdx.x; i < QHIST; i += HIST_THREADS) sq[i] = 0;
  if (SUBJECT && threadIdx.x < SUBJECT_BINS) s64[threadIdx.x] = 0;
  __syncthreads();
  const long long n = (long long)rows * cols;
  const long long stride = (long long)gridDim.x * HIST_THREADS;
  for (long long i = (long long)blockIdx.x * HIST_THREADS + threadIdx.x; i < n;
       i += stride) {
    const long long r = i / cols;
    const float v = x[r * ld + (i - r * cols)];
    if (SUBJECT) {
      if (!(v > 0.05f && v < 0.95f)) continue;
      atomicAdd(&s64[min(max((int)floorf(v * (float)SUBJECT_BINS), 0),
                         SUBJECT_BINS - 1)], 1);
    }
    atomicAdd(&sq[qbin(v)], 1);
  }
  __syncthreads();
  for (int i = threadIdx.x; i < QHIST; i += HIST_THREADS)
    if (sq[i]) atomicAdd(&qhist[i], sq[i]);
  if (SUBJECT && threadIdx.x < SUBJECT_BINS && s64[threadIdx.x])
    atomicAdd(&hist64[threadIdx.x], s64[threadIdx.x]);
}

// cum[b] = sum of qhist[0..b] for b < QBINS; one block of SCAN_THREADS.
__device__ void prefix_sums(const int* __restrict__ qhist, int* cum, int* part) {
  const int t = threadIdx.x;
  int local[4];
  int s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s += qhist[4 * t + j];
    local[j] = s;
  }
  part[t] = s;
  __syncthreads();
  for (int off = 1; off < SCAN_THREADS; off <<= 1) {
    const int v = t >= off ? part[t - off] : 0;
    __syncthreads();
    part[t] += v;
    __syncthreads();
  }
  const int base = t > 0 ? part[t - 1] : 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) cum[4 * t + j] = base + local[j];
  __syncthreads();
}

// The bisection's decisions: count(x <= k/4096) is cum[k - 1].
__device__ float bisect(const int* cum, float q, float count) {
  float lo = 0.0f, hi = 1.0f;
  for (int it = 0; it < ITERS; ++it) {
    const float mid = (lo + hi) * 0.5f;
    const int k = (int)(mid * (float)QBINS);  // exact: mid is k / 4096
    if ((float)cum[k - 1] / count < q) lo = mid;
    else hi = mid;
  }
  return (lo + hi) * 0.5f;
}

__global__ void __launch_bounds__(SCAN_THREADS)
qpair_replay_kernel(const int* __restrict__ qhist, float q0, float q1, float n,
                    float* __restrict__ out) {
  __shared__ int cum[QBINS];
  __shared__ int part[SCAN_THREADS];
  prefix_sums(qhist, cum, part);
  if (threadIdx.x == 0) out[0] = bisect(cum, q0, n);
  if (threadIdx.x == 1) out[1] = bisect(cum, q1, n);
}

__global__ void __launch_bounds__(SCAN_THREADS)
subject_replay_kernel(const int* __restrict__ qhist, const int* __restrict__ hist64,
                      float* __restrict__ hist_out, float* __restrict__ stats) {
  __shared__ int cum[QBINS];
  __shared__ int part[SCAN_THREADS];
  prefix_sums(qhist, cum, part);
  if (threadIdx.x < SUBJECT_BINS) hist_out[threadIdx.x] = (float)hist64[threadIdx.x];
  if (threadIdx.x == 0) {
    const float cnt = (float)(cum[QBINS - 1] + qhist[QBINS]);
    const float count = fmaxf(cnt, 1.0f);
    // lower-middle order statistic: 1-based rank floor((n - 1) / 2) + 1
    const float q = (floorf((count - 1.0f) * 0.5f) + 1.0f) / count;
    stats[0] = cnt;
    stats[1] = bisect(cum, q, count);
  }
}

int hist_grid(long long n) {
  const long long per_block = (long long)HIST_THREADS * 16;
  long long g = (n + per_block - 1) / per_block;
  return (int)(g < 1 ? 1 : (g > 1024 ? 1024 : g));
}

}  // namespace

extern "C" int vd3d_quantile_pair(const void* x, int rows, int cols, long long ld,
                                  float q0, float q1, void* qhist, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)rows * cols;
  cudaError_t e = cudaMemsetAsync(qhist, 0, QHIST * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  hist_kernel<false><<<hist_grid(n), HIST_THREADS, 0, s>>>(
      (const float*)x, rows, cols, ld, (int*)qhist, nullptr);
  qpair_replay_kernel<<<1, SCAN_THREADS, 0, s>>>((const int*)qhist, q0, q1,
                                                 (float)n, (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int vd3d_subject_stats(const void* x, int rows, int cols, long long ld,
                                  void* qhist, void* hist64, void* hist_out,
                                  void* stats, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const long long n = (long long)rows * cols;
  cudaError_t e = cudaMemsetAsync(qhist, 0, QHIST * sizeof(int), s);
  if (e == cudaSuccess) e = cudaMemsetAsync(hist64, 0, SUBJECT_BINS * sizeof(int), s);
  if (e != cudaSuccess) return (int)e;
  hist_kernel<true><<<hist_grid(n), HIST_THREADS, 0, s>>>(
      (const float*)x, rows, cols, ld, (int*)qhist, (int*)hist64);
  subject_replay_kernel<<<1, SCAN_THREADS, 0, s>>>(
      (const int*)qhist, (const int*)hist64, (float*)hist_out, (float*)stats);
  return (int)cudaGetLastError();
}

extern "C" const char* vd3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
