// Per-frame depth statistics: the quantile pair (K3) and the subject
// statistics (K4).
//
// Replace the TPU kernels visiondepth3d_tpu/ops/pallas_stats.py:
// _qpair_kernel (quantile_pair_pallas) and _subject_kernel
// (subject_stats_pallas). Both TPU kernels hold the whole map in VMEM and
// run 12 bisection passes over it, each deciding `count(x <= mid) / n < q`.
// Every bisection midpoint is a multiple of 2^-12, so those counts are
// prefix sums of one histogram with 4096 right-closed bins,
// bin = ceil(x * 4096) - 1, and the 12 decisions replay exactly, in IEEE
// float32 as the bisection takes them: the results are bit-identical. The
// bisection's predicate fl(count(x <= k / 4096) / n) < q only falls as k
// grows, so its 12 decisions end at lo = K / 4096, K the number of k in
// 1 .. 4095 where it holds: 1024 threads count those k at once.
// Bound: one read of the map (device memory bytes). Nothing returns to the
// host.
//
// Both kernels walk their part of the map's row-major (row, column-group)
// grid with no division per element, four columns per float4 load where
// the view allows it, and take ceil(x * 4096) by a round-up add (no
// conversion unit), one shared atomic per value (grouping equal bins with
// __match_any_sync was slower on the card).
//
// K3 runs twice per frame on the whole 1080x1920 map (2.07M values), so it
// needs the whole card in one launch, one device operation per call. It is
// a cooperative launch of one CTA per SM (sized once, before any capture):
// - each CTA zeroes its share of the call's global histogram and ticket
//   (a scratch the wrapper allocates per call, uninitialised: no memset),
//   and counts one contiguous band of rows into a shared-memory histogram;
// - a grid barrier orders the zeroing before any flush; each CTA then adds
//   its nonzero bins to the global histogram (int32 atomics) and takes a
//   ticket (__threadfence, atomicAdd); the last one reads the histogram
//   back and replays both bisections. Nothing outlives the call, so calls
//   on any streams may overlap.
//
// K4 runs three times per frame on a 648x1152 crop (0.9 us of bytes), so
// its launches and fixed costs, not its bytes, set its time. It is one
// launch of one thread-block cluster (16 CTAs, or 8 where 16 cannot be
// scheduled):
// - each CTA counts its share of the crop into a shared-memory 4096-bin
//   histogram of the valid values;
// - the 64-bin floor(x * 64) histogram is not counted separately: its bin
//   i is the right-closed bins 64 i .. 64 i + 63 plus the values exactly
//   on i / 64 minus those exactly on (i + 1) / 64, and only those rare
//   values take a second atomic;
// - after a cluster barrier each CTA sums its slice of 4096 / C bins over
//   the cluster's shared memories (distributed shared memory), scans it,
//   writes its 64-bin values and stores the scanned slice and its total
//   into CTA 0's shared memory;
// - after a second barrier CTA 0 replays the bisection alone, as K3 does.
// No global scratch, no memset, no global atomic: one device event.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int QBINS = 4096;       // the 12-step bisection grid
constexpr int QHIST = QBINS + 1;  // K3: + one bin above 1 (and NaN), never read
constexpr int SUBJECT_BINS = 64;
constexpr int Q_THREADS = 1024;  // QBINS / 4 bins per thread in the replay
constexpr int SUBJ_THREADS = 1024;
constexpr int SUBJ_WARPS = SUBJ_THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

// ------------------------------------------------- shared by K3 and K4

__device__ __forceinline__ int warp_inclusive_scan(int v, int lane) {
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(FULL, v, o);
    if (lane >= o) v += y;
  }
  return v;
}

// 2^23 + ceil(t) for 0 <= t < 2^23: a round-up add at 2^23 (whole numbers
// are exact there) keeps the conversion unit out of the loop
__device__ __forceinline__ float ceil_biased(float t) { return __fadd_ru(t, 8388608.0f); }
__device__ __forceinline__ int unbias(float up) { return __float_as_int(up) - 0x4B000000; }

// This CTA's part of the map: items [begin, end) of the row-major grid of
// `groups` column groups (4 columns with VEC, else 1) per row. Each thread
// steps by THREADS items, carrying its row pointer and column, and hands
// every value to count(v).
template <int THREADS, bool VEC, typename Count>
__device__ __forceinline__ void count_part(const float* __restrict__ x, int groups,
                                           long long ld, int begin, int end, Count count) {
  int i = begin + (int)threadIdx.x;
  if (i >= end) return;
  int r = i / groups;
  int c = i - r * groups;
  const float* row = x + r * ld;
  const int dr = THREADS / groups, dc = THREADS - dr * groups;
  const long long step_ld = (long long)dr * ld;
  auto load = [&](float (&v)[4]) {
    if constexpr (VEC) {
      const float4 f = __ldg(reinterpret_cast<const float4*>(row) + c);
      v[0] = f.x, v[1] = f.y, v[2] = f.z, v[3] = f.w;
    } else {
      v[0] = __ldg(row + c);
    }
    c += dc;
    row += step_ld;
    if (c >= groups) {
      c -= groups;
      row += ld;
    }
  };
  constexpr int G = VEC ? 4 : 1;
  // four loads in flight before any is counted
  for (; i + 3 * THREADS < end; i += 4 * THREADS) {
    float v[4][4];
#pragma unroll
    for (int u = 0; u < 4; ++u) load(v[u]);
#pragma unroll
    for (int u = 0; u < 4; ++u)
#pragma unroll
      for (int g = 0; g < G; ++g) count(v[u][g]);
  }
  for (; i < end; i += THREADS) {
    float v[4];
    load(v);
#pragma unroll
    for (int g = 0; g < G; ++g) count(v[g]);
  }
}

// ------------------------------------------------------------------ K3

// x <= k / 4096 holds for every k >= bin + 1: values <= 0 in bin 0, values
// above 1 (and NaN) in bin 4096, which no k reads
__device__ __forceinline__ int qbin(float v) {
  const int b = unbias(ceil_biased(v * (float)QBINS)) - 1;  // v * 4096 is exact
  return !(v <= 1.0f) ? QBINS : (v <= 0.0f ? 0 : b);
}

// The 12 bisection decisions of both quantiles, replayed on the 4096
// right-closed counts in hist (bin 4096, above 1, is never read) over
// `count` values; run by all Q_THREADS threads of one CTA. Cum over bins
// 4 tid .. 4 tid + 3 is count(x <= k / 4096) at k - 1.
__device__ __forceinline__ void replay_pair(const int* hist, float count, float q0, float q1,
                                            int (&wtot)[Q_THREADS / 32][2], float* out) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 h4 = __ldcg(reinterpret_cast<const int4*>(hist) + tid);
  const int hv[4] = {h4.x, h4.y, h4.z, h4.w};
  int cum[4], s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s += hv[j];
    cum[j] = s;
  }
  // block scan: within the warp, then over the 32 warp totals
  const int incl = warp_inclusive_scan(s, lane);
  if (lane == 31) wtot[warp][0] = incl;
  __syncthreads();
  if (warp == 0) wtot[lane][1] = warp_inclusive_scan(wtot[lane][0], lane) - wtot[lane][0];
  __syncthreads();
  const int base = wtot[warp][1] + incl - s;
  int h0 = 0, h1 = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k1 = 4 * tid + j;  // k - 1
    const float frac = (float)(base + cum[j]) / count;
    h0 += k1 < QBINS - 1 && frac < q0;
    h1 += k1 < QBINS - 1 && frac < q1;
  }
  h0 = __reduce_add_sync(FULL, h0);
  h1 = __reduce_add_sync(FULL, h1);
  __syncthreads();  // wtot is read
  if (lane == 0) {
    wtot[warp][0] = h0;
    wtot[warp][1] = h1;
  }
  __syncthreads();
  if (warp == 0) {
    const int K0 = __reduce_add_sync(FULL, wtot[lane][0]);
    const int K1 = __reduce_add_sync(FULL, wtot[lane][1]);
    if (lane == 0) {
      out[0] = ((float)K0 / (float)QBINS + (float)(K0 + 1) / (float)QBINS) * 0.5f;
      out[1] = ((float)K1 / (float)QBINS + (float)(K1 + 1) / (float)QBINS) * 0.5f;
    }
  }
}

// out[0], out[1]: the bisection quantiles q0, q1 of the [rows, cols] view.
// scratch: QHIST int32 counts and a ticket, any contents on entry.
// Launched cooperatively: every CTA is resident.
template <bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
quantile_pair_kernel(const float* __restrict__ x, int rows, int cols, long long ld, float q0,
                     float q1, int* __restrict__ scratch, float* __restrict__ out) {
  __shared__ int hist[QHIST];
  __shared__ int wtot[Q_THREADS / 32][2];
  __shared__ int is_last;
  const int tid = threadIdx.x;
  int* ghist = scratch;
  unsigned int* ticket = reinterpret_cast<unsigned int*>(scratch + QHIST);

  for (int i = blockIdx.x * Q_THREADS + tid; i <= QHIST; i += gridDim.x * Q_THREADS)
    scratch[i] = 0;
  for (int i = tid; i < QHIST; i += Q_THREADS) hist[i] = 0;
  __syncthreads();
  const int groups = VEC ? cols / 4 : cols;
  const long long n = (long long)rows * groups;  // <= 2^31 - 2^13: the wrapper checks
  count_part<Q_THREADS, VEC>(x, groups, ld, (int)(n * blockIdx.x / gridDim.x),
                             (int)(n * (blockIdx.x + 1) / gridDim.x),
                             [&](float v) { atomicAdd(&hist[qbin(v)], 1); });
  cg::this_grid().sync();  // every CTA's share of the scratch is zero
  // a contiguous band of a depth map touches a fraction of the bins
  for (int i = tid; i < QHIST; i += Q_THREADS)
    if (hist[i]) atomicAdd(&ghist[i], hist[i]);
  __threadfence();
  __syncthreads();
  if (tid == 0) is_last = atomicAdd(ticket, 1u) == gridDim.x - 1;
  __syncthreads();
  if (!is_last) return;

  // the last CTA: every count is in ghist (in L2, where the atomics left it)
  __threadfence();
  replay_pair(ghist, (float)((long long)rows * cols), q0, q1, wtot, out);
}

// CTAs of one call: one per SM (two per SM measured slower: more partial
// histograms to flush), at most one per Q_THREADS items; every CTA must be
// resident, as a cooperative launch requires. 0 where the card cannot be
// queried or cannot hold one CTA per SM.
int qpair_grid(long long items) {
  static int sms_of[vd3d::MAX_DEVICES] = {};  // per device
  const int dev = vd3d::current_device();
  if (dev < 0) return 0;
  int& sms = sms_of[dev];
  if (sms == 0) {
    int n = 0, per_sm = 0;
    if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess ||
        cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, quantile_pair_kernel<true>,
                                                      Q_THREADS, 0) != cudaSuccess ||
        per_sm < 1)
      return 0;
    sms = n;
  }
  const long long g = (items + Q_THREADS - 1) / Q_THREADS;
  return (int)(g < 1 ? 1 : (g > sms ? sms : g));
}

template <bool VEC>
int launch_qpair(const float* x, int rows, int cols, long long ld, float q0, float q1,
                 int* scratch, float* out, int grid, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid, 1, 1);
  cfg.blockDim = dim3(Q_THREADS, 1, 1);
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e =
      cudaLaunchKernelEx(&cfg, quantile_pair_kernel<VEC>, x, rows, cols, ld, q0, q1, scratch, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ------------------------------------------------------------------ K4

struct SubjectSmem {
  int hist[QBINS];              // this CTA's right-closed counts of valid values
  int edge[SUBJECT_BINS + 1];   // valid values exactly on j / 64
  int wtot[SUBJ_WARPS];
  int ends64[QBINS / 8 / 64];   // the slice's prefix at each 64-bin group's end
  // CTA 0 only, written by every CTA before the second cluster barrier:
  int cum[QBINS];               // each slice's own prefix sums
  int total[16];                // each slice's count
};

// One value into the CTA's counts when it lies in the valid band
// 0.05 < v < 0.95.
__device__ __forceinline__ void count_value(float v, int* hist, int* edge) {
  if (!(v > 0.05f && v < 0.95f)) return;
  const float t = v * (float)QBINS;   // exact
  const float up = ceil_biased(t);
  const int c = unbias(up);           // ceil(t): 205 .. 3892
  atomicAdd(&hist[c - 1], 1);
  // on a 64-bin edge: t is whole and a multiple of 64
  if ((c & 63) == 0 && __fsub_rn(up, 8388608.0f) == t) atomicAdd(&edge[c >> 6], 1);
}

// out[0..63]: the 64-bin histogram, out[64]: the valid count, out[65]: the
// masked lower-middle median; all float32.
template <int C, bool VEC>
__global__ void __launch_bounds__(SUBJ_THREADS, 1)
subject_stats_kernel(const float* __restrict__ x, int rows, int cols, long long ld,
                     float* __restrict__ out) {
  constexpr int S = QBINS / C;  // bins per slice
  static_assert(C == 8 || C == 16, "cluster of 8 or 16 CTAs");
  __shared__ SubjectSmem sm;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int i = tid; i < QBINS; i += SUBJ_THREADS) sm.hist[i] = 0;
  if (tid <= SUBJECT_BINS) sm.edge[tid] = 0;
  __syncthreads();
  const int groups = VEC ? cols / 4 : cols;
  const int n = rows * groups;  // <= 2^31 - 2^13: the wrapper checks
  count_part<SUBJ_THREADS, VEC>(x, groups, ld, (int)((long long)n * rank / C),
                                (int)((long long)n * (rank + 1) / C),
                                [&](float v) { count_value(v, sm.hist, sm.edge); });
  cluster.sync();  // every CTA's counts are final

  // this CTA's slice of bins summed over the cluster and scanned, into
  // CTA 0; the S / 64 bins of the 64-bin histogram it covers
  SubjectSmem& sm0 = *cluster.map_shared_rank(&sm, 0);
  int incl = 0, e_lo = 0, e_hi = 0;
  const int i64 = rank * (S / 64) + (tid - S);  // threads S .. S + S/64 - 1
  if (tid < S) {
    int s = 0;
#pragma unroll
    for (int q = 0; q < C; ++q) s += cluster.map_shared_rank(&sm, q)->hist[rank * S + tid];
    incl = warp_inclusive_scan(s, lane);
    if (lane == 31) sm.wtot[warp] = incl;
  } else if (tid < S + S / 64) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int* e = cluster.map_shared_rank(&sm, q)->edge;
      e_lo += e[i64];
      e_hi += e[i64 + 1];
    }
  }
  __syncthreads();
  if (tid < S) {
    for (int w = 0; w < warp; ++w) incl += sm.wtot[w];
    sm0.cum[rank * S + tid] = incl;
    if (tid == S - 1) sm0.total[rank] = incl;
    if ((tid & 63) == 63) sm.ends64[tid >> 6] = incl;
  }
  __syncthreads();
  if (tid >= S && tid < S + S / 64) {
    // right-closed bins 64 i .. 64 i + 63, plus the values on i / 64, less
    // those on (i + 1) / 64
    const int j = tid - S;
    const int right_closed = sm.ends64[j] - (j ? sm.ends64[j - 1] : 0);
    out[i64] = (float)(right_closed + e_lo - e_hi);
  }
  cluster.sync();  // CTA 0 holds every slice's prefix sums and total

  if (rank != 0) return;
  // count(x <= k / 4096) is cum[k - 1] plus the totals of the slices
  // before it. The bisection's predicate fl(count(x <= k / 4096) / n) < q
  // only falls as k grows, so its 12 decisions end at lo = K / 4096, K the
  // number of k in 1 .. 4095 where it holds: count those k in parallel.
  int* base = sm.wtot;  // exclusive offsets of the C slices
  if (warp == 0) {
    const int tot = lane < C ? sm.total[lane] : 0;
    const int ends = warp_inclusive_scan(tot, lane);
    if (lane < C) base[lane] = ends - tot;
    if (lane == C - 1) base[C] = ends;
  }
  __syncthreads();
  const float cnt = (float)base[C];
  const float count = fmaxf(cnt, 1.0f);
  // lower-middle order statistic: 1-based rank floor((n - 1) / 2) + 1
  const float q = (floorf((count - 1.0f) * 0.5f) + 1.0f) / count;
  int holds = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k1 = 4 * tid + j;  // k - 1
    holds += k1 < QBINS - 1 && (float)(base[k1 / S] + sm.cum[k1]) / count < q;
  }
  holds = __reduce_add_sync(FULL, holds);
  __syncthreads();  // base is read; wtot is free
  if (lane == 0) sm.wtot[warp] = holds;
  __syncthreads();
  if (warp == 0) {
    const int K = __reduce_add_sync(FULL, sm.wtot[lane]);
    if (lane == 0) {
      out[SUBJECT_BINS] = cnt;
      out[SUBJECT_BINS + 1] = ((float)K / (float)QBINS + (float)(K + 1) / (float)QBINS) * 0.5f;
    }
  }
}

template <int C>
cudaLaunchConfig_t subject_config(cudaLaunchAttribute* attr, cudaStream_t s) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(C, 1, 1);
  cfg.blockDim = dim3(SUBJ_THREADS, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// 16 where the current card schedules a 16-CTA cluster of this kernel,
// else 8; 0 where the device cannot be read
int subject_cluster_size() {
  static int size_of[vd3d::MAX_DEVICES] = {};  // per device, with its attributes
  const int dev = vd3d::current_device();
  if (dev < 0) return 0;
  int& size = size_of[dev];
  if (size == 0) {
    size = 8;
    const auto kern = subject_stats_kernel<16, true>;
    const auto kern_s = subject_stats_kernel<16, false>;
    cudaLaunchAttribute attr[1];
    const cudaLaunchConfig_t cfg = subject_config<16>(attr, 0);
    int clusters = 0;
    if (cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
            cudaSuccess &&
        cudaFuncSetAttribute(kern_s, cudaFuncAttributeNonPortableClusterSizeAllowed, 1) ==
            cudaSuccess &&
        cudaOccupancyMaxActiveClusters(&clusters, kern, &cfg) == cudaSuccess && clusters > 0)
      size = 16;
    cudaGetLastError();  // a refused query leaves no sticky error
  }
  return size;
}

template <int C, bool VEC>
int launch_subject(const float* x, int rows, int cols, long long ld, float* out,
                   cudaStream_t s) {
  cudaLaunchAttribute attr[1];
  const cudaLaunchConfig_t cfg = subject_config<C>(attr, s);
  cudaError_t e = cudaLaunchKernelEx(&cfg, subject_stats_kernel<C, VEC>, x, rows, cols, ld, out);
  return (int)(e != cudaSuccess ? e : cudaGetLastError());
}

// ------------------------------------------- K3 and K4 over row bands
//
// Under row sharding a frame's rows lie in bands on several devices, and
// every statistic is still the whole frame's. The counts are exact
// integers, so they sum in any order: each band is counted into a
// histogram on its own device (the band kernels), the histograms are
// summed on one device, and one small launch there replays the bisection
// on the sum (the finish kernels). The decisions, and so the results, are
// those of the one-shot kernels on the whole frame, bit for bit.
//
// - quantile_hist_band_kernel adds the QHIST qbin counts of a [rows, cols]
//   view into a caller's int32 buffer (zeroed by the caller; the bands of
//   one frame on one device add into one buffer). One CTA per SM, each a
//   shared-memory histogram of its items flushed by global atomics.
// - subject_hist_band_kernel adds, for the valid values of a view, the
//   4096 right-closed counts and the 65 counts of values exactly on j / 64
//   (K4's edge counts) into a SUBJ_BAND int32 buffer the same way.
// - quantile_pair_finish_kernel replays K3's two bisections on a summed
//   QHIST buffer over n values (one CTA, K3's own replay).
// - subject_stats_finish_kernel writes K4's 66 outputs from a summed
//   SUBJ_BAND buffer (one CTA): the 64-bin histogram, the count and the
//   masked lower-middle median.
// Bound: the band kernels read their view once; the finish kernels read
// 16 KB.

constexpr int SUBJ_BAND = QBINS + SUBJECT_BINS + 1;  // counts, then the 65 edge counts

template <bool VEC>
__global__ void __launch_bounds__(Q_THREADS)
quantile_hist_band_kernel(const float* __restrict__ x, int rows, int cols, long long ld,
                          int* __restrict__ hist) {
  __shared__ int sh[QHIST];
  const int tid = threadIdx.x;
  for (int i = tid; i < QHIST; i += Q_THREADS) sh[i] = 0;
  __syncthreads();
  const int groups = VEC ? cols / 4 : cols;
  const long long n = (long long)rows * groups;  // <= 2^31 - 2^13: the wrapper checks
  count_part<Q_THREADS, VEC>(x, groups, ld, (int)(n * blockIdx.x / gridDim.x),
                             (int)(n * (blockIdx.x + 1) / gridDim.x),
                             [&](float v) { atomicAdd(&sh[qbin(v)], 1); });
  __syncthreads();
  for (int i = tid; i < QHIST; i += Q_THREADS)
    if (sh[i]) atomicAdd(&hist[i], sh[i]);
}

template <bool VEC>
__global__ void __launch_bounds__(SUBJ_THREADS)
subject_hist_band_kernel(const float* __restrict__ x, int rows, int cols, long long ld,
                         int* __restrict__ buf) {
  __shared__ int sh[SUBJ_BAND];
  const int tid = threadIdx.x;
  for (int i = tid; i < SUBJ_BAND; i += SUBJ_THREADS) sh[i] = 0;
  __syncthreads();
  const int groups = VEC ? cols / 4 : cols;
  const long long n = (long long)rows * groups;
  count_part<SUBJ_THREADS, VEC>(x, groups, ld, (int)(n * blockIdx.x / gridDim.x),
                                (int)(n * (blockIdx.x + 1) / gridDim.x),
                                [&](float v) { count_value(v, sh, sh + QBINS); });
  __syncthreads();
  for (int i = tid; i < SUBJ_BAND; i += SUBJ_THREADS)
    if (sh[i]) atomicAdd(&buf[i], sh[i]);
}

__global__ void __launch_bounds__(Q_THREADS)
quantile_pair_finish_kernel(const int* __restrict__ hist, long long n, float q0, float q1,
                            float* __restrict__ out) {
  __shared__ int wtot[Q_THREADS / 32][2];
  replay_pair(hist, (float)n, q0, q1, wtot, out);
}

// out[0..63]: the 64-bin histogram, out[64]: the valid count, out[65]: the
// masked lower-middle median, as subject_stats_kernel writes them.
__global__ void __launch_bounds__(Q_THREADS)
subject_stats_finish_kernel(const int* __restrict__ buf, float* __restrict__ out) {
  __shared__ int wtot[Q_THREADS / 32];
  __shared__ int ends[SUBJECT_BINS];  // the prefix count at each 64-bin group's last bin
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int4 h4 = __ldcg(reinterpret_cast<const int4*>(buf) + tid);
  const int hv[4] = {h4.x, h4.y, h4.z, h4.w};
  int cum[4], s = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s += hv[j];
    cum[j] = s;
  }
  const int incl = warp_inclusive_scan(s, lane);
  if (lane == 31) wtot[warp] = incl;
  __syncthreads();
  int base = incl - s;  // the count of the bins before 4 tid
  for (int w = 0; w < warp; ++w) base += wtot[w];
  if ((tid & 15) == 15) ends[tid >> 4] = base + cum[3];
  __syncthreads();
  if (tid < SUBJECT_BINS) {
    // right-closed bins 64 i .. 64 i + 63, plus the values on i / 64, less
    // those on (i + 1) / 64
    const int* edge = buf + QBINS;
    out[tid] = (float)(ends[tid] - (tid ? ends[tid - 1] : 0) + __ldcg(edge + tid) -
                       __ldcg(edge + tid + 1));
  }
  const float cnt = (float)ends[SUBJECT_BINS - 1];
  const float count = fmaxf(cnt, 1.0f);
  const float q = (floorf((count - 1.0f) * 0.5f) + 1.0f) / count;
  int holds = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k1 = 4 * tid + j;  // k - 1
    holds += k1 < QBINS - 1 && (float)(base + cum[j]) / count < q;
  }
  holds = __reduce_add_sync(FULL, holds);
  __syncthreads();  // wtot is read
  if (lane == 0) wtot[warp] = holds;
  __syncthreads();
  if (warp == 0) {
    const int K = __reduce_add_sync(FULL, wtot[lane]);
    if (lane == 0) {
      out[SUBJECT_BINS] = cnt;
      out[SUBJECT_BINS + 1] = ((float)K / (float)QBINS + (float)(K + 1) / (float)QBINS) * 0.5f;
    }
  }
}

template <typename Kern>
int launch_band(Kern kern, const float* x, int rows, int cols, long long ld, int* buf,
                int threads, cudaStream_t s) {
  const int grid = qpair_grid((long long)rows * cols / 4 + 1);
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  kern<<<grid, threads, 0, s>>>(x, rows, cols, ld, buf);
  return (int)cudaGetLastError();
}

bool vec_view(const void* x, int cols, long long ld) {
  return ((size_t)x % 16) == 0 && ld % 4 == 0 && cols % 4 == 0;
}

__global__ void empty_kernel() {}

}  // namespace

// x: a [rows, cols] float32 view with row stride ld (elements); out: 2
// float32; scratch: QHIST + 1 int32 of this call (overwritten).
// rows * cols <= 2^31 - 2^13.
extern "C" int vd3d_quantile_pair(const void* x, int rows, int cols, long long ld,
                                  float q0, float q1, void* scratch, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const bool vec = ((size_t)x % 16) == 0 && ld % 4 == 0 && cols % 4 == 0;
  const int grid = qpair_grid((long long)rows * (vec ? cols / 4 : cols));
  if (grid == 0) return (int)cudaErrorInvalidConfiguration;
  const float* xf = (const float*)x;
  return vec ? launch_qpair<true>(xf, rows, cols, ld, q0, q1, (int*)scratch, (float*)out, grid, s)
             : launch_qpair<false>(xf, rows, cols, ld, q0, q1, (int*)scratch, (float*)out, grid,
                                   s);
}

// x: a [rows, cols] float32 view with row stride ld (elements); out: 66
// float32 (64 histogram values, count, median). rows * cols <= 2^31 - 2^13.
extern "C" int vd3d_subject_stats(const void* x, int rows, int cols, long long ld, void* out,
                                  void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  float* o = (float*)out;
  const bool vec = ((size_t)x % 16) == 0 && ld % 4 == 0 && cols % 4 == 0;
  const int cluster = subject_cluster_size();
  if (cluster == 0) return (int)cudaErrorInvalidDevice;
  if (cluster == 16)
    return vec ? launch_subject<16, true>(xf, rows, cols, ld, o, s)
               : launch_subject<16, false>(xf, rows, cols, ld, o, s);
  return vec ? launch_subject<8, true>(xf, rows, cols, ld, o, s)
             : launch_subject<8, false>(xf, rows, cols, ld, o, s);
}

// x: a [rows, cols] float32 view with row stride ld (elements); hist: QHIST
// int32 the counts are added into. rows * cols <= 2^31 - 2^13.
extern "C" int vd3d_quantile_hist_band(const void* x, int rows, int cols, long long ld,
                                       void* hist, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  return vec_view(x, cols, ld)
             ? launch_band(quantile_hist_band_kernel<true>, xf, rows, cols, ld, (int*)hist,
                           Q_THREADS, s)
             : launch_band(quantile_hist_band_kernel<false>, xf, rows, cols, ld, (int*)hist,
                           Q_THREADS, s);
}

// hist: QHIST int32 summed over a frame's bands; n: the frame's values;
// out: 2 float32.
extern "C" int vd3d_quantile_pair_finish(const void* hist, long long n, float q0, float q1,
                                         void* out, void* stream) {
  quantile_pair_finish_kernel<<<1, Q_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)hist, n, q0, q1, (float*)out);
  return (int)cudaGetLastError();
}

// x: a [rows, cols] float32 view (a band's rows of the subject crop); buf:
// SUBJ_BAND int32 the counts are added into.
extern "C" int vd3d_subject_hist_band(const void* x, int rows, int cols, long long ld,
                                      void* buf, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const float* xf = (const float*)x;
  return vec_view(x, cols, ld)
             ? launch_band(subject_hist_band_kernel<true>, xf, rows, cols, ld, (int*)buf,
                           SUBJ_THREADS, s)
             : launch_band(subject_hist_band_kernel<false>, xf, rows, cols, ld, (int*)buf,
                           SUBJ_THREADS, s);
}

// buf: SUBJ_BAND int32 summed over a frame's bands; out: 66 float32.
extern "C" int vd3d_subject_stats_finish(const void* buf, void* out, void* stream) {
  subject_stats_finish_kernel<<<1, Q_THREADS, 0, (cudaStream_t)stream>>>((const int*)buf,
                                                                         (float*)out);
  return (int)cudaGetLastError();
}

extern "C" int vd3d_subject_cluster() { return subject_cluster_size(); }

// An empty kernel: the cost of one launch, the floor under K3's and K4's times.
extern "C" int vd3d_empty(void* stream) {
  empty_kernel<<<1, 32, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

extern "C" const char* vd3d_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
