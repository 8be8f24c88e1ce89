// coverage_scan_three_pass: the first design of kernel K1 (scan.cu),
// kept as a reference that the card tests and chip_smoke.py hold the
// current single-pass design to, bit for bit, and time beside it.  It
// is built into a library of its own (kernels.reference_library()) that
// the port never loads.
//
// A reduce-then-scan in three launches:
//   1. scan_block_totals: each block sums its tile's channels;
//   2. scan_block_offsets: one block of 1024 threads takes the
//      exclusive scan of the block totals, starting from the carry
//      (each thread sums a contiguous run of tiles, then one block
//      scan);
//   3. scan_final: each block scans its tile again (thread-local run,
//      __shfl_up_sync warp scan, shared-memory block scan), adds its
//      block offset, canonicalises and stores through shared memory so
//      the global stores are coalesced.
// The packed input is read twice (8 B/row in all).
#include <cuda_runtime.h>
#include <stdint.h>

#include "pval_first.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int ITEMS = 8;                  // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;     // rows per block
constexpr int WARPS = THREADS / 32;
constexpr int PADDED = TILE + TILE / 32;  // one pad word per 32
constexpr int OFFSET_THREADS = 1024;      // the one block of pass 2

// shared-memory index with a pad word every 32, so thread t reading
// rows ITEMS*t .. ITEMS*t+ITEMS-1 hits 32 distinct banks
__device__ __forceinline__ int pad(int j) { return j + (j >> 5); }

template <int G>
__device__ __forceinline__ void unpack(int p, int (&d)[4 * G]) {
#pragma unroll
  for (int g = 0; g < G; ++g) {
    const int grp = (p >> (10 * g)) & 0x3FF;
    d[4 * g + 0] = (grp & 3) - 1;
    d[4 * g + 1] = (grp >> 2) & 7;
    d[4 * g + 2] = (grp >> 5) & 3;
    d[4 * g + 3] = (grp >> 7) & 7;
  }
}

// packed value of G groups of zero deltas (each group's cov field is +1)
template <int G>
__device__ __forceinline__ int zero_packed() {
  return G == 1 ? 1 : (1 | (1 << 10));
}

// getVal: e8, s6, t10 are cumulative sums of non-negative deltas plus a
// non-negative carry, so C's truncating / and % equal floor semantics
__device__ __forceinline__ float canon_value(int cov, int e8, int s6,
                                             int t10) {
  const int halves = e8 / 4 + s6 / 3 + t10 / 5;
  const int covc = cov + halves / 2;
  const int e = e8 % 4 + 4 * (halves % 2);
  const int s = s6 % 3;
  const int t = t10 % 5;
  float v = (float)covc;
  v = v + (float)e / 8.0f;
  v = v + (float)s / 6.0f;
  v = v + (float)t / 10.0f;
  return v;
}

// Exclusive scan across a block of NT threads, C channels per thread.
// v holds this thread's values in and its exclusive prefix out; total
// gets the block's sum.  smem holds (NT / 32) * C ints.
template <int C, int NT>
__device__ __forceinline__ void block_exclusive_scan(int (&v)[C],
                                                     int (&total)[C],
                                                     int* smem) {
  constexpr int NW = NT / 32;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  int inc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) inc[c] = v[c];
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int up = __shfl_up_sync(0xffffffffu, inc[c], off);
      if (lane >= off) inc[c] += up;
    }
  }
  if (lane == 31) {
#pragma unroll
    for (int c = 0; c < C; ++c) smem[warp * C + c] = inc[c];
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) {
    int before = 0, all = 0;
#pragma unroll
    for (int w = 0; w < NW; ++w) {
      const int s = smem[w * C + c];
      if (w < warp) before += s;
      all += s;
    }
    v[c] = before + inc[c] - v[c];
    total[c] = all;
  }
  __syncthreads();  // smem may be reused by the caller
}

template <int G>
__global__ void __launch_bounds__(THREADS)
scan_block_totals(const int* __restrict__ packed, int64_t m,
                  int* __restrict__ totals) {
  constexpr int C = 4 * G;
  __shared__ int smem[WARPS * C];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  int acc[C];
#pragma unroll
  for (int c = 0; c < C; ++c) acc[c] = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int64_t i = base + k * THREADS + threadIdx.x;
    if (i < m) {
      int d[C];
      unpack<G>(packed[i], d);
#pragma unroll
      for (int c = 0; c < C; ++c) acc[c] += d[c];
    }
  }
  // block sum: warp shuffle reduction, then one thread over the warps
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
    for (int c = 0; c < C; ++c)
      acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
  }
  if (lane == 0) {
#pragma unroll
    for (int c = 0; c < C; ++c) smem[warp * C + c] = acc[c];
  }
  __syncthreads();
  if (threadIdx.x < C) {
    int sum = 0;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) sum += smem[w * C + threadIdx.x];
    totals[(int64_t)blockIdx.x * C + threadIdx.x] = sum;
  }
}

// one block; thread t owns the contiguous run of tiles
// [t * per, (t + 1) * per), so a single block-wide scan suffices
template <int G>
__global__ void __launch_bounds__(OFFSET_THREADS)
scan_block_offsets(const int* __restrict__ totals, int64_t nblocks,
                   const int* __restrict__ carry,
                   int* __restrict__ offsets) {
  constexpr int C = 4 * G;
  __shared__ int smem[(OFFSET_THREADS / 32) * C];
  const int64_t per = (nblocks + OFFSET_THREADS - 1) / OFFSET_THREADS;
  const int64_t first = (int64_t)threadIdx.x * per;
  const int64_t lo = first < nblocks ? first : nblocks;
  const int64_t hi = lo + per < nblocks ? lo + per : nblocks;
  int run[C];
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] = 0;
  for (int64_t b = lo; b < hi; ++b) {
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += totals[b * C + c];
  }
  int total[C];
  block_exclusive_scan<C, OFFSET_THREADS>(run, total, smem);
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] += carry[c];
  for (int64_t b = lo; b < hi; ++b) {
#pragma unroll
    for (int c = 0; c < C; ++c) {
      offsets[b * C + c] = run[c];
      run[c] += totals[b * C + c];
    }
  }
}

template <int G, bool WITH_PVAL>
__global__ void __launch_bounds__(THREADS)
scan_final(const int* __restrict__ packed, int64_t m,
           const int* __restrict__ offsets, float lam,
           float* __restrict__ vals, float* __restrict__ pval) {
  constexpr int C = 4 * G;
  __shared__ int s_in[PADDED];
  __shared__ float s_out[PADDED];
  __shared__ int s_scan[WARPS * C];
  const int64_t base = (int64_t)blockIdx.x * TILE;
  const int t = threadIdx.x;

#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    const int j = k * THREADS + t;
    const int64_t i = base + j;
    s_in[pad(j)] = i < m ? packed[i] : zero_packed<G>();
  }
  __syncthreads();

  int run[C];
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int d[C];
    unpack<G>(s_in[pad(t * ITEMS + k)], d);
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += d[c];
  }
  int total[C];
  block_exclusive_scan<C, THREADS>(run, total, s_scan);
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] += offsets[(int64_t)blockIdx.x * C + c];

  float v[G][ITEMS];
  float p[ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int d[C];
    unpack<G>(s_in[pad(t * ITEMS + k)], d);
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += d[c];
#pragma unroll
    for (int g = 0; g < G; ++g)
      v[g][k] = canon_value(run[4 * g], run[4 * g + 1], run[4 * g + 2],
                            run[4 * g + 3]);
    if constexpr (WITH_PVAL) p[k] = genrich::calc_pval(v[0][k], lam);
  }

  // stage each output row of the tile through shared memory, so the
  // global stores are coalesced
  auto store = [&](const float (&src)[ITEMS], float* out) {
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) s_out[pad(t * ITEMS + k)] = src[k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = k * THREADS + t;
      const int64_t i = base + j;
      if (i < m) out[i] = s_out[pad(j)];
    }
  };
#pragma unroll
  for (int g = 0; g < G; ++g) store(v[g], vals + (int64_t)g * m);
  if constexpr (WITH_PVAL) store(p, pval);
}

template <int G, bool WITH_PVAL>
cudaError_t launch(const int* packed, int64_t m, const int* carry,
                   float lam, float* vals, float* pval, int* totals,
                   int* offsets, cudaStream_t stream) {
  const int64_t nblocks = (m + TILE - 1) / TILE;
  scan_block_totals<G><<<(unsigned)nblocks, THREADS, 0, stream>>>(
      packed, m, totals);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_block_offsets<G><<<1, OFFSET_THREADS, 0, stream>>>(
      totals, nblocks, carry, offsets);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  scan_final<G, WITH_PVAL><<<(unsigned)nblocks, THREADS, 0, stream>>>(
      packed, m, offsets, lam, vals, pval);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Rows per block: the caller sizes the two int32 scratch buffers
// (totals, offsets) as ceil(m / tile) * 4 * groups each.
int64_t coverage_scan_three_pass_tile() { return TILE; }

// packed: int32 [m]; carry: int32 [4 * groups] (device); vals: f32
// [groups, m]; pval: f32 [m] when with_pval (groups must be 1), else
// unused.  Returns the first CUDA error of the three launches.
int coverage_scan_three_pass_launch(const int* packed, int64_t m,
                                    int groups, const int* carry,
                                    float lam, int with_pval, float* vals,
                                    float* pval, int* totals, int* offsets,
                                    void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (groups == 1 && with_pval)
    return (int)launch<1, true>(packed, m, carry, lam, vals, pval, totals,
                                offsets, s);
  if (groups == 1)
    return (int)launch<1, false>(packed, m, carry, lam, vals, pval, totals,
                                 offsets, s);
  if (groups == 2 && !with_pval)
    return (int)launch<2, false>(packed, m, carry, lam, vals, pval, totals,
                                 offsets, s);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
