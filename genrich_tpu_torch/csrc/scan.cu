// coverage_scan: sorted packed class deltas -> float32 coverage
// (optionally -log10 p against a scalar lambda).
//
// Replaces genrich_tpu/ops/pallas_scan.py::coverage_pval_fused (the
// Pallas kernel _kernel, pallas_scan.py:44-113) and the lax chain it
// fuses in genrich_tpu/ops/pipeline_jax.py::tile_coverage (:143-149):
// unpack G groups of four 10-bit class fields, take an inclusive prefix
// sum over all M rows plus a carry, canonicalise each group to float32
// (getVal, Genrich.c:1902-1907) and, with WITH_PVAL (G == 1 only),
// evaluate calcPval against lambda.
//
// Bound: device-memory bandwidth.  The main-path mode (G = 2, no p)
// reads 4 B and writes 8 B per row, with a few integer operations per
// row.  The TPU kernel carried its running sum across grid steps in
// scalar memory, which relies on steps running in order; Hopper blocks
// run in no order.  So this is one launch of a single-pass scan with
// decoupled look-back (Merrill & Garland, "Single-pass Parallel Prefix
// Scan with Decoupled Look-back", 2016):
//   * each block takes the next tile index from an atomic counter, so a
//     tile waits only on tiles whose blocks already started;
//   * a thread loads its 8 consecutive rows with two 16-byte loads
//     (the packed input is read once), sums their channels, and a block
//     scan gives the tile's aggregate;
//   * the tile publishes its aggregate (flag AGG), then one warp walks
//     back over its predecessors 32 at a time, summing aggregates until
//     it meets an inclusive prefix (flag INC), and the tile publishes
//     its own inclusive prefix; the incoming carry is the prefix of
//     tile 0.  Sums are written before their flag with release
//     ordering and read after it with acquire ordering: two round trips
//     per window, but a spinning lane reads 4 bytes, not every sum;
//   * each thread then runs its 8 rows from its exclusive prefix,
//     canonicalises them (no division per row) and stores them through
//     shared memory, so the global stores are coalesced.
// Tiles are small (1,024 rows, 128 threads) so that many blocks are
// resident: a block spends most of its life waiting on its loads and
// its look-back, and other blocks' loads fill that time.
// The tile counter, the per-tile flags and sums live in the wrapper's
// scratch; the launch function zeroes the counter and the flags with one
// cudaMemsetAsync on the stream.  The ragged tail is masked, so M need
// not be a multiple of the tile.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pval.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int ITEMS = 8;                  // consecutive rows per thread
constexpr int TILE = THREADS * ITEMS;     // rows per block
constexpr int WARPS = THREADS / 32;
constexpr int PADDED = TILE + TILE / 32;  // one pad word per 32
constexpr int FLAG_AGG = 1;               // the tile's aggregate is out
constexpr int FLAG_INC = 2;               // its inclusive prefix is out
constexpr unsigned FULL_MASK = 0xffffffffu;

// shared-memory index with a pad word every 32, so the 32 threads of a
// warp writing rows ITEMS*t + k (one k at a time) hit 32 distinct banks
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

// s / 6.0f and t / 10.0f for the values s (0-2) and t (0-4) take,
// rounded to nearest at compile time as the division rounds them at run
// time, so that no division runs per row; other values divide
__device__ __forceinline__ float sixths(int s) {
  constexpr float K1 = 1.0f / 6.0f, K2 = 2.0f / 6.0f;
  return s == 0 ? 0.0f : s == 1 ? K1 : s == 2 ? K2 : (float)s / 6.0f;
}

__device__ __forceinline__ float tenths(int t) {
  constexpr float K1 = 1.0f / 10.0f, K2 = 2.0f / 10.0f,
                  K3 = 3.0f / 10.0f, K4 = 4.0f / 10.0f;
  return t == 0   ? 0.0f
         : t == 1 ? K1
         : t == 2 ? K2
         : t == 3 ? K3
         : t == 4 ? K4
                  : (float)t / 10.0f;
}

// getVal: e8, s6, t10 are cumulative sums of non-negative deltas plus a
// non-negative carry, so unsigned / and % (cheaper by constants than
// signed ones) equal the plain version's floor semantics.  e / 8.0f is
// e * 0.125f exactly.
__device__ __forceinline__ float canon_value(int cov, int e8, int s6,
                                             int t10) {
  const unsigned ue8 = e8, us6 = s6, ut10 = t10;
  const unsigned halves = ue8 / 4 + us6 / 3 + ut10 / 5;
  const int covc = cov + (int)(halves / 2);
  const int e = (int)(ue8 % 4 + 4 * (halves % 2));
  const int s = (int)(us6 % 3);
  const int t = (int)(ut10 % 5);
  float v = (float)covc;
  v = v + (float)e * 0.125f;
  v = v + sixths(s);
  v = v + tenths(t);
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

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];"
               : "=r"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// int32 scratch: [0] tile counter, [1, 1 + ntiles) flags, then the
// tiles' aggregates and inclusive prefixes, C channels each
__host__ __device__ __forceinline__ int64_t scratch_ints(int64_t ntiles,
                                                         int c) {
  return 1 + ntiles * (1 + 2 * (int64_t)c);
}

// The exclusive prefix of tile ``tile`` (> 0), by warp 0: look back over
// the predecessors 32 at a time (lane l reads tile win - l), adding
// aggregates up to the nearest inclusive prefix.  A lane reads its
// predecessor's flag, then (after it, with acquire ordering) the sums
// the flag announces.
template <int C>
__device__ __forceinline__ void look_back(int64_t tile, const int* flags,
                                          const int* agg, const int* inc,
                                          int (&excl)[C]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int c = 0; c < C; ++c) excl[c] = 0;
  for (int64_t win = tile - 1;; win -= 32) {
    const int64_t b = win - lane;
    int f = FLAG_INC;  // before tile 0: never read (tile 0 is INC)
    if (b >= 0) {
      do {
        f = ld_acquire(flags + b);
      } while (f == 0);
    }
    const unsigned incs = __ballot_sync(FULL_MASK, f == FLAG_INC);
    const int nearest = incs ? __ffs(incs) - 1 : 32;
    int v[C];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      v[c] = 0;
      if (b >= 0 && lane <= nearest)
        v[c] = (f == FLAG_INC ? inc : agg)[b * C + c];
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
#pragma unroll
      for (int c = 0; c < C; ++c)
        v[c] += __shfl_xor_sync(FULL_MASK, v[c], off);
    }
#pragma unroll
    for (int c = 0; c < C; ++c) excl[c] += v[c];
    if (incs) return;
  }
}

template <int G, bool WITH_PVAL>
__global__ void __launch_bounds__(THREADS)
coverage_scan_kernel(const int* __restrict__ packed, int64_t m,
                     const int* __restrict__ carry, float lam,
                     float* __restrict__ vals, float* __restrict__ pval,
                     int* __restrict__ scratch, int64_t ntiles) {
  constexpr int C = 4 * G;
  __shared__ float s_out[PADDED];
  __shared__ int s_scan[WARPS * C];
  __shared__ int s_prefix[C];
  __shared__ int64_t s_tile;
  int* const flags = scratch + 1;
  int* const agg = flags + ntiles;
  int* const inc = agg + ntiles * C;
  const int t = threadIdx.x;

  if (t == 0) s_tile = atomicAdd(scratch, 1);
  __syncthreads();
  const int64_t tile = s_tile;
  const int64_t base = tile * TILE;

  // this thread's consecutive rows, 16-byte loads
  int p[ITEMS];
  const int64_t r0 = base + (int64_t)t * ITEMS;
  if (r0 + ITEMS <= m) {
    const int4* src = reinterpret_cast<const int4*>(packed + r0);
#pragma unroll
    for (int q = 0; q < ITEMS / 4; ++q) {
      const int4 v = src[q];
      p[4 * q + 0] = v.x;
      p[4 * q + 1] = v.y;
      p[4 * q + 2] = v.z;
      p[4 * q + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < ITEMS; ++k)
      p[k] = r0 + k < m ? packed[r0 + k] : zero_packed<G>();
  }

  int run[C];
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] = 0;
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int d[C];
    unpack<G>(p[k], d);
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += d[c];
  }
  int total[C];
  block_exclusive_scan<C, THREADS>(run, total, s_scan);

  if (t == 0) {
    if (tile == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s_prefix[c] = carry[c];
        inc[c] = carry[c] + total[c];
      }
      st_release(flags, FLAG_INC);
    } else {
#pragma unroll
      for (int c = 0; c < C; ++c) agg[tile * C + c] = total[c];
      st_release(flags + tile, FLAG_AGG);
    }
  }
  if (tile > 0 && t < 32) {
    int excl[C];
    look_back<C>(tile, flags, agg, inc, excl);
    if (t == 0) {
#pragma unroll
      for (int c = 0; c < C; ++c) {
        s_prefix[c] = excl[c];
        inc[tile * C + c] = excl[c] + total[c];
      }
      st_release(flags + tile, FLAG_INC);
    }
  }
  __syncthreads();
#pragma unroll
  for (int c = 0; c < C; ++c) run[c] += s_prefix[c];

  // every output of this thread's rows: each group's coverage, then p
  constexpr int NOUT = G + (WITH_PVAL ? 1 : 0);
  float o[NOUT][ITEMS];
#pragma unroll
  for (int k = 0; k < ITEMS; ++k) {
    int d[C];
    unpack<G>(p[k], d);
#pragma unroll
    for (int c = 0; c < C; ++c) run[c] += d[c];
#pragma unroll
    for (int g = 0; g < G; ++g)
      o[g][k] = canon_value(run[4 * g], run[4 * g + 1], run[4 * g + 2],
                            run[4 * g + 3]);
    if constexpr (WITH_PVAL) o[G][k] = genrich::calc_pval(o[0][k], lam);
  }

  // stage each output row of the tile through shared memory, so the
  // global stores are coalesced
#pragma unroll
  for (int u = 0; u < NOUT; ++u) {
    float* out = u < G ? vals + (int64_t)u * m : pval;
    __syncthreads();  // the previous row's stores have read s_out
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) s_out[pad(t * ITEMS + k)] = o[u][k];
    __syncthreads();
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int j = k * THREADS + t;
      const int64_t i = base + j;
      if (i < m) out[i] = s_out[pad(j)];
    }
  }
}

template <int G, bool WITH_PVAL>
cudaError_t launch(const int* packed, int64_t m, const int* carry,
                   float lam, float* vals, float* pval, int* scratch,
                   cudaStream_t stream) {
  const int64_t ntiles = (m + TILE - 1) / TILE;
  cudaError_t err = cudaMemsetAsync(
      scratch, 0, (size_t)(1 + ntiles) * sizeof(int), stream);
  if (err != cudaSuccess) return err;
  coverage_scan_kernel<G, WITH_PVAL><<<(unsigned)ntiles, THREADS, 0,
                                       stream>>>(
      packed, m, carry, lam, vals, pval, scratch, ntiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// int32 words of scratch the wrapper allocates for m rows and ``groups``
// groups (tile counter, per-tile flags, aggregates, inclusive prefixes).
int64_t coverage_scan_scratch(int64_t m, int groups) {
  return scratch_ints((m + TILE - 1) / TILE, 4 * groups);
}

// packed: int32 [m], 16-byte aligned; carry: int32 [4 * groups]
// (device); vals: f32 [groups, m]; pval: f32 [m] when with_pval (groups
// must be 1), else unused; scratch: int32 [coverage_scan_scratch(m,
// groups)], zeroed here.  Returns the first CUDA error of the memset and
// the launch.
int coverage_scan_launch(const int* packed, int64_t m, int groups,
                         const int* carry, float lam, int with_pval,
                         float* vals, float* pval, int* scratch,
                         void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  const cudaStream_t s = (cudaStream_t)stream;
  if (groups == 1 && with_pval)
    return (int)launch<1, true>(packed, m, carry, lam, vals, pval, scratch,
                                s);
  if (groups == 1)
    return (int)launch<1, false>(packed, m, carry, lam, vals, pval,
                                 scratch, s);
  if (groups == 2 && !with_pval)
    return (int)launch<2, false>(packed, m, carry, lam, vals, pval,
                                 scratch, s);
  return (int)cudaErrorInvalidValue;
}

const char* kernel_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
