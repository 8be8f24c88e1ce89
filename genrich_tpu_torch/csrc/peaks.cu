// peak_reduce: per-peak AUC and summit, walking each peak's rows in order.
//
// Replaces the per-peak reductions of
// genrich_tpu/ops/peaks_jax.py::call_peaks: the float32 prefix sum whose
// differences give AUC (:85-87, :113-116) and the two lexicographic
// sorts that find the summit (:98-103, :120-126); in the port's plain
// version, the prefix sum and the four scatter_reduce calls of
// ops/peaks.py.  Semantics are callPeaks/updatePeak (Genrich.c:948-1069):
//   AUC = sum over the peak's significant rows of
//         (float)len * (stat - threshold), added in row order in float32
//         (the exact engine's order, so the result is the same on every
//         run and bitwise the exact engine's);
//   summit position: max stat, then the longest interval, then the
//         earliest row; its midpoint is taken in 64 bits;
//   summit p and q: the first max-stat row.
//
// Bound: the add chain.  The sum can run in one order only, so a peak
// of n rows costs n dependent float adds (about 4 cycles each) however
// many threads feed it; the bytes it reads (21 per row) are far below that
// on a main-path chromosome, whose ~120 peaks have ~12,500 rows each.
// The design keeps the chain busy and nothing else on it, in one launch
// of a grid that the card holds at once; block b takes the candidates
// b, b + grid, b + 2 grid, ... (so the long peaks, which sit next to
// each other at the end of the candidate list, spread over blocks):
//   * screen: one thread per candidate.  Most candidates are empty (the
//     engine's candidate cap is far above the peaks a chromosome has)
//     and get their outputs here; the others go to the block's lists in
//     shared memory, short or long (more than LONG_ROWS rows);
//   * long peaks, one at a time, the whole block on each.  Eight
//     producer warps stream the rows with 16-byte loads, compute each
//     row's contribution (0 for rows that are not significant; the
//     product rounds before it is added: no FMA, see kernels.py) and
//     fold the summit, and write the contributions into a ring of
//     STAGES x CHUNK floats in shared memory.  One consumer thread adds
//     the ring in row order, its shared-memory reads issued a batch
//     ahead of the adds that need them.  Named barriers (FULL / EMPTY
//     per stage) hand stages between them, so the loads of later chunks
//     overlap the adds of earlier ones;
//   * short peaks, one warp each: each step the 32 lanes load 32 rows
//     (the next 32 rows' loads in flight during the step) and every lane
//     adds the 32 contributions in row order through shuffles.  A block
//     per peak would leave most of its threads idle on the synthetic
//     shape's ~76-row peaks.
// Each summit carries its row's p, q, start and end, so writing it needs
// no load that waits on the reduction.  Each peak is computed whole by
// one warp or one block, so the lists' order does not reach the
// outputs.  Summit folds use the (max stat, max length, min row) and
// (max stat, min row) orders, which are associative, so the combination
// order does not matter.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr unsigned FULL_MASK = 0xffffffffu;
constexpr int64_t LONG_ROWS = 1024;  // more rows than this: block path

// PRODUCER_WARPS producer warps + one consumer warp for a long peak;
// every warp takes short peaks
constexpr int PRODUCER_WARPS = 8;
constexpr int PRODUCERS = PRODUCER_WARPS * 32;
constexpr int THREADS = PRODUCERS + 32;
constexpr int WARPS = THREADS / 32;
constexpr int MIN_BLOCKS = 4;                          // per SM
constexpr int ROWS_PER_PRODUCER = 4;                   // one 16-byte load
constexpr int CHUNK = PRODUCERS * ROWS_PER_PRODUCER;   // rows per stage
constexpr int STAGES = 4;
constexpr int BATCH = 4;             // float4 reads the adder issues ahead
constexpr int BAR_FULL = 1;                  // ids 1..STAGES
constexpr int BAR_EMPTY = 1 + STAGES;        // ids 1+STAGES..2*STAGES
constexpr int BAR_PRODUCERS = 1 + 2 * STAGES;

struct Summit {
  float stat;       // max stat seen
  int len;          // longest interval among the max-stat rows
  int64_t pos_row;  // earliest of those: the summit position
  int64_t pq_row;   // earliest max-stat row: the summit p/q
  int pos_start;    // starts/ends of pos_row
  int pos_end;
  float p;          // pval/qval of pq_row
  float q;
};

__device__ __forceinline__ Summit no_summit() {
  return {-INFINITY, 0, INT64_MAX, INT64_MAX, 0, 0, 0.0f, 0.0f};
}

struct Row {
  float stat;
  float p;
  float q;
  int start;
  int end;
  bool sig;
};

// fold one significant row seen after every row already folded into a
__device__ __forceinline__ void see(Summit& a, const Row& x, int64_t row) {
  const int len = x.end - x.start;
  if (x.stat > a.stat) {
    a = {x.stat, len, row, row, x.start, x.end, x.p, x.q};
  } else if (x.stat == a.stat && len > a.len) {
    a.len = len;
    a.pos_row = row;
    a.pos_start = x.start;
    a.pos_end = x.end;
  }
}

// combine two summits of any rows (associative and commutative)
__device__ __forceinline__ void take(Summit& a, const Summit& b) {
  if (b.stat > a.stat) {
    a = b;
  } else if (b.stat == a.stat) {
    if (b.len > a.len || (b.len == a.len && b.pos_row < a.pos_row)) {
      a.len = b.len;
      a.pos_row = b.pos_row;
      a.pos_start = b.pos_start;
      a.pos_end = b.pos_end;
    }
    if (b.pq_row < a.pq_row) {
      a.pq_row = b.pq_row;
      a.p = b.p;
      a.q = b.q;
    }
  }
}

__device__ __forceinline__ Summit warp_take(Summit best) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    Summit o;
    o.stat = __shfl_xor_sync(FULL_MASK, best.stat, off);
    o.len = __shfl_xor_sync(FULL_MASK, best.len, off);
    o.pos_row = __shfl_xor_sync(FULL_MASK, best.pos_row, off);
    o.pq_row = __shfl_xor_sync(FULL_MASK, best.pq_row, off);
    o.pos_start = __shfl_xor_sync(FULL_MASK, best.pos_start, off);
    o.pos_end = __shfl_xor_sync(FULL_MASK, best.pos_end, off);
    o.p = __shfl_xor_sync(FULL_MASK, best.p, off);
    o.q = __shfl_xor_sync(FULL_MASK, best.q, off);
    take(best, o);
  }
  return best;
}

struct Rows {
  const int* starts;
  const int* ends;
  const float* stat;
  const float* pval;
  const float* qval;
  const uint8_t* sig;
  int64_t m;
  float min_pq;
};

struct Out {
  float* auc;
  float* max_stat;
  float* summit_pval;
  float* summit_qval;
  int* summit_pos;
  int* summit_len;
};

// the summit fields of candidate j (the AUC is written by its adder);
// start_lo is starts[lo]
__device__ __forceinline__ void write_summit(const Out& o, int64_t j,
                                             const Summit& best,
                                             int start_lo) {
  o.max_stat[j] = best.stat;
  o.summit_len[j] = best.len;
  if (best.pq_row != INT64_MAX) {
    o.summit_pval[j] = best.p;
    o.summit_qval[j] = best.q;
    o.summit_pos[j] = (int)(((int64_t)best.pos_start + best.pos_end) / 2
                            - start_lo);
  } else {
    o.summit_pval[j] = 0.0f;
    o.summit_qval[j] = 0.0f;
    o.summit_pos[j] = 0;
  }
}

__device__ __forceinline__ Row load_row(const Rows& r, int64_t i,
                                        int64_t hi) {
  Row x = {0.0f, 0.0f, 0.0f, 0, 0, false};
  if (i <= hi) {
    x.sig = r.sig[i] != 0;
    x.start = r.starts[i];
    x.end = r.ends[i];
    x.stat = r.stat[i];
    x.p = r.pval[i];
    x.q = r.qval[i];
  }
  return x;
}

// one warp: candidate j, rows lo..hi (at most LONG_ROWS)
__device__ __forceinline__ void short_peak(const Rows& r, const Out& o,
                                           int64_t j, int64_t lo,
                                           int64_t hi) {
  const int lane = threadIdx.x & 31;
  float a = 0.0f;
  Summit best = no_summit();
  Row cur = load_row(r, lo + lane, hi);
  const int start_lo = __shfl_sync(FULL_MASK, cur.start, 0);
  for (int64_t base = lo; base <= hi; base += 32) {
    // the next 32 rows are in flight during this step's add chain
    const Row nxt = load_row(r, base + 32 + lane, hi);
    float c = 0.0f;
    if (cur.sig) {
      c = (float)(cur.end - cur.start) * (cur.stat - r.min_pq);
      see(best, cur, base + lane);
    }
    // rows that are not significant add +0.0f, which leaves a as is
#pragma unroll
    for (int t = 0; t < 32; ++t) a = a + __shfl_sync(FULL_MASK, c, t);
    cur = nxt;
  }
  best = warp_take(best);
  if (lane == 0) {
    o.auc[j] = a;
    write_summit(o, j, best, start_lo);
  }
}

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(n) : "memory");
}

// this producer's contributions of the 4 rows from g (a multiple of 4),
// folding the significant ones into its summit
__device__ __forceinline__ float4 produce(const Rows& r, int64_t g,
                                          int64_t lo, int64_t hi,
                                          Summit& best) {
  if (g > hi) return make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  Row x[4];
  if (g + 3 < r.m) {
    const int4 a = *reinterpret_cast<const int4*>(r.starts + g);
    const int4 b = *reinterpret_cast<const int4*>(r.ends + g);
    const float4 v = *reinterpret_cast<const float4*>(r.stat + g);
    const float4 p = *reinterpret_cast<const float4*>(r.pval + g);
    const float4 q = *reinterpret_cast<const float4*>(r.qval + g);
    const uchar4 f = *reinterpret_cast<const uchar4*>(r.sig + g);
    x[0] = {v.x, p.x, q.x, a.x, b.x, f.x != 0};
    x[1] = {v.y, p.y, q.y, a.y, b.y, f.y != 0};
    x[2] = {v.z, p.z, q.z, a.z, b.z, f.z != 0};
    x[3] = {v.w, p.w, q.w, a.w, b.w, f.w != 0};
  } else {
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = load_row(r, g + u, r.m - 1);
  }
  float c[4];
#pragma unroll
  for (int u = 0; u < 4; ++u) {
    const int64_t row = g + u;
    c[u] = 0.0f;
    if (row >= lo && row <= hi && x[u].sig) {
      c[u] = (float)(x[u].end - x[u].start) * (x[u].stat - r.min_pq);
      see(best, x[u], row);
    }
  }
  return make_float4(c[0], c[1], c[2], c[3]);
}

// the whole block: candidate j, rows lo..hi (more than LONG_ROWS)
__device__ __forceinline__ void long_peak(const Rows& r, const Out& o,
                                          int64_t j, int64_t lo,
                                          int64_t hi,
                                          float (*ring)[CHUNK],
                                          Summit* warp_best) {
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int64_t base0 = lo & ~(int64_t)3;  // 16-byte aligned row groups
  const int64_t n_chunks = (hi + 1 - base0 + CHUNK - 1) / CHUNK;
  if (warp < PRODUCER_WARPS) {
    const int start_lo = tid == 0 ? r.starts[lo] : 0;
    Summit best = no_summit();
    for (int64_t t = 0; t < n_chunks; ++t) {
      const int s = (int)(t % STAGES);
      if (t >= STAGES) bar_sync(BAR_EMPTY + s, THREADS);
      reinterpret_cast<float4*>(ring[s])[tid] = produce(
          r, base0 + t * CHUNK + ROWS_PER_PRODUCER * tid, lo, hi, best);
      bar_arrive(BAR_FULL + s, THREADS);
    }
    best = warp_take(best);
    if (lane == 0) warp_best[warp] = best;
    bar_sync(BAR_PRODUCERS, PRODUCERS);
    if (tid == 0) {
      for (int w = 1; w < PRODUCER_WARPS; ++w) take(best, warp_best[w]);
      write_summit(o, j, best, start_lo);
    }
  } else {
    // the consumer warp: lane 0 adds; the whole warp takes part in the
    // barriers, which count threads by warps
    float a = 0.0f;
    for (int64_t t = 0; t < n_chunks; ++t) {
      const int s = (int)(t % STAGES);
      bar_sync(BAR_FULL + s, THREADS);
      if (lane == 0) {
        const float4* r4 = reinterpret_cast<const float4*>(ring[s]);
        float4 cur[BATCH];
#pragma unroll
        for (int u = 0; u < BATCH; ++u) cur[u] = r4[u];
        for (int i = BATCH; i <= CHUNK / 4; i += BATCH) {
          // the next batch's reads are issued before this batch's adds
          float4 nxt[BATCH];
#pragma unroll
          for (int u = 0; u < BATCH; ++u)
            nxt[u] = r4[i + u < CHUNK / 4 ? i + u : 0];
#pragma unroll
          for (int u = 0; u < BATCH; ++u) {
            a = a + cur[u].x;
            a = a + cur[u].y;
            a = a + cur[u].z;
            a = a + cur[u].w;
          }
#pragma unroll
          for (int u = 0; u < BATCH; ++u) cur[u] = nxt[u];
        }
      }
      __syncwarp();
      if (t + STAGES < n_chunks) bar_arrive(BAR_EMPTY + s, THREADS);
    }
    if (lane == 0) o.auc[j] = a;
  }
}

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
peak_reduce_kernel(Rows r, const int64_t* __restrict__ first,
                   const int64_t* __restrict__ last, int64_t k, Out o) {
  __shared__ __align__(16) float ring[STAGES][CHUNK];
  __shared__ Summit warp_best[PRODUCER_WARPS];
  __shared__ int64_t short_lo[THREADS];
  __shared__ int short_j[THREADS];
  __shared__ int short_n[THREADS];
  __shared__ int long_j[THREADS];
  __shared__ int n_short, n_long;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int64_t grid = gridDim.x;
  // rounds of THREADS of this block's candidates blockIdx.x + grid * i
  for (int64_t i0 = 0; blockIdx.x + grid * i0 < k; i0 += THREADS) {
    if (tid == 0) n_short = n_long = 0;
    __syncthreads();
    const int64_t j = blockIdx.x + grid * (i0 + tid);
    if (j < k) {
      const int64_t lo = first[j];
      const int64_t n = last[j] - lo + 1;
      if (n <= 0) {
        o.auc[j] = 0.0f;
        o.max_stat[j] = -INFINITY;
        o.summit_pval[j] = 0.0f;
        o.summit_qval[j] = 0.0f;
        o.summit_pos[j] = 0;
        o.summit_len[j] = 0;
      } else if (n > LONG_ROWS) {
        long_j[atomicAdd(&n_long, 1)] = (int)j;
      } else {
        const int e = atomicAdd(&n_short, 1);
        short_j[e] = (int)j;
        short_lo[e] = lo;
        short_n[e] = (int)n;
      }
    }
    __syncthreads();
    for (int e = 0; e < n_long; ++e) {
      const int64_t jl = long_j[e];
      long_peak(r, o, jl, first[jl], last[jl], ring, warp_best);
      __syncthreads();  // ring and warp_best are reused by the next peak
    }
    for (int e = warp; e < n_short; e += WARPS)
      short_peak(r, o, short_j[e], short_lo[e],
                 short_lo[e] + short_n[e] - 1);
    __syncthreads();  // the lists are refilled by the next round
  }
}

// Resident blocks of the current device, read once per device.
int grid_size() {
  static int cache[64];
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64)
    return 132;
  if (cache[dev] == 0) {
    if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)
            != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
               &per_sm, peak_reduce_kernel, THREADS, 0) != cudaSuccess
        || per_sm < 1)
      return 132;
    cache[dev] = sms * per_sm;
  }
  return cache[dev];
}

}  // namespace

extern "C" {

// Rows (length m) in genomic order: starts/ends int32, stat, pval, qval
// f32, sig uint8 (significant and live); starts, ends, stat, pval and
// qval 16-byte aligned, sig 4-byte aligned (the wrapper checks).
// Candidates: first and last int64 [k], the peak's first row and last
// significant row (last < first marks a candidate with no rows).
// Outputs [k]: auc, max_stat, summit_pval, summit_qval f32; summit_pos,
// summit_len int32.  Returns the launch's CUDA error.
int peak_reduce_launch(const int* starts, const int* ends,
                       const float* stat, const float* pval,
                       const float* qval, const uint8_t* sig,
                       const int64_t* first, const int64_t* last,
                       int64_t m, int64_t k, float min_pq, float* auc,
                       float* max_stat, float* summit_pval,
                       float* summit_qval, int* summit_pos,
                       int* summit_len, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  const Out o = {auc, max_stat, summit_pval, summit_qval, summit_pos,
                 summit_len};
  const Rows r = {starts, ends, stat, pval, qval, sig, m, min_pq};
  // a grid the card holds at once; each block loops over its candidates
  int64_t blocks = grid_size();
  if (blocks > k) blocks = k;
  peak_reduce_kernel<<<(unsigned)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(r, first, last, k, o);
  return (int)cudaGetLastError();
}

}  // extern "C"
