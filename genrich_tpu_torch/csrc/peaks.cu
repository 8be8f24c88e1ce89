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
//         run: a float prefix sum on the card associates differently
//         from run to run);
//   summit position: max stat, then the longest interval, then the
//         earliest row; its midpoint is taken in 64 bits;
//   summit p and q: the first max-stat row.
//
// Bound: the latency of walking a peak's rows.  On the main path a peak
// spans up to thousands of rows and a chromosome has about a hundred
// peaks, so one thread per peak leaves the card idle behind a chain of
// dependent loads.  One warp per candidate peak instead: each step the
// 32 lanes load 32 consecutive rows (coalesced) and compute their
// contributions, then every lane adds the 32 contributions to its
// running AUC in row order (shuffles feed a chain of 32 dependent adds),
// which keeps the exact engine's order bit for bit.  Each lane keeps the
// best summit among the rows it saw; the warp combines them by the
// (max stat, max length, min row) and (max stat, min row) orders, which
// are associative, so the result does not depend on the lane order.
// Built without FMA contraction (kernels.py), so each product rounds
// before it is added, as in the exact engine.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 128;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

struct Summit {
  float stat;       // max stat seen
  int len;          // longest interval among the max-stat rows
  int64_t pos_row;  // earliest of those: the summit position
  int64_t pq_row;   // earliest max-stat row: the summit p/q
};

__device__ __forceinline__ void take(Summit& a, float s, int len,
                                     int64_t pos_row, int64_t pq_row) {
  if (s > a.stat) {
    a = {s, len, pos_row, pq_row};
  } else if (s == a.stat) {
    if (len > a.len || (len == a.len && pos_row < a.pos_row)) {
      a.len = len;
      a.pos_row = pos_row;
    }
    if (pq_row < a.pq_row) a.pq_row = pq_row;
  }
}

__global__ void __launch_bounds__(THREADS)
peak_reduce_kernel(const int* __restrict__ starts,
                   const int* __restrict__ ends,
                   const float* __restrict__ stat,
                   const float* __restrict__ pval,
                   const float* __restrict__ qval,
                   const uint8_t* __restrict__ sig,
                   const int64_t* __restrict__ first,
                   const int64_t* __restrict__ last, int64_t k,
                   float min_pq, float* __restrict__ auc,
                   float* __restrict__ max_stat,
                   float* __restrict__ summit_pval,
                   float* __restrict__ summit_qval,
                   int* __restrict__ summit_pos,
                   int* __restrict__ summit_len) {
  const int lane = threadIdx.x & 31;
  const int64_t nwarps = (int64_t)gridDim.x * WARPS;
  for (int64_t j = (int64_t)blockIdx.x * WARPS + (threadIdx.x >> 5); j < k;
       j += nwarps) {
    const int64_t lo = first[j];
    const int64_t hi = last[j];
    float a = 0.0f;
    Summit best = {-INFINITY, 0, INT64_MAX, INT64_MAX};
    for (int64_t base = lo; base <= hi; base += 32) {
      const int64_t i = base + lane;
      float c = 0.0f;
      if (i <= hi && sig[i]) {
        const int len = ends[i] - starts[i];
        const float s = stat[i];
        c = (float)len * (s - min_pq);
        if (s > best.stat) {
          best = {s, len, i, i};
        } else if (s == best.stat && len > best.len) {
          best.len = len;
          best.pos_row = i;
        }
      }
      // rows that are not significant add +0.0f, which leaves a as is
#pragma unroll
      for (int t = 0; t < 32; ++t) a = a + __shfl_sync(FULL, c, t);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float s = __shfl_xor_sync(FULL, best.stat, off);
      const int len = __shfl_xor_sync(FULL, best.len, off);
      const int64_t pos_row = __shfl_xor_sync(FULL, best.pos_row, off);
      const int64_t pq_row = __shfl_xor_sync(FULL, best.pq_row, off);
      take(best, s, len, pos_row, pq_row);
    }
    if (lane == 0) {
      auc[j] = a;
      max_stat[j] = best.stat;
      summit_len[j] = best.len;
      if (best.pq_row != INT64_MAX) {
        summit_pval[j] = pval[best.pq_row];
        summit_qval[j] = qval[best.pq_row];
        summit_pos[j] = (int)(((int64_t)starts[best.pos_row]
                               + ends[best.pos_row]) / 2 - starts[lo]);
      } else {
        summit_pval[j] = 0.0f;
        summit_qval[j] = 0.0f;
        summit_pos[j] = 0;
      }
    }
  }
}

}  // namespace

// Rows (length m, implicit) in genomic order: starts/ends int32, stat,
// pval, qval f32, sig uint8 (significant and live).  Candidates: first
// and last int64 [k], the peak's first row and last significant row
// (last < first marks a candidate with no rows).  Outputs [k]: auc,
// max_stat, summit_pval, summit_qval f32; summit_pos, summit_len int32.
extern "C" int peak_reduce_launch(const int* starts, const int* ends,
                                  const float* stat, const float* pval,
                                  const float* qval, const uint8_t* sig,
                                  const int64_t* first, const int64_t* last,
                                  int64_t k, float min_pq, float* auc,
                                  float* max_stat, float* summit_pval,
                                  float* summit_qval, int* summit_pos,
                                  int* summit_len, void* stream) {
  if (k <= 0) return (int)cudaSuccess;
  int64_t blocks = (k + WARPS - 1) / WARPS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  peak_reduce_kernel<<<(unsigned)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(
      starts, ends, stat, pval, qval, sig, first, last, k, min_pq, auc,
      max_stat, summit_pval, summit_qval, summit_pos, summit_len);
  return (int)cudaGetLastError();
}
