// peak_reduce_warp: the first design of kernel K4 (peaks.cu), kept as a
// reference that the card tests and chip_smoke.py hold the current
// design to, bit for bit, on all six outputs.  It is built into a
// library of its own (kernels.reference_library()) that the port never
// loads.
//
// One warp per candidate peak: each step the 32 lanes load 32
// consecutive rows and compute their contributions, then every lane
// adds the 32 contributions to its running AUC in row order (shuffles
// feed a chain of 32 dependent adds); each lane keeps the best summit
// among its rows and the warp combines them by the associative
// (max stat, max length, min row) and (max stat, min row) orders.
// Built, like peaks.cu, without FMA contraction.
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
peak_reduce_warp_kernel(const int* __restrict__ starts,
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
extern "C" int peak_reduce_warp_launch(const int* starts, const int* ends,
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
  peak_reduce_warp_kernel<<<(unsigned)blocks, THREADS, 0,
                       (cudaStream_t)stream>>>(
      starts, ends, stat, pval, qval, sig, first, last, k, min_pq, auc,
      max_stat, summit_pval, summit_qval, summit_pos, summit_len);
  return (int)cudaGetLastError();
}
