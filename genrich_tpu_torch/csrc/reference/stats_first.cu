// tile_stats_first: the first design of kernel K2 (stats.cu), kept as a
// reference that the card tests and chip_smoke.py hold the current
// design to, bit for bit, and time beside it.  It is built into a
// library of its own (kernels.reference_library()) that the port never
// loads, and includes pval_first.cuh, a frozen copy of the p-value code
// it was written against.
//
// Replaces the elementwise XLA program of
// genrich_tpu/ops/pipeline_jax.py::tile_stats (:164-173), which calls
// ops/pvalue_jax.py::calc_pval:
//   ctrl = excluded ? SKIP : max(factor * ctrl_raw, lambda)
//   pval = calc_pval(excluded ? 0 : expt, ctrl)
// (savePileupCtrl/savePval semantics, Genrich.c:2052-2161, 1720-1794).
//
// Bound: device-memory bandwidth (9 B read and 4 B written per row)
// against a few dozen float32 operations and five transcendentals per
// row.  One thread per row, grid-stride loop, coalesced loads and
// stores; the transcendentals hide under the memory traffic.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pval_first.cuh"

namespace {

constexpr int THREADS = 256;

__global__ void __launch_bounds__(THREADS)
tile_stats_kernel(const float* __restrict__ expt,
                  const float* __restrict__ ctrl_raw,
                  const uint8_t* __restrict__ excluded, float factor,
                  float lam, float* __restrict__ pval, int64_t m) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < m;
       i += stride) {
    const bool ex = excluded[i] != 0;
    const float ctrl = ex ? -1.0f : fmaxf(factor * ctrl_raw[i], lam);
    pval[i] = genrich::calc_pval(ex ? 0.0f : expt[i], ctrl);
  }
}

}  // namespace

extern "C" int tile_stats_first_launch(const float* expt,
                                       const float* ctrl_raw,
                                       const uint8_t* excluded,
                                       float factor, float lam, float* pval,
                                       int64_t m, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  int64_t blocks = (m + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  tile_stats_kernel<<<(unsigned)blocks, THREADS, 0,
                      (cudaStream_t)stream>>>(expt, ctrl_raw, excluded,
                                              factor, lam, pval, m);
  return (int)cudaGetLastError();
}
