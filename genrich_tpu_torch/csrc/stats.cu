// tile_stats: per-interval -log10 p from expt/ctrl coverage.
//
// Replaces the elementwise XLA program of
// genrich_tpu/ops/pipeline_jax.py::tile_stats (:164-173), which calls
// ops/pvalue_jax.py::calc_pval:
//   ctrl = excluded ? SKIP : max(factor * ctrl_raw, lambda)
//   pval = calc_pval(excluded ? 0 : expt, ctrl)
// (savePileupCtrl/savePval semantics, Genrich.c:2052-2161, 1720-1794).
//
// Bound: device-memory bandwidth (9 B read and 4 B written per row); a
// row that needs the logarithms runs about 140-170 float32 operations
// (libm calls counted at their SASS length), under the bytes at the
// card's float32 peak on the main path.  Yet the first design
// (csrc/reference/stats_first.cu, one row per thread) took nearly three
// times the byte bound there: the chains are long and dependent, and a
// warp runs every branch any of its rows takes.  But the arithmetic has few distinct inputs:
// coverage is a count (K1 scans integer deltas), so expt and ctrl_raw
// are integral floats, on the main path's calls all below 8,192, and
// every one against the same control mean lambda (no -c).  So a call
// runs two launches:
//   * tile_stats_table_kernel evaluates, for each integral value
//     k < TABLE, the -log10 p of signal k against lambda and the
//     log-normal parameters of the control mean max(factor * k, lambda);
//   * tile_stats_kernel walks the rows with a persistent grid (the SM
//     count times the blocks the kernel fits per SM), each thread loading
//     its next row before it works on the current one; a row whose
//     signal (at lambda) or raw control (elsewhere) is an integral value
//     below TABLE reads its table entry through the read-only cache, and
//     only the others run the arithmetic in full (lambda's parameters
//     are computed once per thread).
// Every table entry comes from the same device code and the same float
// inputs as the row that reads it, so the output equals the first
// design's bit for bit.  On an H100 80GB HBM3 (700 W) a main-path call
// of 2.5M rows takes about 16 us against the first design's 27 (the
// byte bound is 9.8).  Rows beyond the tables cost more than in the
// first design (13% on 2^23 rows of coverage into the millions: its
// grid of 132 x 64 blocks balances long rows better than a persistent
// one, and the table launch adds its own time).  Tried
// on the card and dropped, each slower on the main path's calls:
// 128-row warp tiles with 16-byte loads and a shared-memory queue of
// the rows that need logarithms, sorted or not by pnorm's branch;
// pnorm's three branches as one straight-line recurrence; a per-block
// cache of computed p-values in shared memory (filled as rows arrive,
// it missed most rows at lambda), and a global one filled by atomics
// (its hot entries serialised in L2).  Launching the row kernel as a
// programmatic dependent of the table kernel saved 1-3% and is not
// used.
#include <cuda_runtime.h>
#include <stdint.h>

#include "pval.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int TABLE = 8192;  // integral values 0 .. TABLE - 1 have entries

struct Tables {
  float p_lam[TABLE];    // -log10 p of signal k against lambda (k >= 1)
  float2 params[TABLE];  // (meanlog, sdlog) of max(factor * k, lambda)
};

__device__ __forceinline__ bool lambda_has_params(float lam) {
  return lam != -1.0f && lam != 0.0f;
}

// k, if v is an integral value with a table entry (k >= 1), else 0
__device__ __forceinline__ int table_index(float v) {
  return (v >= 1.0f && v < (float)TABLE && truncf(v) == v) ? (int)v : 0;
}

__global__ void __launch_bounds__(THREADS)
tile_stats_table_kernel(float factor, float lam, Tables* __restrict__ t) {
  // threads [0, TABLE) fill params, [TABLE, 2 TABLE) p_lam: two short
  // chains where one thread per value would run both one after another
  const int g = blockIdx.x * THREADS + threadIdx.x;
  const bool want_p = g >= TABLE;
  const int k = want_p ? g - TABLE : g;
  if (k < 1 || k >= TABLE) return;
  const float v = (float)k;
  // entries that calc_pval reaches: a control mean other than SKIP, 0
  // and lambda; a signal against lambda when lambda is such a mean
  const float ctrl = fmaxf(factor * v, lam);
  if (!want_p && ctrl != -1.0f && ctrl != 0.0f && ctrl != lam) {
    float meanlog, sdlog;
    genrich::lognormal_params(ctrl, meanlog, sdlog);
    t->params[k] = make_float2(meanlog, sdlog);
  }
  if (want_p && lambda_has_params(lam)) {
    float meanlog, sdlog;
    genrich::lognormal_params(lam, meanlog, sdlog);
    t->p_lam[k] = genrich::pval_lognormal(v, meanlog, sdlog);
  }
}

__global__ void __launch_bounds__(THREADS)
tile_stats_kernel(const float* __restrict__ expt,
                  const float* __restrict__ ctrl_raw,
                  const uint8_t* __restrict__ excluded, float factor,
                  float lam, const Tables* __restrict__ t,
                  float* __restrict__ pval, int64_t m) {
  // lambda's log-normal parameters for a signal beyond the table
  float lam_meanlog = 0.0f, lam_sdlog = 1.0f;
  if (lambda_has_params(lam))
    genrich::lognormal_params(lam, lam_meanlog, lam_sdlog);

  const int64_t step = (int64_t)gridDim.x * THREADS;
  int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  float ev = 0.0f, cr = 0.0f;
  uint8_t ex = 1;
  if (i < m) {
    ev = expt[i];
    cr = ctrl_raw[i];
    ex = excluded[i];
  }
  for (; i < m; i += step) {
    const float e0 = ev, c0 = cr;
    const bool x0 = ex != 0;
    const int64_t j = i + step;  // the next row's loads go out now
    if (j < m) {
      ev = expt[j];
      cr = ctrl_raw[j];
      ex = excluded[j];
    }
    // calc_pval, its inner results read from the tables where they hold
    // them
    const float ctrl = x0 ? -1.0f : fmaxf(factor * c0, lam);
    const float e = x0 ? 0.0f : e0;
    float p;
    if (ctrl == -1.0f) {
      p = -1.0f;
    } else if (ctrl == 0.0f) {
      p = e == 0.0f ? 0.0f : FLT_MAX;
    } else if (e == 0.0f) {
      p = 0.0f;
    } else if (ctrl == lam) {
      const int k = table_index(e);
      p = k ? __ldg(&t->p_lam[k])
            : genrich::pval_lognormal(e, lam_meanlog, lam_sdlog);
    } else {
      float meanlog, sdlog;
      const int k = table_index(c0);
      if (k) {
        const float2 q = __ldg(&t->params[k]);
        meanlog = q.x;
        sdlog = q.y;
      } else {
        genrich::lognormal_params(ctrl, meanlog, sdlog);
      }
      p = genrich::pval_lognormal(e, meanlog, sdlog);
    }
    pval[i] = p;
  }
}

}  // namespace

// Bytes of device scratch a call needs for its tables.
extern "C" int64_t tile_stats_scratch_bytes() {
  return (int64_t)sizeof(Tables);
}

extern "C" int tile_stats_launch(const float* expt, const float* ctrl_raw,
                                 const uint8_t* excluded, float factor,
                                 float lam, float* pval, int64_t m,
                                 void* scratch, void* stream) {
  if (m <= 0) return (int)cudaSuccess;
  // resident blocks of the current device, read once per device
  static int grid_caps[64];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (grid_caps[dev] == 0) {
    int sms = 0, per_sm = 0;
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &per_sm, tile_stats_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    grid_caps[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  Tables* t = static_cast<Tables*>(scratch);
  const cudaStream_t s = (cudaStream_t)stream;
  tile_stats_table_kernel<<<2 * TABLE / THREADS, THREADS, 0, s>>>(factor,
                                                                  lam, t);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  int64_t blocks = (m + THREADS - 1) / THREADS;
  if (blocks > grid_caps[dev]) blocks = grid_caps[dev];
  tile_stats_kernel<<<(unsigned)blocks, THREADS, 0, s>>>(
      expt, ctrl_raw, excluded, factor, lam, t, pval, m);
  return (int)cudaGetLastError();
}
