// fisher_combine: aligned replicate -log10 p rows -> combined -log10 p.
//
// Replaces the XLA program of genrich_tpu/ops/chisq_jax.py::fisher_combine
// (:174-188) and the pgamma family it runs (:36-171), i.e. Fisher's
// method as multPval/combinePval compute it (Genrich.c:567-667):
//   total = sum of the live (non-SKIP) replicate values, df = 2 * live
//   df == 0 -> SKIP; df == 2 -> total; total == 0 -> 0;
//   else -log10 of the chi-squared upper tail of 2 * total * ln(10).
// The R-3.5.0 series (bd0, stirlerr, dpois, pd_upper_series,
// pd_lower_series, pgamma_smallx, pgamma; Genrich.c:403-559) run in
// double, in the operation order of genrich_tpu/engine/chisq.py (the
// exact engine), and the result rounds to float once, clamped to
// FLT_MAX.  The JAX package runs them in float32 only because the TPU
// has no float64 units; the H100 has them.
//
// Bound: float64 operations (a lane with a chi-squared tail runs about
// 290, libm calls counted at their SASS length), above the R * 4 B in
// and 4 B out per lane.  The first design (csrc/reference/
// fisher_first.cu: one lane per thread) ran at about a quarter of that
// bound.  A warp runs pgamma for all 32 of its lanes if one of them
// needs it, and on the Fisher path about 40% of the lanes (one live
// value, or a zero total) need none.  This design:
//   * persistent warps (the grid is sized from the SM count and the
//     occupancy the kernel reaches) walk the lanes 32 at a time, with
//     the next 32 lanes' values (2 replicates in registers, the rest
//     loaded in turn) loaded before the current ones are combined;
//   * a lane that needs the chi-squared tail goes to a per-warp queue
//     in shared memory (its total, live count and index; ballot and
//     popc), the others are written at once; once 32 are queued the
//     warp runs pgamma on them together, so no lane idles through the
//     series beside one that needed none.
// The queue's own work is not free, so it pays where many lanes need
// no tail (the Fisher path's two replicates) and not where nearly all
// do (three replicates of random values).  Tried on the card and
// dropped: 128 lanes per warp sorted by pgamma path into shared-memory
// lists, with lgamma and stirlerr once per live count per block
// (registers and the block's barriers cost more than the sorting
// saved); a global table of computed results keyed by the lane's total
// (lookups and inserts in device memory cost more than the series);
// three blocks per SM (40 registers, which spill); the lanes' loads two
// steps ahead in place of one (no faster).  Each lane's operations and
// their order are the first design's (the device functions below are
// its own): the output equals it bit for bit.  The stirlerr table sits
// in __constant__ memory.  Build without FMA contraction (kernels.py)
// so each operation rounds as the exact engine's numpy does.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr double LN2 = 0.693147180559945309417232121458176568;
constexpr double LN10 = 2.302585092994045684017991454684364208;
constexpr double LOG10E = 0.434294481903251827651128918916605082;
constexpr double PI = 3.141592653589793;
constexpr double STIRL0 = 1.0 / 12.0, STIRL1 = 1.0 / 360.0,
                 STIRL2 = 1.0 / 1260.0, STIRL3 = 1.0 / 1680.0,
                 STIRL4 = 1.0 / 1188.0;

__constant__ double SFERR[16] = {
    0.0, 0.0810614667953272582196702, 0.0413406959554092940938221,
    0.02767792568499833914878929, 0.02079067210376509311152277,
    0.01664469118982119216319487, 0.01387612882307074799874573,
    0.01189670994589177009505572, 0.010411265261972096497478567,
    0.009255462182712732917728637, 0.008330563433362871256469318,
    0.007573675487951840794972024, 0.006942840107209529865664152,
    0.006408994188004207068439631, 0.005951370112758847735624416,
    0.005554733551962801371038690};

// R_Log1_Exp: log(1 - exp(x)) for x <= 0
__device__ double log1_exp(double x) {
  return x > -LN2 ? log(-expm1(x)) : log1p(-exp(x));
}

// bd0 (Genrich.c:412-430): a series that does not converge in 1000
// terms falls through to the direct formula
__device__ double bd0(double x, double np) {
  if (fabs(x - np) < 0.1 * (x + np)) {
    double v = (x - np) / (x + np);
    double s = (x - np) * v;
    if (fabs(s) < DBL_MIN) return s;
    double ej = 2 * x * v;
    const double v2 = v * v;
    for (int j = 1; j < 1000; ++j) {
      ej = ej * v2;
      const double s1 = s + ej / (2 * j + 1);
      if (s1 == s) return s1;
      s = s1;
    }
  }
  return x * log(x / np) + np - x;
}

// stirlerr (Genrich.c:436-469); n integral in [1, 199]
__device__ double stirlerr(double n) {
  const double nn = n * n;
  if (n > 80.0) return (STIRL0 - (STIRL1 - STIRL2 / nn) / nn) / n;
  if (n > 35.0)
    return (STIRL0 - (STIRL1 - (STIRL2 - STIRL3 / nn) / nn) / nn) / n;
  if (n > 15.0)
    return (STIRL0
            - (STIRL1 - (STIRL2 - (STIRL3 - STIRL4 / nn) / nn) / nn) / nn)
           / n;
  int i = (int)n;
  i = i < 0 ? 0 : (i > 15 ? 15 : i);
  return SFERR[i];
}

// dpois (Genrich.c:474-477)
__device__ double dpois(double x, double lam) {
  return -0.5 * log(2.0 * PI * x) - stirlerr(x) - bd0(x, lam);
}

// pd_upper_series (Genrich.c:482-491)
__device__ double pd_upper_series(double x, double a) {
  double term = x / a;
  double total = term;
  do {
    a = a + 1;
    term = term * x / a;
    total = total + term;
  } while (term > total * DBL_EPSILON);
  return log(total);
}

// pd_lower_series (Genrich.c:496-504)
__device__ double pd_lower_series(double lam, double y) {
  double term = 1.0, total = 0.0;
  if (y >= 1) {
    do {
      term = term * y / lam;
      total = total + term;
      y = y - 1;
    } while (y >= 1 && term > total * DBL_EPSILON);
  }
  return log1p(total);
}

// pgamma_smallx (Genrich.c:509-522)
__device__ double pgamma_smallx(double x, double alph) {
  double n = 0.0, c = alph, total = 0.0, term;
  do {
    n = n + 1;
    c = c * -x / n;
    term = c / (alph + n);
    total = total + term;
  } while (fabs(term) > DBL_EPSILON * fabs(total));
  const double lf2 = alph * log(x) - lgamma(alph + 1);
  return log1_exp(log1p(total) + lf2);
}

// pgamma (Genrich.c:528-545): log upper tail; alph integral in [2, 200]
__device__ double pgamma(double x, double alph) {
  if (x < 1) return pgamma_smallx(x, alph);
  const double d = dpois(alph - 1, x);
  if (x <= alph - 1) return log1_exp(pd_upper_series(x, alph) + d);
  return pd_lower_series(x, alph - 1) + d;
}

constexpr int WARPS = THREADS / 32;
constexpr int QCAP = 64;                    // queue entries per warp
constexpr int REG_R = 2;                    // replicates prefetched
constexpr int MAX_R = 200;
constexpr unsigned FULL_MASK = 0xffffffffu;

struct Queue {
  double total[WARPS][QCAP];
  int64_t idx[WARPS][QCAP];
  uint8_t live[WARPS][QCAP];
};

// the queue's first k entries (k <= 32), one a lane
__device__ __forceinline__ void run_queue(Queue& q, int w, int lane, int qh,
                                          int k, float* __restrict__ out) {
  __syncwarp();
  if (lane < k) {
    const int s = (qh + lane) & (QCAP - 1);
    const double total = q.total[w][s];
    const int live = q.live[w][s];
    const double x = 2.0 * total / LOG10E;
    const double p = -pgamma(x / 2.0, (2.0 * live) / 2.0) / LN10;
    out[q.idx[w][s]] = p > (double)FLT_MAX ? FLT_MAX : (float)p;
  }
  __syncwarp();  // the entries may be queued over now
}

__global__ void __launch_bounds__(THREADS)
fisher_combine_kernel(const float* __restrict__ pv, int r, int64_t n,
                      float* __restrict__ out) {
  __shared__ Queue q;
  const int lane = threadIdx.x & 31;
  const int w = threadIdx.x >> 5;
  const unsigned lt_mask = (1u << lane) - 1u;
  const int64_t step = (int64_t)gridDim.x * THREADS;
  int64_t base = ((int64_t)blockIdx.x * WARPS + w) * 32;
  int qh = 0, qn = 0;  // the warp's queue: first entry, entries
  float v[REG_R];
#pragma unroll
  for (int k = 0; k < REG_R; ++k)
    if (k < r && base + lane < n) v[k] = pv[(int64_t)k * n + base + lane];
  for (; base < n; base += step) {
    const int64_t i = base + lane;
    const bool in = i < n;
    double total = 0.0;
    int live = 0;
#pragma unroll
    for (int k = 0; k < REG_R; ++k) {
      if (in && k < r && v[k] != -1.0f) {
        total = total + (double)v[k];
        ++live;
      }
    }
    for (int k = REG_R; k < r; ++k) {
      const float vk = in ? pv[(int64_t)k * n + i] : -1.0f;
      if (vk != -1.0f) {
        total = total + (double)vk;
        ++live;
      }
    }
    const int64_t j = i + step;  // the next lanes' loads go out now
#pragma unroll
    for (int k = 0; k < REG_R; ++k)
      if (k < r && j < n) v[k] = pv[(int64_t)k * n + j];
    const bool tail = in && live >= 2 && total != 0.0;
    if (in && !tail) out[i] = live == 0 ? -1.0f : (float)total;
    const unsigned b = __ballot_sync(FULL_MASK, tail);
    if (tail) {
      const int s = (qh + qn + __popc(b & lt_mask)) & (QCAP - 1);
      q.total[w][s] = total;
      q.live[w][s] = (uint8_t)live;
      q.idx[w][s] = i;
    }
    qn += __popc(b);
    if (qn >= 32) {
      run_queue(q, w, lane, qh, 32, out);
      qh = (qh + 32) & (QCAP - 1);
      qn -= 32;
    }
  }
  if (qn > 0) run_queue(q, w, lane, qh, qn, out);
}

}  // namespace

// pv: f32 [r, n] row-major (replicate rows, aligned intervals); out: f32
// [n].  r is at most 200 (pgamma's alph = r is in [2, 200]).
extern "C" int fisher_combine_launch(const float* pv, int r, int64_t n,
                                     float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (r < 1 || r > MAX_R) return (int)cudaErrorInvalidValue;
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
          &per_sm, fisher_combine_kernel, THREADS, 0);
    if (err != cudaSuccess) return (int)err;
    grid_caps[dev] = sms * (per_sm > 0 ? per_sm : 1);
  }
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > grid_caps[dev]) blocks = grid_caps[dev];
  fisher_combine_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(pv, r, n, out);
  return (int)cudaGetLastError();
}
