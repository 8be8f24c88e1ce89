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
// Bound: float64 arithmetic and the divergent trip counts of the series
// loops (each lane stops at its own convergence point, as the
// reference's loops do), not memory: R * 4 B in and 4 B out per lane.
// One thread per interval, grid-stride, coalesced loads of each
// replicate row; the stirlerr table sits in __constant__ memory.  Build
// without FMA contraction (kernels.py) so each operation rounds as the
// exact engine's numpy does.
#include <cfloat>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
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

__global__ void __launch_bounds__(THREADS)
fisher_combine_kernel(const float* __restrict__ pv, int r, int64_t n,
                      float* __restrict__ out) {
  const int64_t stride = (int64_t)gridDim.x * THREADS;
  for (int64_t i = (int64_t)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    double total = 0.0;
    int live = 0;
    for (int k = 0; k < r; ++k) {
      const float v = pv[(int64_t)k * n + i];
      if (v != -1.0f) {
        total = total + (double)v;
        ++live;
      }
    }
    float res;
    if (live == 0) {
      res = -1.0f;
    } else if (live == 1 || total == 0.0) {
      res = (float)total;
    } else {
      const double x = 2.0 * total / LOG10E;
      const double p = -pgamma(x / 2.0, (2.0 * live) / 2.0) / LN10;
      res = p > (double)FLT_MAX ? FLT_MAX : (float)p;
    }
    out[i] = res;
  }
}

}  // namespace

// pv: f32 [r, n] row-major (replicate rows, aligned intervals); out: f32
// [n].  r is at most 200 (pgamma's alph = r is in [2, 200]).
extern "C" int fisher_combine_launch(const float* pv, int r, int64_t n,
                                     float* out, void* stream) {
  if (n <= 0) return (int)cudaSuccess;
  if (r < 1 || r > 200) return (int)cudaErrorInvalidValue;
  int64_t blocks = (n + THREADS - 1) / THREADS;
  if (blocks > 132 * 64) blocks = 132 * 64;  // grid-stride beyond this
  fisher_combine_kernel<<<(unsigned)blocks, THREADS, 0,
                          (cudaStream_t)stream>>>(pv, r, n, out);
  return (int)cudaGetLastError();
}
