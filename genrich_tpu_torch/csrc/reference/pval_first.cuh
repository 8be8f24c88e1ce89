// pval_first.cuh: a frozen copy of csrc/pval.cuh as the first designs
// of kernels K1 and K2 (scan_three_pass.cu, stats_first.cu) were built
// against, so that holding the current kernels to them bit for bit
// still tests something when pval.cuh changes.
//
// -log10 p under the log-normal null, float32, for the device kernels.
//
// calcPval/plnorm/pnorm (Genrich.c:1490-1653, R-3.5.0 rational
// approximations) in the operation order of genrich_tpu/ops/pvalue_jax.py
// (its plain PyTorch twin is genrich_tpu_torch/ops/pvalue.py).  Every
// constant is written as a double and rounded to float, as
// jnp.asarray(c, float32) rounds it.  Only the selected branch of each
// piecewise formula is evaluated; the tensor versions evaluate all of
// them and select, which gives the same value.
//
// Shared by scan.cu (coverage_scan's lambda mode) and stats.cu
// (tile_stats).  Build without fast math and without FMA contraction
// (kernels.py's NVCC_FLAGS) to stay within float32 ulps of the CPU.
#pragma once

#include <cfloat>

#define GR_F(c) ((float)(c))

namespace genrich {

__device__ __forceinline__ float do_del(float y, float temp, bool ret) {
  float xsq = truncf(y * 16.0f) / 16.0f;
  float d = (y - xsq) * (y + xsq);
  if (ret) return log1pf(-expf((-xsq * xsq - d) / 2.0f) * temp);
  return (-xsq * xsq - d) / 2.0f + logf(temp);
}

// log of the standard-normal upper tail (pnorm port)
__device__ __forceinline__ float pnorm_upper_log(float x) {
  const float y = fabsf(x);
  if (y <= GR_F(0.67448975)) {
    const float xsq = x * x;
    float xnum = GR_F(0.065682337918207449113) * xsq;
    float xden = xsq;
    xnum = (xnum + GR_F(2.2352520354606839287)) * xsq;
    xden = (xden + GR_F(47.20258190468824187)) * xsq;
    xnum = (xnum + GR_F(161.02823106855587881)) * xsq;
    xden = (xden + GR_F(976.09855173777669322)) * xsq;
    xnum = (xnum + GR_F(1067.6894854603709582)) * xsq;
    xden = (xden + GR_F(10260.932208618978205)) * xsq;
    float t;
    if (y > FLT_EPSILON * 0.5f)
      t = x * (xnum + GR_F(18154.981253343561249))
          / (xden + GR_F(45507.789335026729956));
    else
      t = x * GR_F(18154.981253343561249 / 45507.789335026729956);
    return logf(0.5f - t);
  }
  if (y <= GR_F(5.656854249492381)) {  // sqrt(32)
    float xnum = GR_F(1.0765576773720192317e-8) * y;
    float xden = y;
    xnum = (xnum + GR_F(0.39894151208813466764)) * y;
    xden = (xden + GR_F(22.266688044328115691)) * y;
    xnum = (xnum + GR_F(8.8831497943883759412)) * y;
    xden = (xden + GR_F(235.38790178262499861)) * y;
    xnum = (xnum + GR_F(93.506656132177855979)) * y;
    xden = (xden + GR_F(1519.377599407554805)) * y;
    xnum = (xnum + GR_F(597.27027639480026226)) * y;
    xden = (xden + GR_F(6485.558298266760755)) * y;
    xnum = (xnum + GR_F(2494.5375852903726711)) * y;
    xden = (xden + GR_F(18615.571640885098091)) * y;
    xnum = (xnum + GR_F(6848.1904505362823326)) * y;
    xden = (xden + GR_F(34900.952721145977266)) * y;
    xnum = (xnum + GR_F(11602.651437647350124)) * y;
    xden = (xden + GR_F(38912.003286093271411)) * y;
    const float t = (xnum + GR_F(9842.7148383839780218))
                    / (xden + GR_F(19685.429676859990727));
    return do_del(y, t, x <= 0.0f);
  }
  if (y < FLT_MAX) {
    const float inv = 1.0f / fmaxf(x * x, GR_F(1e-30));
    float xnum = GR_F(0.02307344176494017303) * inv;
    float xden = inv;
    xnum = (xnum + GR_F(0.21589853405795699)) * inv;
    xden = (xden + GR_F(1.28426009614491121)) * inv;
    xnum = (xnum + GR_F(0.1274011611602473639)) * inv;
    xden = (xden + GR_F(0.468238212480865118)) * inv;
    xnum = (xnum + GR_F(0.022235277870649807)) * inv;
    xden = (xden + GR_F(0.0659881378689285515)) * inv;
    xnum = (xnum + GR_F(0.001421619193227893466)) * inv;
    xden = (xden + GR_F(0.00378239633202758244)) * inv;
    float t = inv * (xnum + GR_F(2.9112874951168792e-5))
              / (xden + GR_F(7.29751555083966205e-5));
    t = (GR_F(0.3989422804014327) - t) / fmaxf(y, GR_F(1e-30));
    return do_del(x, t, x <= 0.0f);
  }
  return -0.0f;
}

// calcPval: -log10 p of expt against the control/background mean ctrl;
// ctrl == SKIP (-1) gives SKIP.
__device__ __forceinline__ float calc_pval(float expt, float ctrl) {
  if (ctrl == -1.0f) return -1.0f;
  if (ctrl == 0.0f) return expt == 0.0f ? 0.0f : FLT_MAX;
  if (expt == 0.0f) return 0.0f;
  const float mu = fmaxf(ctrl, GR_F(1e-30));
  const float sd = 10.0f * log10f(mu);
  const float mu2 = mu * mu;
  const float sd2 = sd * sd;
  float meanlog, sdlog;
  if (ctrl > 7.0f) {
    meanlog = logf(mu2 / sqrtf(sd2 + mu2));
    sdlog = sqrtf(log1pf(sd2 / mu2));
  } else {
    meanlog = logf(mu) - GR_F(0.445999019652555);   // LOGSQRT
    sdlog = GR_F(0.944456478248262);                 // SQRTLOG
  }
  const float x = (logf(fmaxf(expt, GR_F(1e-30))) - meanlog) / sdlog;
  const float p = -pnorm_upper_log(x)
                  / GR_F(2.302585092994045684017991454684364208);
  return fminf(p, FLT_MAX);
}

}  // namespace genrich
