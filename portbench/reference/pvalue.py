"""-log10 p under Genrich's log-normal null, in plain PyTorch float64.

Genrich (v0.6.2, calcPval with R's pnorm) scores an interval whose
treatment pileup is ``expt`` against a control value ``ctrl``: the
control is the mean ``mu`` of a log-normal whose standard deviation is
``10 * log10(mu)`` when ``mu > 7`` and ``1.2 * mu`` otherwise, and the
score is -log10 of its upper tail at ``expt``.  The tail is R 3.5.0's
``pnorm`` in log space (Cody's rational approximations), evaluated here
elementwise in float64 and stored as float32, as Genrich stores it.
Edge cases: ``expt == 0`` scores 0; ``ctrl == 0`` scores FLT_MAX
unless ``expt`` is 0; ``ctrl == SKIP`` (an excluded interval) stays
SKIP.
"""

from __future__ import annotations

import math

import torch

F64 = torch.float64
FLT_MAX = 3.4028234663852886e38
SKIP = -1.0
LOGSQRT = 0.445999019652555      # log(sqrt(2.44)): sd = 1.2 * mu
SQRTLOG = 0.944456478248262      # sqrt(log(2.44))

_A = (2.2352520354606839287, 161.02823106855587881, 1067.6894854603709582,
      18154.981253343561249, 0.065682337918207449113)
_B = (47.20258190468824187, 976.09855173777669322, 10260.932208618978205,
      45507.789335026729956)
_C = (0.39894151208813466764, 8.8831497943883759412, 93.506656132177855979,
      597.27027639480026226, 2494.5375852903726711, 6848.1904505362823326,
      11602.651437647350124, 9842.7148383839780218,
      1.0765576773720192317e-8)
_D = (22.266688044328115691, 235.38790178262499861, 1519.377599407554805,
      6485.558298266760755, 18615.571640885098091, 34900.952721145977266,
      38912.003286093271411, 19685.429676859990727)
_P = (0.21589853405795699, 0.1274011611602473639, 0.022235277870649807,
      0.001421619193227893466, 2.9112874951168792e-5,
      0.02307344176494017303)
_Q = (1.28426009614491121, 0.468238212480865118, 0.0659881378689285515,
      0.00378239633202758244, 7.29751555083966205e-5)
_SQRT32 = math.sqrt(32.0)
_INV_SQRT_2PI = 1.0 / math.sqrt(2.0 * math.pi)
_EPS = 2.220446049250313e-16
_LN10 = math.log(10.0)


def _do_del(y, temp, lower):
    xsq = torch.trunc(y * 16) / 16
    d = (y - xsq) * (y + xsq)
    expo = (-xsq * xsq - d) / 2.0
    return torch.where(lower, torch.log1p(-torch.exp(expo) * temp),
                       expo + torch.log(temp))


def pnorm_upper_log(x):
    """log P(Z > x) for a standard normal Z, float64, elementwise."""
    y = torch.abs(x)
    out = torch.full_like(x, -0.0)
    # |x| <= 0.674...
    xsq = x * x
    num = _A[4] * xsq
    den = xsq.clone()
    for i in range(3):
        num = (num + _A[i]) * xsq
        den = (den + _B[i]) * xsq
    t = torch.where(y > _EPS * 0.5, x * (num + _A[3]) / (den + _B[3]),
                    x * _A[3] / _B[3])
    m1 = y <= 0.67448975
    out = torch.where(m1, torch.log(0.5 - t), out)
    # 0.674... < |x| <= sqrt(32)
    num = _C[8] * y
    den = y.clone()
    for i in range(7):
        num = (num + _C[i]) * y
        den = (den + _D[i]) * y
    t = (num + _C[7]) / (den + _D[7])
    m2 = ~m1 & (y <= _SQRT32)
    out = torch.where(m2, _do_del(y, t, x <= 0.0), out)
    # sqrt(32) < |x| < 1e170
    m3 = ~m1 & ~m2 & (y < 1e170)
    xsq = torch.where(m3, 1.0 / (x * x), torch.ones_like(x))
    num = _P[5] * xsq
    den = xsq.clone()
    for i in range(4):
        num = (num + _P[i]) * xsq
        den = (den + _Q[i]) * xsq
    t = xsq * (num + _P[4]) / (den + _Q[4])
    t = (_INV_SQRT_2PI - t) / y
    return torch.where(m3, _do_del(x, t, x <= 0.0), out)


def calc_pval(expt, ctrl):
    """-log10 p of float32 ``expt`` against float32 ``ctrl`` (float64
    math, float32 result; SKIP where ``ctrl`` is SKIP)."""
    mu = ctrl.to(F64)
    safe = torch.where(mu > 0, mu, torch.ones_like(mu))
    big = mu > 7.0
    sd = 10.0 * torch.log10(safe)
    mu2, sd2 = safe * safe, sd * sd
    meanlog = torch.where(big, torch.log(mu2 / torch.sqrt(sd2 + mu2)),
                          torch.log(safe) - LOGSQRT)
    sdlog = torch.where(big, torch.sqrt(torch.log1p(sd2 / mu2)),
                        torch.full_like(mu, SQRTLOG))
    e = expt.to(F64)
    z = (torch.log(torch.where(e > 0, e, torch.ones_like(e))) - meanlog) \
        / sdlog
    p = -pnorm_upper_log(z) / _LN10
    res = torch.where(p > FLT_MAX, torch.full_like(p, FLT_MAX), p) \
        .to(torch.float32)
    zero = torch.zeros_like(res)
    res = torch.where(expt == 0.0, zero, res)
    res = torch.where(ctrl == 0.0, torch.where(expt == 0.0, zero,
                                               torch.full_like(res, FLT_MAX)),
                      res)
    return torch.where(ctrl == SKIP, torch.full_like(res, SKIP), res)


def calc_pval_distinct(expt, ctrl):
    """``calc_pval`` evaluated once per distinct (expt, ctrl) pair and
    gathered back: pileup values are few, intervals many."""
    key = (expt.view(torch.int32).to(torch.int64) << 32) \
        | (ctrl.view(torch.int32).to(torch.int64) & 0xFFFFFFFF)
    uk, inv = torch.unique(key, return_inverse=True)
    ue = (uk >> 32).to(torch.int32).view(torch.float32)
    uc = (uk & 0xFFFFFFFF).to(torch.int32).view(torch.float32)
    return calc_pval(ue, uc)[inv]


def fisher_neglog10(total, df):
    """-log10 of the chi-squared upper tail at ``2 ln(10) * total`` with
    ``df`` (even, >= 4) degrees of freedom: Fisher's method over df / 2
    replicates whose -log10 p sum to ``total``.  For even df the tail
    is exp(-x/2) * sum_{j < df/2} (x/2)^j / j!, summed here in log space
    in float64."""
    h = total.to(F64) * _LN10          # x / 2
    k = int(df.max()) // 2 if df.numel() else 0
    j = torch.arange(k, dtype=F64, device=h.device)
    logh = torch.log(torch.clamp_min(h, 1e-300))
    terms = j[None, :] * logh[:, None] - torch.lgamma(j + 1)[None, :]
    terms = torch.where(j[None, :] < (df[:, None] // 2),
                        terms, torch.full_like(terms, -math.inf))
    terms[:, 0] = 0.0                  # (x/2)^0 / 0! = 1, also at x = 0
    return (h - torch.logsumexp(terms, dim=1)) / _LN10
