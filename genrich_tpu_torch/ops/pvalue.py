"""-log10 p under the log-normal null (twin of ops/pvalue_jax.py).

calcPval/plnorm/pnorm (Genrich.c:1490-1653; R-3.5.0 rational
approximations) as a branch-free tensor program, parameterised by the
dtype of its input: float64 follows the exact engine
(``engine/pvalue.py``), float32 is the device path.  The
same float32 arithmetic is written in CUDA in ``csrc/pval.cuh`` for the
kernels; this module is its plain version.

Constants are the exact engine's (``engine/pvalue.py:24-45``), each
rounded to the working dtype before use, as ``jnp.asarray(c, dt)`` does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..engine.pvalue import _A, _B, _C, _D, _M_LN10, _P, _Q
from ..utils.cfloat import FLT_MAX, LOGSQRT, SQRTLOG

_NP = {torch.float32: np.float32, torch.float64: np.float64}


def _k(c, dt) -> float:
    """A constant rounded to ``dt`` (exact as a Python float)."""
    return float(_NP[dt](c))


def _do_del(y, temp, ret):
    xsq = torch.trunc(y * 16) / 16
    d = (y - xsq) * (y + xsq)
    lower = torch.log1p(-torch.exp((-xsq * xsq - d) / 2) * temp)
    upper = (-xsq * xsq - d) / 2 + torch.log(temp)
    return torch.where(ret, lower, upper)


def pnorm_upper_log(x: torch.Tensor) -> torch.Tensor:
    """log of the standard-normal upper tail (pnorm port)."""
    dt = x.dtype
    y = torch.abs(x)
    eps = torch.finfo(dt).eps

    # small |x|
    xsq = x * x
    xnum = _k(_A[4], dt) * xsq
    xden = xsq
    for i in range(3):
        xnum = (xnum + _k(_A[i], dt)) * xsq
        xden = (xden + _k(_B[i], dt)) * xsq
    t_small = x * (xnum + _k(_A[3], dt)) / (xden + _k(_B[3], dt))
    t_tiny = x * _k(_A[3] / _B[3], dt)
    t1 = torch.where(y > eps * 0.5, t_small, t_tiny)
    r_small = torch.log(_k(0.5, dt) - t1)

    # mid |x|
    xnum = _k(_C[8], dt) * y
    xden = y
    for i in range(7):
        xnum = (xnum + _k(_C[i], dt)) * y
        xden = (xden + _k(_D[i], dt)) * y
    t2 = (xnum + _k(_C[7], dt)) / (xden + _k(_D[7], dt))
    r_mid = _do_del(y, t2, x <= 0)

    # large |x|
    inv = 1.0 / torch.clamp_min(x * x, _k(1e-30, dt))
    xnum = _k(_P[5], dt) * inv
    xden = inv
    for i in range(4):
        xnum = (xnum + _k(_P[i], dt)) * inv
        xden = (xden + _k(_Q[i], dt)) * inv
    t3 = inv * (xnum + _k(_P[4], dt)) / (xden + _k(_Q[4], dt))
    t3 = (_k(1.0 / np.sqrt(2 * np.pi), dt) - t3) \
        / torch.clamp_min(y, _k(1e-30, dt))
    r_large = _do_del(x, t3, x <= 0)

    sqrt32 = _k(np.sqrt(32.0), dt)
    huge = 1e170 if dt == torch.float64 else float(np.finfo(np.float32).max)
    neg0 = torch.full_like(x, -0.0)
    return torch.where(y <= _k(0.67448975, dt), r_small,
                       torch.where(y <= sqrt32, r_mid,
                                   torch.where(y < huge, r_large, neg0)))


def calc_pval(expt: torch.Tensor, ctrl: torch.Tensor) -> torch.Tensor:
    """-log10 p per interval (calcPval port); ctrl == SKIP -> SKIP."""
    dt = expt.dtype
    mu = ctrl.to(dt)
    mu_safe = torch.clamp_min(mu, _k(1e-30, dt))
    big = mu > 7.0
    sd = 10.0 * torch.log10(mu_safe)
    mu2 = mu_safe * mu_safe
    sd2 = sd * sd
    meanlog = torch.where(big, torch.log(mu2 / torch.sqrt(sd2 + mu2)),
                          torch.log(mu_safe) - _k(LOGSQRT, dt))
    sdlog = torch.where(big, torch.sqrt(torch.log1p(sd2 / mu2)),
                        torch.full_like(mu, _k(SQRTLOG, dt)))
    x = (torch.log(torch.clamp_min(expt, _k(1e-30, dt))) - meanlog) \
        / sdlog
    pval = -pnorm_upper_log(x) / _k(_M_LN10, dt)
    pval = torch.clamp_max(pval, _k(FLT_MAX, dt))
    zero = torch.zeros_like(pval)
    big_p = torch.full_like(pval, _k(FLT_MAX, dt))
    pval = torch.where(expt == 0, zero, pval)
    pval = torch.where(ctrl == 0, torch.where(expt == 0, zero, big_p),
                       pval)
    return torch.where(ctrl == -1.0, torch.full_like(pval, -1.0), pval)
