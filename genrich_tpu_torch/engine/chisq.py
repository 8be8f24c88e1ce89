"""Fisher's-method combination of replicate p-values (chi-squared).

Vectorized float64 ports of the R-3.5.0-derived routines bd0/stirlerr/
dpois/pd_upper_series/pd_lower_series/pgamma_smallx/pgamma/pchisq
(Genrich.c:403-559) and multPval/combinePval (567-667).  Iterative
series are evaluated with per-element convergence masks, reproducing
each element's exact termination point.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.cfloat import FLT_MAX, SKIP
from .pileup import Pileup

F32 = np.float32
_M_LN2 = 0.693147180559945309417232121458176568
_M_LN10 = 2.302585092994045684017991454684364208
_M_LOG10E = 0.434294481903251827651128918916605082
_DBL_EPSILON = np.finfo(np.float64).eps
_DBL_MIN = np.finfo(np.float64).tiny

_SFERR = np.array([
    0.0, 0.0810614667953272582196702, 0.0413406959554092940938221,
    0.02767792568499833914878929, 0.02079067210376509311152277,
    0.01664469118982119216319487, 0.01387612882307074799874573,
    0.01189670994589177009505572, 0.010411265261972096497478567,
    0.009255462182712732917728637, 0.008330563433362871256469318,
    0.007573675487951840794972024, 0.006942840107209529865664152,
    0.006408994188004207068439631, 0.005951370112758847735624416,
    0.005554733551962801371038690])
_S0, _S1, _S2, _S3, _S4 = (1/12., 1/360., 1/1260., 1/1680., 1/1188.)


def _log1_exp(x: np.ndarray) -> np.ndarray:
    """R_Log1_Exp (dpq.h): log(1 - exp(x)) for x <= 0."""
    with np.errstate(all="ignore"):
        return np.where(x > -_M_LN2, np.log(-np.expm1(x)),
                        np.log1p(-np.exp(x)))


def _bd0(x: np.ndarray, np_: np.ndarray) -> np.ndarray:
    """bd0 (Genrich.c:412-430), elementwise with convergence masks."""
    x = np.asarray(x, np.float64)
    np_ = np.asarray(np_, np.float64)
    with np.errstate(all="ignore"):
        fallback = x * np.log(x / np_) + np_ - x
        near = np.abs(x - np_) < 0.1 * (x + np_)
        v = np.where(near, (x - np_) / (x + np_), 0.0)
        s = (x - np_) * v
        tiny = np.abs(s) < _DBL_MIN
        ej = 2 * x * v
        v2 = v * v
        active = near & ~tiny
        res = s.copy()
        converged = np.zeros(x.shape, bool)
        for j in range(1, 1000):
            if not active.any():
                break
            ej = np.where(active, ej * v2, ej)
            s1 = np.where(active, res + ej / (2 * j + 1), res)
            done = active & (s1 == res)
            converged |= done
            res = np.where(active, s1, res)
            active = active & ~done
    # elements that never converge fall through to the direct formula
    # (reference: the for loop exits to the final return, bd0
    # Genrich.c:421-429)
    use_series = near & ~tiny & converged
    return np.where(near & tiny, s,
                    np.where(use_series, res, fallback))


def _stirlerr(n: np.ndarray) -> np.ndarray:
    """stirlerr (Genrich.c:436-469); n integral in [1, 199]."""
    n = np.asarray(n, np.float64)
    nn = n * n
    big = (_S0 - (_S1 - _S2 / nn) / nn) / n
    mid = (_S0 - (_S1 - (_S2 - _S3 / nn) / nn) / nn) / n
    small = (_S0 - (_S1 - (_S2 - (_S3 - _S4 / nn) / nn) / nn) / nn) / n
    idx = np.clip(n.astype(np.int64), 0, 15)
    table = _SFERR[idx]
    return np.where(n > 80.0, big,
                    np.where(n > 35.0, mid,
                             np.where(n > 15.0, small, table)))


def _dpois(x: np.ndarray, lam: np.ndarray) -> np.ndarray:
    """dpois (Genrich.c:474-477)."""
    with np.errstate(all="ignore"):
        return (-0.5 * np.log(2.0 * np.pi * x) - _stirlerr(x)
                - _bd0(x, lam))


def _pd_upper_series(x: np.ndarray, alph: np.ndarray) -> np.ndarray:
    """pd_upper_series (Genrich.c:482-491), per-element convergence."""
    x = np.asarray(x, np.float64)
    a = np.asarray(alph, np.float64).copy()
    term = x / a
    total = term.copy()
    active = np.ones(x.shape, bool)
    with np.errstate(all="ignore"):
        while active.any():
            a = np.where(active, a + 1, a)
            term = np.where(active, term * x / a, term)
            total = np.where(active, total + term, total)
            active = active & (term > total * _DBL_EPSILON)
        return np.log(total)


def _pd_lower_series(lam: np.ndarray, y: np.ndarray) -> np.ndarray:
    """pd_lower_series (Genrich.c:496-504), per-element convergence."""
    lam = np.asarray(lam, np.float64)
    y = np.asarray(y, np.float64).copy()
    term = np.ones(lam.shape)
    total = np.zeros(lam.shape)
    active = (y >= 1)
    with np.errstate(all="ignore"):
        while active.any():
            term = np.where(active, term * y / lam, term)
            total = np.where(active, total + term, total)
            y = np.where(active, y - 1, y)
            active = active & (y >= 1) & (term > total * _DBL_EPSILON)
        return np.log1p(total)


def _lgamma(x: np.ndarray) -> np.ndarray:
    import math
    return np.vectorize(math.lgamma, otypes=[np.float64])(x)


def pgamma_smallx(x: np.ndarray, alph: np.ndarray) -> np.ndarray:
    """pgamma_smallx (Genrich.c:509-522), per-element convergence."""
    x = np.asarray(x, np.float64)
    alph = np.asarray(alph, np.float64)
    total = np.zeros(x.shape)
    c = alph.astype(np.float64).copy()
    n = np.zeros(x.shape)
    active = np.ones(x.shape, bool)
    with np.errstate(all="ignore"):
        while active.any():
            n = np.where(active, n + 1, n)
            c = np.where(active, c * -x / n, c)
            term = np.where(active, c / (alph + n), 0.0)
            total = np.where(active, total + term, total)
            active = active & (np.abs(term)
                               > _DBL_EPSILON * np.abs(total))
        lf2 = alph * np.log(x) - _lgamma(alph + 1)
        return _log1_exp(np.log1p(total) + lf2)


def pgamma(x: np.ndarray, alph: np.ndarray) -> np.ndarray:
    """pgamma (Genrich.c:528-545): log upper-tail, alph int in [2,200]."""
    x = np.asarray(x, np.float64)
    alph = np.asarray(alph, np.float64)
    out = np.zeros(x.shape)
    with np.errstate(all="ignore"):
        m_small = x < 1
        if m_small.any():
            out = np.where(m_small, pgamma_smallx(np.where(m_small, x, 0.5),
                                                  alph), out)
        m_upper = (~m_small) & (x <= alph - 1)
        if m_upper.any():
            xs = np.where(m_upper, x, 2.0)
            s = _pd_upper_series(xs, alph)
            d = _dpois(alph - 1, xs)
            out = np.where(m_upper, _log1_exp(s + d), out)
        m_lower = (~m_small) & (~m_upper)
        if m_lower.any():
            xs = np.where(m_lower, x, 2.0)
            s = _pd_lower_series(xs, alph - 1)
            d = _dpois(alph - 1, xs)
            out = np.where(m_lower, s + d, out)
    return out


def pchisq_neglog10(x: np.ndarray, df: np.ndarray) -> np.ndarray:
    """pchisq (Genrich.c:555-559): -log10 upper tail, df even in [4,400]."""
    return -pgamma(np.asarray(x, np.float64) / 2.0,
                   np.asarray(df, np.float64) / 2.0) / _M_LN10


def combine_pvals(pvals: List[Optional[Pileup]], chrom_len: int
                  ) -> Optional[Pileup]:
    """combinePval/multPval for one chromosome (Genrich.c:567-667).

    ``pvals`` holds each replicate's p-value pileup (None if absent).
    Returns the combined pileup over the union of breakpoints, or None
    if no replicate has one.
    """
    live = [p for p in pvals if p is not None]
    if not live:
        return None
    ends = live[0].end
    for p in live[1:]:
        ends = np.union1d(ends, p.end)
    # gather each replicate's value per merged interval
    n = len(ends)
    total = np.zeros(n, np.float64)
    df = np.zeros(n, np.int64)
    for p in pvals:
        if p is None:
            continue
        v = p.cov[np.searchsorted(p.end, ends, side="left")]
        ok = v != SKIP
        total += np.where(ok, v.astype(np.float64), 0.0)
        df += np.where(ok, 2, 0)
    cov = np.full(n, SKIP, F32)
    m1 = df == 2
    cov = np.where(m1, total.astype(F32), cov)
    mz = (df > 2) & (total == 0.0)
    cov = np.where(mz, total.astype(F32), cov)
    mc = (df > 2) & (total != 0.0)
    if mc.any():
        p = pchisq_neglog10(2.0 * total[mc] / _M_LOG10E, df[mc])
        pc = np.where(p > np.float64(FLT_MAX), FLT_MAX,
                      p.astype(F32)).astype(F32)
        cov[mc] = pc
    cov = np.where(df == 0, SKIP, cov).astype(F32)
    return Pileup(ends, cov)
