"""-log10 p-values under the log-normal null (vectorized float64).

Ports of the R-3.5.0-derived routines in the reference — do_del/pnorm
(Genrich.c:1497-1607), plnorm (1617-1621), calcPval (1628-1653) — as
numpy float64 array programs.  IEEE-754 double arithmetic is
deterministic, so elementwise evaluation in the same operation order
reproduces the reference bit-for-bit; only the loop over intervals is
vectorized.

Also the two-pointer expt x ctrl merge (savePval, Genrich.c:1720-1794)
expressed as a union-of-breakpoints gather.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

from ..utils.cfloat import FLT_MAX, LOGSQRT, SKIP, SQRTLOG
from .pileup import Pileup

F32 = np.float32
_A = np.array([2.2352520354606839287, 161.02823106855587881,
               1067.6894854603709582, 18154.981253343561249,
               0.065682337918207449113])
_B = np.array([47.20258190468824187, 976.09855173777669322,
               10260.932208618978205, 45507.789335026729956])
_C = np.array([0.39894151208813466764, 8.8831497943883759412,
               93.506656132177855979, 597.27027639480026226,
               2494.5375852903726711, 6848.1904505362823326,
               11602.651437647350124, 9842.7148383839780218,
               1.0765576773720192317e-8])
_D = np.array([22.266688044328115691, 235.38790178262499861,
               1519.377599407554805, 6485.558298266760755,
               18615.571640885098091, 34900.952721145977266,
               38912.003286093271411, 19685.429676859990727])
_P = np.array([0.21589853405795699, 0.1274011611602473639,
               0.022235277870649807, 0.001421619193227893466,
               2.9112874951168792e-5, 0.02307344176494017303])
_Q = np.array([1.28426009614491121, 0.468238212480865118,
               0.0659881378689285515, 0.00378239633202758244,
               7.29751555083966205e-5])

_M_LN10 = 2.302585092994045684017991454684364208  # math.h M_LN10
_SQRT32 = np.sqrt(np.float64(32.0))
_INV_SQRT_2PI = 1.0 / np.sqrt(2.0 * np.pi)
_DBL_EPSILON = np.finfo(np.float64).eps


def _do_del(y: np.ndarray, temp: np.ndarray, ret: np.ndarray) -> np.ndarray:
    """do_del (Genrich.c:1497-1503), elementwise."""
    xsq = np.trunc(y * 16) / 16
    del_ = (y - xsq) * (y + xsq)
    with np.errstate(over="ignore", invalid="ignore", divide="ignore"):
        lower = np.log1p(-np.exp((-xsq * xsq - del_) / 2.0) * temp)
        upper = (-xsq * xsq - del_) / 2.0 + np.log(temp)
    return np.where(ret, lower, upper)


def pnorm_upper_log(x: np.ndarray) -> np.ndarray:
    """pnorm (Genrich.c:1509-1607): log of the upper tail, elementwise."""
    x = np.asarray(x, np.float64)
    y = np.abs(x)
    out = np.full(x.shape, -0.0)

    with np.errstate(all="ignore"):
        # small |x|
        m1 = y <= 0.67448975
        xsq = x * x
        xnum = _A[4] * xsq
        xden = xsq.copy()
        for i in range(3):
            xnum = (xnum + _A[i]) * xsq
            xden = (xden + _B[i]) * xsq
        temp_small = x * (xnum + _A[3]) / (xden + _B[3])
        temp_tiny = x * _A[3] / _B[3]
        temp1 = np.where(y > _DBL_EPSILON * 0.5, temp_small, temp_tiny)
        out = np.where(m1, np.log(0.5 - temp1), out)

        # mid |x|
        m2 = (~m1) & (y <= _SQRT32)
        xnum = _C[8] * y
        xden = y.copy()
        for i in range(7):
            xnum = (xnum + _C[i]) * y
            xden = (xden + _D[i]) * y
        temp2 = (xnum + _C[7]) / (xden + _D[7])
        out = np.where(m2, _do_del(y, temp2, x <= 0.0), out)

        # large |x| (default branch -0.0 beyond 1e170)
        m3 = (~m1) & (~m2) & (y < 1e170)
        xsq = np.where(m3, 1.0 / (x * x), 1.0)
        xnum = _P[5] * xsq
        xden = xsq.copy()
        for i in range(4):
            xnum = (xnum + _P[i]) * xsq
            xden = (xden + _Q[i]) * xsq
        temp3 = xsq * (xnum + _P[4]) / (xden + _Q[4])
        temp3 = (_INV_SQRT_2PI - temp3) / y
        out = np.where(m3, _do_del(x, temp3, x <= 0.0), out)

    return out


def plnorm_neglog10(x: np.ndarray, meanlog: np.ndarray,
                    sdlog: np.ndarray) -> np.ndarray:
    """plnorm (Genrich.c:1617-1621): -log10 upper-tail, elementwise.

    sdlog == 0 cannot occur on the calcPval path (sdlog >= SQRTLOG).
    """
    with np.errstate(all="ignore"):
        return -pnorm_upper_log((np.log(x) - meanlog) / sdlog) / _M_LN10


def calc_pval(expt: np.ndarray, ctrl: np.ndarray) -> np.ndarray:
    """calcPval (Genrich.c:1628-1653), vectorized over intervals.

    Returns float32 -log10(p); SKIP where ctrl is SKIP.
    """
    expt = np.asarray(expt, F32)
    ctrl = np.asarray(ctrl, F32)
    mu = ctrl.astype(np.float64)
    with np.errstate(all="ignore"):
        big = mu > 7.0
        sd = 10.0 * np.log10(np.where(mu > 0, mu, 1.0))
        mu2 = mu * mu
        sd2 = sd * sd
        meanlog_b = np.log(mu2 / np.sqrt(sd2 + mu2))
        sdlog_b = np.sqrt(np.log1p(sd2 / mu2))
        meanlog_s = np.log(np.where(mu > 0, mu, 1.0)) - LOGSQRT
        meanlog = np.where(big, meanlog_b, meanlog_s)
        sdlog = np.where(big, sdlog_b, SQRTLOG)
        pval = plnorm_neglog10(expt.astype(np.float64), meanlog, sdlog)
    res = np.where(pval > np.float64(FLT_MAX), FLT_MAX,
                   pval.astype(F32)).astype(F32)
    # edge cases (checked in the reference before the math)
    res = np.where(expt == F32(0.0), F32(0.0), res)
    res = np.where(ctrl == F32(0.0),
                   np.where(expt == F32(0.0), F32(0.0), FLT_MAX), res)
    res = np.where(ctrl == SKIP, SKIP, res)
    return res.astype(F32)


def calc_pval_unique(expt: np.ndarray, ctrl: np.ndarray) -> np.ndarray:
    """calc_pval via unique (expt, ctrl) pairs.

    Distinct coverage values are few (fraction-quantized pileups, often
    a constant-lambda control), so evaluating the special functions
    once per distinct pair and gathering is bit-identical and orders of
    magnitude cheaper than elementwise evaluation.
    """
    expt = np.asarray(expt, F32)
    ctrl = np.asarray(ctrl, F32)
    key = (expt.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | ctrl.view(np.uint32).astype(np.uint64)
    # unique without return_inverse (which forces an argsort); the
    # distinct-pair table is tiny, so searchsorted recovers each
    # row's pair index far cheaper than inverse construction.
    uk = np.unique(key)
    idx = np.searchsorted(uk, key)
    ue = (uk >> np.uint64(32)).astype(np.uint32).view(F32)
    uc = uk.astype(np.uint32).view(F32)
    return calc_pval(ue, uc)[idx]


def calc_pval_unique_tab(ends: np.ndarray, expt: np.ndarray,
                         ctrl: np.ndarray):
    """calc_pval_unique plus the pileup's distinct-(p, bp) table.

    Returns (pv, (p_values, bp_lengths)): the per-row p array and, as
    a byproduct of the distinct-pair evaluation, the summed interval
    length per distinct pair with SKIP rows dropped — the per-chrom
    contribution to the genome-wide BH histogram (hashPval,
    Genrich.c:300-327), computed here for free instead of re-grouping
    the rows later.  p values in the table may repeat (different
    (expt, ctrl) pairs can give equal p); consumers merge by value.
    """
    from ..utils.cfloat import SKIP
    expt = np.asarray(expt, F32)
    ctrl = np.asarray(ctrl, F32)
    key = (expt.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | ctrl.view(np.uint32).astype(np.uint64)
    uk = np.unique(key)
    ends = np.asarray(ends, np.int64)
    # row mapping + per-pair bp totals: one native hash probe per row
    # when the library is present — numpy's searchsorted(uk, key) is a
    # log2(d)-level binary search per row (the p-value stage's
    # dominant term at 100M+ rows) and the diff/astype/bincount chain
    # three more full passes.  Identical outputs: both sum the int64
    # interval lengths per distinct pair in float64 (exact < 2^53).
    from ..ingest import native as _nat
    fused = _nat.pair_index_tab(key, uk, ends)
    if fused is not None:
        idx, ul = fused
    else:
        idx = np.searchsorted(uk, key)
        lens = np.diff(ends, prepend=np.int64(0))
        # float64 bincount is exact below 2^53 (genome bp fits)
        ul = np.bincount(idx, weights=lens.astype(np.float64),
                         minlength=len(uk))
    ue = (uk >> np.uint64(32)).astype(np.uint32).view(F32)
    uc = uk.astype(np.uint32).view(F32)
    up = calc_pval(ue, uc)
    keep = up != F32(SKIP)
    return up[idx], (up[keep], ul[keep].astype(np.uint64))


def merge_pileups(expt: Pileup, ctrl: Pileup
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Two-pointer merge of expt/ctrl RLEs (savePval, Genrich.c:1766-1791).

    Returns (ends, expt_vals, ctrl_vals) over the union of breakpoints.
    """
    if len(ctrl.end) <= 64:
        # common case (constant-lambda / few -E runs): merge the few
        # ctrl boundaries into the sorted expt ends without re-sorting.
        # RLE ends are strictly increasing, so the expt row index is
        # pure insertion arithmetic — original row k stays k, an
        # inserted boundary reads the run it splits (the first expt
        # end above it) — no log(n) searchsorted over the big array
        # and, with no insertions, no gather at all.
        extra = np.setdiff1d(ctrl.end, expt.end, assume_unique=False)
        ex = np.asarray(expt.end, np.int64)
        if len(extra):
            ins = np.searchsorted(ex, extra)
            ends = np.insert(ex, ins, extra)
            ei = np.insert(np.arange(len(ex), dtype=np.int64), ins,
                           ins)
            ev = expt.cov[ei]
        else:
            ends = ex
            ev = np.asarray(expt.cov)
        ci = np.searchsorted(ctrl.end, ends, side="left")
        return ends, ev, ctrl.cov[ci]
    ends = np.union1d(expt.end, ctrl.end)
    ei = np.searchsorted(expt.end, ends, side="left")
    ci = np.searchsorted(ctrl.end, ends, side="left")
    return ends, expt.cov[ei], ctrl.cov[ci]


def pval_pileup(expt: Pileup, ctrl: Pileup) -> Pileup:
    """savePval for one chromosome: merged intervals with -log10 p."""
    ends, ev, cv = merge_pileups(expt, ctrl)
    return Pileup(ends, calc_pval_unique(ev, cv))
