"""Fisher combination of replicate p-values (twin of ops/chisq_jax.py).

The R-3.5.0 pgamma family (``engine/chisq.py`` documents the exact
engine's versions; Genrich.c:403-667) as tensor programs, parameterised
by the dtype of their input: float64 follows the exact engine, float32
the JAX package's device form.  Each ``lax.while_loop`` of the JAX twin
is a per-lane masked loop here: a lane stops updating at its own
convergence point, and the loop runs until no lane is active (``_bd0``
keeps its 1000-term cap).

``fisher_combine`` is multPval/combinePval (Genrich.c:567-667) over
aligned replicate rows.  On a CUDA tensor it launches kernel K3
(``csrc/fisher.cu``), which runs the series per lane in double; on a
CPU tensor it runs ``fisher_combine_plain``, the same math in float64
here.  There is no fallback from one to the other.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from genrich_tpu.utils.cfloat import FLT_MAX

from .. import kernels

SKIP = -1.0
MAX_REPLICATES = 200       # pgamma's alph = live replicates, in [2, 200]
_M_LN2 = 0.693147180559945309417232121458176568
_M_LN10 = 2.302585092994045684017991454684364208
_M_LOG10E = 0.434294481903251827651128918916605082
_SFERR = np.array([
    0.0, 0.0810614667953272582196702, 0.0413406959554092940938221,
    0.02767792568499833914878929, 0.02079067210376509311152277,
    0.01664469118982119216319487, 0.01387612882307074799874573,
    0.01189670994589177009505572, 0.010411265261972096497478567,
    0.009255462182712732917728637, 0.008330563433362871256469318,
    0.007573675487951840794972024, 0.006942840107209529865664152,
    0.006408994188004207068439631, 0.005951370112758847735624416,
    0.005554733551962801371038690])
_S = (1 / 12., 1 / 360., 1 / 1260., 1 / 1680., 1 / 1188.)


def _log1_exp(x):
    """R_Log1_Exp: log(1 - exp(x)) for x <= 0."""
    return torch.where(x > -_M_LN2, torch.log(-torch.expm1(x)),
                       torch.log1p(-torch.exp(x)))


def _bd0(x, np_):
    fallback = x * torch.log(x / np_) + np_ - x
    near = torch.abs(x - np_) < 0.1 * (x + np_)
    v = torch.where(near, (x - np_) / (x + np_), torch.zeros_like(x))
    s = (x - np_) * v
    tiny = torch.abs(s) < torch.finfo(x.dtype).tiny
    ej = 2 * x * v
    v2 = v * v
    active = near & ~tiny
    j = 1
    while j < 1000 and bool(active.any()):
        ej = torch.where(active, ej * v2, ej)
        s1 = torch.where(active, s + ej / (2 * j + 1), s)
        active = active & (s1 != s)
        s = s1
        j += 1
    return torch.where(near, s, fallback)


def _stirlerr(n):
    s0, s1, s2, s3, s4 = _S
    nn = n * n
    big = (s0 - (s1 - s2 / nn) / nn) / n
    mid = (s0 - (s1 - (s2 - s3 / nn) / nn) / nn) / n
    small = (s0 - (s1 - (s2 - (s3 - s4 / nn) / nn) / nn) / nn) / n
    tab = torch.as_tensor(_SFERR, dtype=n.dtype, device=n.device)[
        torch.clamp(n.to(torch.int32), 0, 15).long()]
    return torch.where(n > 80.0, big,
                       torch.where(n > 35.0, mid,
                                   torch.where(n > 15.0, small, tab)))


def _dpois(x, lam):
    return (-0.5 * torch.log(2.0 * math.pi * x) - _stirlerr(x)
            - _bd0(x, lam))


def _pd_upper_series(x, alph):
    eps = torch.finfo(x.dtype).eps
    a = alph
    term = x / alph
    total = term
    active = x == x
    while bool(active.any()):
        a = torch.where(active, a + 1, a)
        term = torch.where(active, term * x / a, term)
        total = torch.where(active, total + term, total)
        active = active & (term > total * eps)
    return torch.log(total)


def _pd_lower_series(lam, y):
    eps = torch.finfo(lam.dtype).eps
    term = torch.ones_like(lam)
    total = torch.zeros_like(lam)
    active = y >= 1
    while bool(active.any()):
        term = torch.where(active, term * y / lam, term)
        total = torch.where(active, total + term, total)
        y = torch.where(active, y - 1, y)
        active = active & (y >= 1) & (term > total * eps)
    return torch.log1p(total)


def _pgamma_smallx(x, alph):
    eps = torch.finfo(x.dtype).eps
    n = torch.zeros_like(x)
    c = alph + 0.0
    total = torch.zeros_like(x)
    active = x == x
    while bool(active.any()):
        n = torch.where(active, n + 1, n)
        c = torch.where(active, c * -x / n, c)
        term = torch.where(active, c / (alph + n), torch.zeros_like(x))
        total = torch.where(active, total + term, total)
        active = active & (torch.abs(term) > eps * torch.abs(total))
    lf2 = alph * torch.log(x) - torch.lgamma(alph + 1)
    return _log1_exp(torch.log1p(total) + lf2)


def pgamma(x: torch.Tensor, alph) -> torch.Tensor:
    """log upper-tail gamma CDF; alph integral in [2, 200].

    Each series gets its own lanes' x and, on the other lanes, a value
    that converges at once (the JAX twin feeds every lane to every
    series and selects; the selected lanes see the same values).
    """
    alph = torch.broadcast_to(torch.as_tensor(alph, dtype=x.dtype,
                                              device=x.device), x.shape)
    xs = torch.clamp_min(x, 1e-30)
    small_lane = x < 1
    upper_lane = ~small_lane & (x <= alph - 1)
    half, one = torch.full_like(x, 0.5), torch.ones_like(x)
    small = _pgamma_smallx(torch.where(small_lane, xs, half), alph)
    xm = torch.where(small_lane, torch.full_like(x, 2.0), xs)
    d = _dpois(alph - 1, xm)
    up = _log1_exp(_pd_upper_series(torch.where(upper_lane, xm, one),
                                    alph) + d)
    lo = _pd_lower_series(xm, torch.where(small_lane | upper_lane,
                                          torch.zeros_like(x),
                                          alph - 1)) + d
    return torch.where(small_lane, small, torch.where(upper_lane, up, lo))


def pchisq_neglog10(x: torch.Tensor, df) -> torch.Tensor:
    """-log10 chi-squared upper tail (df even in [4, 400])."""
    df = torch.as_tensor(df, dtype=x.dtype, device=x.device)
    return -pgamma(x / 2.0, df / 2.0) / _M_LN10


def fisher_combine_plain(pvals: torch.Tensor) -> torch.Tensor:
    """Plain version of kernel K3: float64 math, float32 result.

    combinePval's rules (engine/chisq.combine_pvals): the live values
    (not SKIP) add in replicate order in float64; df = 2 * live;
    df 0 -> SKIP, df 2 or a zero total -> the total, otherwise the
    chi-squared -log10 p clamped to FLT_MAX before rounding to float32.
    """
    p = pvals.to(torch.float64)
    live = pvals != SKIP
    total = torch.zeros(pvals.shape[1], dtype=torch.float64,
                        device=pvals.device)
    for r in range(pvals.shape[0]):
        total = total + torch.where(live[r], p[r], torch.zeros_like(total))
    n_live = live.sum(dim=0)
    comb = pchisq_neglog10(2.0 * total / _M_LOG10E,
                           (2 * n_live).to(torch.float64))
    comb = torch.clamp_max(comb, float(FLT_MAX)).to(torch.float32)
    keep = (n_live == 1) | (total == 0.0)
    out = torch.where(keep, total.to(torch.float32), comb)
    return torch.where(n_live == 0, torch.full_like(out, SKIP), out)


def _fisher_combine_cuda(pvals: torch.Tensor) -> torch.Tensor:
    """Launch csrc/fisher.cu on the card (see its header)."""
    pvals = pvals.contiguous()
    r, n = pvals.shape
    with torch.cuda.device(pvals.device):
        lib = kernels.library()
        out = torch.empty(n, dtype=torch.float32, device=pvals.device)
        rc = lib.fisher_combine_launch(kernels.ptr(pvals), r, n,
                                       kernels.ptr(out),
                                       kernels.stream_of(pvals))
        kernels.check(rc, "fisher_combine")
    kernels.LAUNCHES["fisher_combine"] += 1
    return out


def fisher_combine(pvals: torch.Tensor) -> torch.Tensor:
    """Combine aligned replicate -log10 p rows, f32 [R, N] -> f32 [N].

    SKIP (-1) values are excluded per lane; lanes with no live value
    are SKIP.  Kernel K3 on CUDA tensors, the plain version on CPU
    tensors.
    """
    if pvals.dtype != torch.float32 or pvals.dim() != 2:
        raise TypeError("fisher_combine takes f32 [R, N]")
    if not 1 <= pvals.shape[0] <= MAX_REPLICATES:
        raise ValueError(f"fisher_combine takes 1 to {MAX_REPLICATES} "
                         f"replicates, not {pvals.shape[0]}")
    if pvals.device.type == "cuda":
        return _fisher_combine_cuda(pvals)
    if pvals.device.type != "cpu":
        raise ValueError(f"unsupported device {pvals.device}")
    return fisher_combine_plain(pvals)
