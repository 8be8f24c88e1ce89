"""Benjamini-Hochberg q-values in -log10 space (vectorized).

Replaces the reference's hashtable + quicksort (Genrich.c:146-401) with
a numpy sort over distinct float32 p-values; the math (saveQval,
Genrich.c:212-250) is replicated in float32 operation order:

    q[i] = max(min(p[i] + (-log10f(N)) + log10f(k), q[i+1]), 0)

with k = 1 + total bp at strictly higher p, swept from the largest p
down (reverse cumulative-min ensures monotonicity).
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from ..utils.cfloat import FLT_MAX, SKIP, log10f, log10f_arr
from .pileup import Pileup

F32 = np.float32


def collect_pvals(pvals: List[Pileup]) -> Tuple[np.ndarray, np.ndarray]:
    """hashPval equivalent: distinct p-values with summed bp lengths.

    ``pvals`` are the final per-chrom p-value pileups (SKIP excluded).
    Returns (distinct p ascending, total length per p).
    """
    live = [p for p in pvals if p is not None]
    vs = []
    ls = []
    if live and all(p.tab is not None for p in live):
        # per-chrom distinct tables were cached at p-value time:
        # merge thousands of rows instead of re-grouping millions
        for p in live:
            vs.append(p.tab[0])
            ls.append(p.tab[1])
    else:
        for p in live:
            starts = np.concatenate([[0], p.end[:-1]])
            lens = (p.end - starts).astype(np.uint64)
            keep = p.cov != SKIP
            vs.append(p.cov[keep])
            ls.append(lens[keep])
    if not vs:
        return np.zeros(0, F32), np.zeros(0, np.uint64)
    v = np.concatenate(vs)
    l = np.concatenate(ls)
    if len(v) == 0:
        return np.zeros(0, F32), np.zeros(0, np.uint64)
    # group by uint32 bit pattern: for non-negative floats unsigned
    # bit order == value order, so np.unique runs its fast integer
    # sort instead of a stable float argsort (~3x cheaper at 1e7
    # rows).  v + 0.0 canonicalizes any -0.0 to +0.0 first so the
    # two zero bit patterns can't split one distinct value.  The bit
    # trick is order-preserving ONLY for non-negative floats; SKIP is
    # filtered above and p = -log10 >= 0, so a negative value here
    # means a broken producer — fail loudly rather than mis-sort BH.
    if v.min() < F32(0.0):
        raise AssertionError(
            f"negative -log10 p ({float(v.min())}) reached "
            f"collect_pvals; bit-pattern grouping requires >= 0")
    bits = (v + F32(0.0)).view(np.uint32)
    # unique WITHOUT return_inverse (which forces an argsort); the
    # distinct table is tiny, so searchsorted recovers the group index
    # of each row against it far cheaper than inverse construction.
    uk = np.unique(bits)
    idx = np.searchsorted(uk, bits)
    # lengths are genome bp: float64 bincount is exact below 2^53
    ul = np.bincount(idx, weights=l.astype(np.float64),
                     minlength=len(uk))
    return uk.view(F32).astype(F32), ul.astype(np.uint64)


def qvalues(p_distinct: np.ndarray, p_len: np.ndarray,
            genome_len: int) -> np.ndarray:
    """saveQval math (Genrich.c:219-229) over ascending distinct p."""
    n = len(p_distinct)
    if n == 0:
        return np.zeros(0, F32)
    log_n = F32(-log10f(F32(genome_len)))
    # k[i] = 1 + sum of lengths of p > p[i]
    k = np.ones(n, np.uint64)
    k[:-1] += np.cumsum(p_len[::-1].astype(np.uint64))[::-1][1:]
    # float32 left-associated: (p + logN) + log10f((float)k)
    raw = (p_distinct + log_n).astype(F32) + log10f_arr(k.astype(F32))
    raw = raw.astype(F32)
    # reverse sweep with min(prev q) then max(0): a reverse cummin
    q = np.minimum.accumulate(raw[::-1])[::-1]
    return np.maximum(q, F32(0.0)).astype(F32)


def merge_distinct_tables(ps: List[np.ndarray], ws: List[np.ndarray],
                          genome_len: int, lo: int = 1 << 8):
    """Merge per-chrom/per-shard distinct (p, bp) tables into one
    genome-wide table and run the exact BH sweep.

    ``ps``/``ws`` are parallel lists of float32 p-values and uint64 bp
    lengths (values may repeat across lists).  Returns
    ``(uv, qv, tab_p, tab_q, total_bp, all_one)``: the ascending
    distinct p-values, their q-values, the same padded to a power of
    two (>= ``lo``) with +inf / 0 (the fixed-shape device lookup
    table), the summed bp, and the all-q-values-one warning flag.
    Shared by the device engines (jax/sharded bridges) and the mesh's
    ``exact_q_table`` — one merge, one sweep, everywhere
    (computeQval, Genrich.c:352-401).
    """
    if not ps:
        return (np.zeros(0, F32), np.zeros(0, F32),
                np.full(max(lo, 1), np.inf, F32),
                np.zeros(max(lo, 1), F32), 0, False)
    p_all = np.concatenate(ps)
    w_all = np.concatenate(ws)
    uv, inv = np.unique(p_all, return_inverse=True)
    ul = np.zeros(len(uv), np.uint64)
    np.add.at(ul, inv, w_all.astype(np.uint64))
    qv = qvalues(uv.astype(F32), ul, genome_len)
    size = lo
    while size < len(uv):
        size <<= 1
    tab_p = np.full(size, np.inf, F32)
    tab_q = np.zeros(size, F32)
    tab_p[:len(uv)] = uv
    tab_q[:len(uv)] = qv
    return (uv.astype(F32), qv, tab_p, tab_q, int(ul.sum()),
            all_qvalues_one(qv))


def qval_pileup(pval: Pileup, p_distinct: np.ndarray,
                qv: np.ndarray) -> Pileup:
    """Per-chrom lookup of q for each p interval (saveQval tail)."""
    cov = np.full(len(pval.cov), SKIP, F32)
    keep = pval.cov != SKIP
    idx = np.searchsorted(p_distinct, pval.cov[keep])
    cov[keep] = qv[idx]
    return Pileup(pval.end, cov)


def all_qvalues_one(qv: np.ndarray) -> bool:
    """Warning condition (Genrich.c:245): largest q is 0."""
    return len(qv) > 0 and qv[-1] == F32(0.0)
