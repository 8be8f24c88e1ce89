"""Pileup construction from fragment-interval events (vectorized, exact).

The reference accumulates per-base difference entries as an ``int16``
whole-count plus an 8-bit mixed-radix fraction (3 bits eighths / 2 bits
sixths / 3 bits tenths, with halves normalized into bit 0x4 of the
eighths field; addFrac/subFrac Genrich.c:2311-2488, updateVal
Genrich.c:1915-1973, getVal Genrich.c:1902-1907).  That encoding is an
exact mixed-radix number system: every add/subtract of a weight 1/N
(N in {1,2,3,4,5,6,8,10}) contributes a fixed raw amount to one of four
independent integer counters

    cov   whole units           e8    eighths  (1/8)
    s6    sixths  (1/6)         t10   tenths   (1/10)

and the carry/borrow logic merely keeps the stored representation
canonical.  Canonicalization is invariant under reordering and batching,
so the running pileup value at any base equals

    halves = e8//4 + s6//3 + t10//5          (cumulative sums)
    value  = canon(cov + halves//2,
                   e = e8%4 + 4*(halves%2), s = s6%3, t = t10%5)

reconstructed in float32 exactly as getVal does.  This reduces the
reference's O(genome) per-base sweeps (savePileupExpt Genrich.c:2168,
savePileupCtrl 2052, calcFactor 1980) to an O(events log events)
sort + cumulative-sum + gather program: the natural shape for a TPU.

Raw per-event contributions (derived from addFrac/subFrac):

    add 1/N at start         subtract 1/N at end
    N=1:  cov+1              cov-1
    N=2:  e8+4               cov-1, e8+4
    N=4:  e8+2               cov-1, e8+6
    N=8:  e8+1               cov-1, e8+7
    N=3:  s6+2               cov-1, e8+4, s6+1
    N=6:  s6+1               cov-1, e8+4, s6+2
    N=5:  t10+2              cov-1, e8+4, t10+3
    N=10: t10+1              cov-1, e8+4, t10+4
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.cfloat import SKIP

F32 = np.float32

# raw per-class contributions, indexed by count N (0..10):
#                     N:   0  1  2  3  4  5  6  7  8  9  10
_ADD_COV = np.array(    [0, 1, 0, 0, 0, 0, 0, 0, 0, 0, 0], np.int64)
_ADD_E8 = np.array(     [0, 0, 4, 0, 2, 0, 0, 0, 1, 0, 0], np.int64)
_ADD_S6 = np.array(     [0, 0, 0, 2, 0, 0, 1, 0, 0, 0, 0], np.int64)
_ADD_T10 = np.array(    [0, 0, 0, 0, 0, 2, 0, 0, 0, 0, 1], np.int64)
_SUB_COV = np.array(    [0, -1, -1, -1, -1, -1, -1, 0, -1, 0, -1], np.int64)
_SUB_E8 = np.array(     [0, 0, 4, 4, 6, 4, 4, 0, 7, 0, 4], np.int64)
_SUB_S6 = np.array(     [0, 0, 0, 1, 0, 0, 2, 0, 0, 0, 0], np.int64)
_SUB_T10 = np.array(    [0, 0, 0, 0, 0, 3, 0, 0, 0, 0, 4], np.int64)


class Pileup:
    """Run-length pileup: parallel end/cov arrays (Genrich.h:173-176).

    ``tab`` optionally caches this pileup's distinct-value table
    (values float32, summed bp lengths uint64, SKIP rows excluded) so
    genome-wide consumers (BH q-values) can merge tiny per-chrom
    tables instead of re-grouping millions of RLE rows.
    """

    __slots__ = ("end", "cov", "tab")

    def __init__(self, end: np.ndarray, cov: np.ndarray, tab=None):
        self.end = end    # uint32/int64 interval end coordinates
        self.cov = cov    # float32 values
        self.tab = tab    # None | (values f32, lengths uint64)

    def __len__(self) -> int:
        return len(self.end)


def canon_value_f32(cov: np.ndarray, e8: np.ndarray, s6: np.ndarray,
                    t10: np.ndarray) -> np.ndarray:
    """getVal (Genrich.c:1902-1907) on canonicalized cumulative sums.

    Inputs are cumulative raw class sums (int64).  Float ops replicate
    C: ((float)cov + e/8.0f) + s/6.0f + t/10.0f, left-associated f32.
    """
    halves = e8 // 4 + s6 // 3 + t10 // 5
    covc = (cov + halves // 2).astype(np.int32)
    e = (e8 % 4 + 4 * (halves % 2)).astype(np.int32)
    s = (s6 % 3).astype(np.int32)
    t = (t10 % 5).astype(np.int32)
    v = covc.astype(F32)
    v = v + e.astype(F32) / F32(8.0)
    v = v + s.astype(F32) / F32(6.0)
    v = v + t.astype(F32) / F32(10.0)
    return v


def _entry_nonzero(cov, e8, s6, t10) -> np.ndarray:
    """True where a diff entry canonicalizes to a nonzero value."""
    halves = e8 // 4 + s6 // 3 + t10 // 5
    return ((e8 % 4 != 0) | (s6 % 3 != 0) | (t10 % 5 != 0)
            | (halves % 2 != 0) | (cov + halves // 2 != 0))


def aggregate_events(start: np.ndarray, end: np.ndarray,
                     count: np.ndarray
                     ) -> Tuple[np.ndarray, np.ndarray, np.ndarray,
                                np.ndarray, np.ndarray]:
    """Aggregate events into per-position raw class deltas.

    Returns (upos, dcov, de8, ds6, dt10), position-sorted and unique.
    Implemented as sort + cumulative sums with per-run differencing
    (no scatter-adds): the per-position aggregate is the difference of
    inclusive cumsums at consecutive run boundaries.
    """
    count = count.astype(np.int64)
    pos = np.concatenate([start, end]).astype(np.int64)
    deltas = np.stack([
        np.concatenate([_ADD_COV[count], _SUB_COV[count]]),
        np.concatenate([_ADD_E8[count], _SUB_E8[count]]),
        np.concatenate([_ADD_S6[count], _SUB_S6[count]]),
        np.concatenate([_ADD_T10[count], _SUB_T10[count]])])

    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    cums = np.cumsum(deltas[:, order], axis=1)
    last = np.flatnonzero(np.diff(pos, append=pos[-1] + 1))
    upos = pos[last]
    at_last = cums[:, last]
    agg = np.diff(at_last, axis=1,
                  prepend=np.zeros((4, 1), np.int64))
    return upos, agg[0], agg[1], agg[2], agg[3]


def _nonzero_entries(start, end, count):
    """(positions, cumulative-value-after-position) for canonical-nonzero
    diff entries, plus the final value (must be 0)."""
    from ..ingest.native import breakpoints
    bp = breakpoints(start, end, count)
    if bp is not None:
        return bp
    count64 = count.astype(np.int64)
    pos = np.concatenate([start, end]).astype(np.int64)
    deltas = np.stack([
        np.concatenate([_ADD_COV[count64], _SUB_COV[count64]]),
        np.concatenate([_ADD_E8[count64], _SUB_E8[count64]]),
        np.concatenate([_ADD_S6[count64], _SUB_S6[count64]]),
        np.concatenate([_ADD_T10[count64], _SUB_T10[count64]])])
    order = np.argsort(pos, kind="stable")
    pos = pos[order]
    cums = np.cumsum(deltas[:, order], axis=1)
    last = np.flatnonzero(np.diff(pos, append=pos[-1] + 1))
    upos = pos[last]
    at_last = cums[:, last]
    agg = np.diff(at_last, axis=1,
                  prepend=np.zeros((4, 1), np.int64))
    nz = _entry_nonzero(agg[0], agg[1], agg[2], agg[3])
    upos = upos[nz]
    c = at_last[:, nz]
    vals = canon_value_f32(c[0], c[1], c[2], c[3])
    return upos, vals


def _excluded_mask(starts: np.ndarray, bed: List[int]) -> np.ndarray:
    """For interval start coords, True where inside a -E exclusion.

    ``bed`` is the flat merged [s0,e0,s1,e1,...] array; an interval is
    excluded iff its start falls in some [s,e) (intervals never straddle
    boundaries because every bed coordinate is a breakpoint).
    """
    if not bed:
        return np.zeros(len(starts), bool)
    idx = np.searchsorted(np.asarray(bed, np.int64), starts, side="right")
    return (idx % 2) == 1


def _merge_breaks(entry_pos: np.ndarray, entry_vals: np.ndarray,
                  chrom_len: int, bed: List[int],
                  entry_break_mask: Optional[np.ndarray] = None
                  ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Combine entry breakpoints with bed boundaries; final end at len.

    Returns (ends, vals, excluded): per interval, ``ends`` is the end
    coordinate, ``vals`` the pileup value over the interval, and
    ``excluded`` whether the interval lies in a -E region.  ``vals`` for
    an interval ending at j is the cumulative value over positions < j.

    entry_break_mask optionally restricts which entry positions produce
    breakpoints (they still update the value).
    """
    in_range = (entry_pos > 0) & (entry_pos < chrom_len)
    bp_entries = entry_pos[in_range]
    if entry_break_mask is not None:
        bp_entries = entry_pos[in_range & entry_break_mask]
    # The fast path's index arithmetic assumes the ingest invariants:
    # entry positions sorted/distinct/clamped to [0, chrom_len], so at
    # most one entry <= 0 and at most one >= chrom_len.  Guard with
    # cheap edge counts (a producer emitting several out-of-range
    # entries would otherwise be silently mis-indexed) and fall back
    # to the general union1d/searchsorted path when they fail.
    _n_low = int((entry_pos <= 0).sum())
    _f = 1 if _n_low else 0
    _invariants_ok = (_n_low <= 1
                      and int((entry_pos >= chrom_len).sum()) <= 1)
    if not bed and _invariants_ok and (entry_break_mask is None
                                       or bool(entry_break_mask.all())):
        # fast path (no -E): entry positions are already sorted and
        # distinct, and every break IS an entry, so the value over
        # the interval ending at bp_entries[i] is the cumulative
        # after the entry just below it — index arithmetic, no
        # union1d re-sort and no per-row searchsorted.  f accounts
        # for a possible entry at position 0 (dropped from the
        # breaks, but its value still covers the first interval).
        ends = np.append(bp_entries, chrom_len)
        n_bp = len(bp_entries)
        f = _f
        vals = np.empty(n_bp + 1, F32)
        if f:
            vals[:n_bp] = entry_vals[f - 1:n_bp + f - 1]
        else:
            vals[0] = F32(0.0)
            vals[1:n_bp] = entry_vals[:n_bp - 1]
        # final interval [last_bp, chrom_len): cumulative after the
        # last entry strictly below chrom_len
        below = int(np.searchsorted(entry_pos, chrom_len,
                                    side="left")) - 1
        vals[n_bp] = entry_vals[below] if below >= 0 else F32(0.0)
        excluded = np.zeros(n_bp + 1, bool)
        return ends, vals, excluded
    bed_pos = np.asarray([b for b in bed if 0 < b < chrom_len], np.int64)
    ends = np.union1d(bp_entries, bed_pos)
    ends = np.append(ends, chrom_len)

    # value over [prev, end): cumulative through positions <= end-1
    idx = np.searchsorted(entry_pos, ends, side="left") - 1
    vals = np.where(idx >= 0, entry_vals[np.maximum(idx, 0)], F32(0.0))
    vals = vals.astype(F32)

    starts = np.concatenate([[0], ends[:-1]])
    excluded = _excluded_mask(starts, bed)
    return ends, vals, excluded


def expt_pileup(start, end, count, chrom_len: int, bed: List[int]
                ) -> Tuple[Pileup, np.ndarray]:
    """savePileupExpt for one chromosome (Genrich.c:2168-2295).

    Returns (pileup, frag_len_terms): the RLE pileup (breaks at
    non-excluded value changes and -E boundaries; excluded runs as 0)
    and the float32 weighted-length terms ``(end-start)*val`` of the
    saved intervals, in order, for the caller's exact float64 sum.
    """
    if len(start) == 0:
        return (Pileup(np.array([chrom_len], np.int64),
                       np.zeros(1, F32)), np.zeros(0, F32))
    epos, evals = _nonzero_entries(start, end, count)

    # entry breakpoints only where 'save' is true (interval before the
    # position not excluded): the save status at entry j is that of the
    # interval ending at j, i.e. of coordinate j-1
    save_at = ~_excluded_mask(epos - 1, bed)
    ends, vals, excluded = _merge_breaks(epos, evals, chrom_len, bed,
                                         entry_break_mask=save_at)
    starts = np.concatenate([[0], ends[:-1]])
    lens = (ends - starts).astype(np.int64)

    cov = np.where(excluded, F32(0.0), vals).astype(F32)
    # fragLen += (uint32)(j - start) * (float)val  -- float32 product
    terms = (lens.astype(np.uint32).astype(F32) * vals)[~excluded]
    return Pileup(ends, cov), terms.astype(F32)


def ctrl_frag_terms(start, end, count, chrom_len: int, bed: List[int]
                    ) -> np.ndarray:
    """calcFactor sweep for one chromosome (Genrich.c:1980-2046).

    Returns the ordered float32 terms ``(end-start)*val`` over saved
    intervals (breaks at entry positions in saved regions and at bed
    boundaries), for the caller's exact float64 accumulation.
    """
    if len(start) == 0:
        return np.zeros(0, F32)
    epos, evals = _nonzero_entries(start, end, count)
    save_at = ~_excluded_mask(epos - 1, bed)
    ends, vals, excluded = _merge_breaks(epos, evals, chrom_len, bed,
                                         entry_break_mask=save_at)
    starts = np.concatenate([[0], ends[:-1]])
    lens = (ends - starts).astype(np.int64)
    terms = (lens.astype(np.uint32).astype(F32) * vals)[~excluded]
    return terms.astype(F32)


def ctrl_pileup(start, end, count, chrom_len: int, bed: List[int],
                factor: np.float32, lam: np.float32) -> Pileup:
    """savePileupCtrl sweep for one chromosome (Genrich.c:2052-2161).

    Values are max(factor*val, lambda) in float32; breaks occur at -E
    boundaries and where that max *changes* within saved regions;
    excluded intervals carry SKIP.
    """
    epos, evals = _nonzero_entries(start, end, count)
    scaled = (F32(factor) * evals).astype(F32)
    net = np.maximum(scaled, F32(lam))
    # value on the interval *ending* at an entry position j is the net
    # from before j; break iff previous net != net after entry at j.
    prev_net = np.concatenate([[F32(lam)], net[:-1]]).astype(F32)
    changes = net != prev_net
    save_at = ~_excluded_mask(epos - 1, bed)

    ends, vals, excluded = _merge_breaks(epos, net, chrom_len, bed,
                                         entry_break_mask=(changes
                                                           & save_at))
    # intervals that start before the first entry carry lambda
    first = epos[0] if len(epos) else chrom_len
    starts = np.concatenate([[0], ends[:-1]])
    vals = np.where(starts < first, F32(lam), vals).astype(F32)
    cov = np.where(excluded, SKIP, vals).astype(F32)
    return Pileup(ends, cov)


def const_pileup(chrom_len: int, val: np.float32) -> Pileup:
    """saveConst (Genrich.c:1801-1811)."""
    return Pileup(np.array([chrom_len], np.int64),
                  np.array([val], F32))


def lambda_pileup(chrom_len: int, bed: List[int],
                  lam: np.float32) -> Pileup:
    """saveLambda (Genrich.c:1838-1877): alternate lambda/SKIP runs."""
    if not bed:
        return const_pileup(chrom_len, lam)
    bounds = [b for b in bed if 0 < b < chrom_len]
    ends = np.asarray(bounds + [chrom_len], np.int64)
    starts = np.concatenate([[0], ends[:-1]])
    excluded = _excluded_mask(starts, bed)
    cov = np.where(excluded, SKIP, F32(lam)).astype(F32)
    return Pileup(ends, cov)


def exact_sum_f64(terms: np.ndarray) -> float:
    """Sequential left-to-right float64 accumulation of float32 terms.

    Matches C's ``double += float`` loop exactly (numpy's pairwise sum
    does not).  Uses the native helper when built; Python fallback.
    """
    from ..ingest.native import exact_sum_f32
    total = exact_sum_f32(terms)
    if total is not None:
        return total
    total = 0.0
    for t in terms.astype(np.float64):
        total += t
    return total


def calc_lambda(frag_len: float, genome_len: int) -> np.float32:
    """calcLambda (Genrich.c:1817-1832): float(fragLen / genomeLen)."""
    return F32(frag_len / genome_len)


def calc_factor(frag_len: float, ctrl_frag: float) -> np.float32:
    """calcFactor tail (Genrich.c:2043-2045)."""
    if ctrl_frag == 0.0:
        return F32(1.0)
    return F32(frag_len / ctrl_frag)
