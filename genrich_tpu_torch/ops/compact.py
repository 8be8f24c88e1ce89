"""Device-side compaction (twin of ops/compact_jax.py).

Plain PyTorch: ``torch.sort``, ``cumsum`` and ``searchsorted`` stand
in for the XLA programs the JAX package left to the compiler;
``merge_fisher`` combines through kernel K3
(``ops/chisq.fisher_combine``).  ``pileup_runs``, which merges the
device's interval rows into the exact engine's intervals, is the port's
own: the JAX package keeps one row per event.  Shapes stay static (a
full-width array plus a live count tensor), so nothing here waits for
the card; the engine pulls counts and slices in batched fetches.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .chisq import fisher_combine

SKIP = -1.0


def compact(mask, arrays):
    """Pack rows where ``mask`` to the front, preserving order.

    Returns (packed arrays tuple, live count as a 0-dim tensor).  Rows
    past the count are unspecified.
    """
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    return (tuple(a[order] for a in arrays),
            mask.sum(dtype=torch.int32))


class Runs(NamedTuple):
    starts: torch.Tensor     # int32 [M]: the first piece's start
    ends: torch.Tensor       # int32 [M]: the last piece's end
    ev: torch.Tensor         # f32 [M]: expt value (last piece's)
    cr: torch.Tensor         # f32 [M]: raw control value (last piece's)
    excluded: torch.Tensor   # bool [M]
    level: torch.Tensor      # int64 [M]: 120 x the exact expt value
    net: torch.Tensor        # f32 [M]: max(factor * cr, lambda)
    n: torch.Tensor          # int32 []: intervals; later rows are dead
    n_rows: torch.Tensor     # int32 []: live non-empty rows merged


def pileup_runs(starts, ends, ev, cr, excluded, live, level, excl, lam,
                factor) -> Runs:
    """Interval rows -> the exact engine's intervals, maximal runs.

    ``tile_coverage`` keeps one row per event position, also where the
    pileup does not change (a fragment ends where another starts, a
    control event under lambda).  The exact engine's p-value intervals
    break only (savePileupExpt/Ctrl, savePval; ``engine/pileup.py``,
    ``engine/pvalue.py::merge_pileups``) at an -E boundary, or outside
    exclusions where the treatment's exact value changes or the
    control's float32 max(factor * raw, lambda) does.  A live non-empty
    row starts an interval iff its start is an -E coordinate (``excl``,
    tile_coverage's pairs), its ``excluded`` flag differs from the
    previous row's, or it is not excluded and its ``level`` (int64,
    ``tile_coverage(..., levels=True)``) or that control value differs.
    Each interval keeps its first piece's start and its last piece's
    end and values (every piece has the same expt value and the same
    control value).  Rows past ``n`` are dead, of length 0 at the last
    interval's end.  Plain PyTorch, nothing waits for the card.
    """
    net = torch.clamp_min(float(np.float32(factor)) * cr,
                          float(np.float32(lam)))
    flat = excl.reshape(-1).to(starts.dtype).contiguous()
    at = torch.searchsorted(flat, starts).clamp_max(flat.shape[0] - 1)
    bound = flat[at] == starts
    (s, e, v, c, x, w, t, b), r = compact(
        live & (ends > starts),
        (starts, ends, ev, cr, excluded, level, net, bound))
    m = s.shape[0]
    idx = torch.arange(m, dtype=torch.int32, device=s.device)

    def differs(a):
        return torch.cat([torch.ones(1, dtype=torch.bool, device=a.device),
                          a[1:] != a[:-1]])
    new = b | differs(x) | (~x & (differs(w) | differs(t)))
    nxt = torch.cat([new[1:], torch.ones(1, dtype=torch.bool,
                                         device=s.device)])
    last = (idx < r) & (nxt | (idx == r - 1))
    (e, v, c, x, w, t), n = compact(last, (e, v, c, x, w, t))
    s = torch.cat([s[:1], e[:-1]])
    dead = idx >= n
    fill = e[(n - 1).clamp_min(0)]
    s = torch.where(dead, fill, s)
    e = torch.where(dead, fill, e)
    return Runs(s, e, v, c, x, w, t, n, r)


def _run_ends(pv_p, r):
    """True at the last row of each equal-p run among the first r."""
    n = pv_p.shape[0]
    dev = pv_p.device
    idx = torch.arange(n, dtype=torch.int32, device=dev)
    nxt_diff = torch.cat([pv_p[1:] != pv_p[:-1],
                          torch.ones(1, dtype=torch.bool, device=dev)])
    return (idx < r) & (nxt_diff | (idx == r - 1))


def rle_runs(starts, ends, pv, ev, cr, excluded, live, lam, factor):
    """RLE runs of -log10 p with each run's expt/ctrl values.

    Drops zero-length and dead rows, breaks runs where -log10 p
    changes, and records the boundary row's expt and ctrl values by
    savePileupCtrl/savePval (Genrich.c:2052-2161, 1720-1794): ctrl =
    max(factor * raw, lambda), SKIP inside exclusions; expt = 0 inside
    exclusions.  Returns (run_ends, run_pv, run_expt, run_ctrl,
    n_runs); rows past the count are unspecified.
    """
    real = live & (ends > starts)
    (e_p, pv_p, ev_p, cr_p, ex_p), r = compact(
        real, (ends, pv, ev, cr, excluded))
    last = _run_ends(pv_p, r)
    ctrl_v = torch.where(ex_p, torch.full_like(cr_p, SKIP),
                         torch.clamp_min(float(factor) * cr_p,
                                         float(lam)))
    expt_v = torch.where(ex_p, torch.zeros_like(ev_p), ev_p)
    (e_b, pv_b, ev_b, cv_b), b = compact(last, (e_p, pv_p, expt_v, ctrl_v))
    return e_b, pv_b, ev_b, cv_b, b


def rle_pv(starts, ends, pv, live, chrom_len):
    """p-value-only RLE coalescing with sentinel padding.

    Drops zero-length and dead rows, breaks runs where -log10 p
    changes and keeps each run's last end.  Rows beyond the run count
    are (chrom_len, SKIP).  Returns (run_ends, run_pv, n_runs).
    """
    real = live & (ends > starts)
    (e_p, pv_p), r = compact(real, (ends, pv))
    (e_b, pv_b), b = compact(_run_ends(pv_p, r), (e_p, pv_p))
    idx = torch.arange(e_b.shape[0], dtype=torch.int32, device=ends.device)
    valid = idx < b
    e_b = torch.where(valid, e_b, torch.full_like(e_b, int(chrom_len)))
    pv_b = torch.where(valid, pv_b, torch.full_like(pv_b, SKIP))
    return e_b, pv_b, b


def merge_fisher(ends_list, pv_list):
    """n-way merge of replicate p-value RLEs + Fisher combination.

    combinePval/multPval (Genrich.c:567-667): the merged breakpoints
    are the union of every replicate's run ends (one sort of their
    concatenation); each replicate gives its value over each merged
    interval (``searchsorted`` left, clipped), and kernel K3 combines
    them.  Padding rows (end == chrom_len, SKIP) merge into zero-length
    dead intervals.  Returns (starts, ends, combined_pv, live).
    """
    all_e = torch.sort(torch.cat(list(ends_list))).values
    vs = []
    for e_r, p_r in zip(ends_list, pv_list):
        idx = torch.searchsorted(e_r.contiguous(), all_e, side="left")
        vs.append(p_r[torch.clamp(idx, 0, e_r.shape[0] - 1)])
    comb = fisher_combine(torch.stack(vs))
    starts = torch.cat([torch.zeros(1, dtype=all_e.dtype,
                                    device=all_e.device), all_e[:-1]])
    return starts, all_e, comb, all_e > starts


def distinct_pvals(starts, ends, pv, live):
    """Distinct -log10 p values with summed bp lengths.

    hashPval/collectPval (Genrich.c:277-347): sort intervals by p,
    segment the equal-value runs, return (p ascending, int32 bp per p,
    count); rows past the count are unspecified.  SKIP intervals and
    zero-length rows carry no weight and sort to +inf.  Per-chromosome
    bp sums are below 2^31.
    """
    return _distinct_runs(starts, ends, pv, live, torch.int32)


def distinct_pvals_k(starts, ends, pv, live, k: int):
    """``distinct_pvals`` as a fixed-width [k] table (shard exchange).

    Returns (p [k], int64 bp [k], count): the first min(count, k) rows
    are the table, every later row is (+inf, 0), so tables of several
    ranks line up at a fixed stride.  count may exceed k: the caller
    checks and re-runs with a wider k, never truncating silently.  The
    bp sums are int64 (a rank's tiles are flattened into one call).
    """
    pv_d, w_d, d = _distinct_runs(starts, ends, pv, live, torch.int64)
    n = pv_d.shape[0]
    if n < k:
        pv_d = torch.cat([pv_d, pv_d.new_full((k - n,), float("inf"))])
        w_d = torch.cat([w_d, w_d.new_zeros(k - n)])
    pv_d, w_d = pv_d[:k], w_d[:k]
    tail = torch.arange(k, device=pv.device) >= d
    return (pv_d.masked_fill(tail, float("inf")), w_d.masked_fill(tail, 0),
            d)


def _distinct_runs(starts, ends, pv, live, dtype):
    """Rows sorted by p, each run of equal p compacted to its last row:
    (p, bp of the run as ``dtype``, count of the runs whose p is
    finite).  A run's bp is the difference between consecutive run
    ends of the cumulative bp; the finite runs come first (+inf sorts
    last), so the count's rows are the table."""
    lens = ends - starts
    real = live & (lens > 0) & (pv != SKIP)
    key = torch.where(real, pv, torch.full_like(pv, float("inf")))
    w = torch.where(real, lens, torch.zeros_like(lens)).to(torch.int64)
    key_s, order = torch.sort(key)
    cum = torch.cumsum(w[order], dim=0)
    is_last = torch.cat([key_s[1:] != key_s[:-1],
                         torch.ones(1, dtype=torch.bool, device=pv.device)])
    (key_r, cum_r), _ = compact(is_last, (key_s, cum))
    run_w = cum_r - torch.cat([cum_r.new_zeros(1), cum_r[:-1]])
    return (key_r, run_w.to(dtype),
            (is_last & torch.isfinite(key_s)).sum(dtype=torch.int32))


def assign_qvals(pv, table_p, table_q):
    """Per-interval q from the (ascending p -> q) lookup table.

    saveQval's per-interval binary search (Genrich.c:196-206), left
    side; SKIP p-values keep SKIP.  ``table_p`` is padded with +inf.
    """
    idx = torch.searchsorted(table_p, pv.contiguous())
    idx = torch.clamp(idx, 0, table_p.shape[0] - 1)
    q = table_q[idx]
    return torch.where(pv == SKIP, torch.full_like(q, SKIP), q)
