"""Device-side compaction (twin of ops/compact_jax.py).

Plain PyTorch: ``torch.sort``, ``cumsum``, ``cummax`` and
``searchsorted`` stand in for the XLA programs the JAX package left to
the compiler; ``merge_fisher`` combines through kernel K3
(``ops/chisq.fisher_combine``).  Shapes stay static (a full-width array
plus a live count tensor), so nothing here waits for the card; the
engine pulls counts and slices in batched fetches.
"""

from __future__ import annotations

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
    count).  SKIP intervals and zero-length rows carry no weight and
    sort to +inf.  Per-chromosome bp sums are below 2^31.
    """
    lens = ends - starts
    real = live & (lens > 0) & (pv != SKIP)
    key = torch.where(real, pv, torch.full_like(pv, float("inf")))
    w = torch.where(real, lens, torch.zeros_like(lens)).to(torch.int64)
    key_s, order = torch.sort(key)
    cum = torch.cumsum(w[order], dim=0)
    dev = pv.device
    is_last = torch.cat([key_s[1:] != key_s[:-1],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    run_end = torch.cummax(torch.where(is_last, cum,
                                       torch.zeros_like(cum)), dim=0)
    prev = torch.cat([torch.zeros(1, dtype=cum.dtype, device=dev),
                      run_end.values[:-1]])
    run_w = (cum - prev).to(torch.int32)
    keep = is_last & torch.isfinite(key_s)
    (pv_d, w_d), d = compact(keep, (key_s, run_w))
    return pv_d, w_d, d


def assign_qvals(pv, table_p, table_q):
    """Per-interval q from the (ascending p -> q) lookup table.

    saveQval's per-interval binary search (Genrich.c:196-206), left
    side; SKIP p-values keep SKIP.  ``table_p`` is padded with +inf.
    """
    idx = torch.searchsorted(table_p, pv.contiguous())
    idx = torch.clamp(idx, 0, table_p.shape[0] - 1)
    q = table_q[idx]
    return torch.where(pv == SKIP, torch.full_like(q, SKIP), q)
