"""Device-side compaction (twin of ops/compact_jax.py, main-path part).

Plain PyTorch: ``torch.sort``, ``cumsum``, ``cummax`` and
``searchsorted`` stand in for the XLA programs the JAX package left to
the compiler.  Shapes stay static (a full-width array plus a live count
tensor), so nothing here waits for the card; the engine pulls counts
and slices in batched fetches.
"""

from __future__ import annotations

import torch

SKIP = -1.0


def compact(mask, arrays):
    """Pack rows where ``mask`` to the front, preserving order.

    Returns (packed arrays tuple, live count as a 0-dim tensor).  Rows
    past the count are unspecified.
    """
    order = torch.sort((~mask).to(torch.uint8), stable=True).indices
    return (tuple(a[order] for a in arrays),
            mask.sum(dtype=torch.int32))


def rle_pv(starts, ends, pv, live, chrom_len):
    """p-value-only RLE coalescing with sentinel padding.

    Drops zero-length and dead rows, breaks runs where -log10 p
    changes and keeps each run's last end.  Rows beyond the run count
    are (chrom_len, SKIP).  Returns (run_ends, run_pv, n_runs).
    """
    real = live & (ends > starts)
    (e_p, pv_p), r = compact(real, (ends, pv))
    n = e_p.shape[0]
    idx = torch.arange(n, dtype=torch.int32, device=ends.device)
    nxt_diff = torch.cat([pv_p[1:] != pv_p[:-1],
                          torch.ones(1, dtype=torch.bool,
                                     device=ends.device)])
    last = (idx < r) & (nxt_diff | (idx == r - 1))
    (e_b, pv_b), b = compact(last, (e_p, pv_p))
    valid = idx < b
    e_b = torch.where(valid, e_b, torch.full_like(e_b, int(chrom_len)))
    pv_b = torch.where(valid, pv_b, torch.full_like(pv_b, SKIP))
    return e_b, pv_b, b


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
