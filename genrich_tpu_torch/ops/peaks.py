"""Peak calling by masked scans (twin of ops/peaks_jax.py).

callPeaks (Genrich.c:977-1069) as vectorised passes: a significant
interval joins the previous one iff the gap is within maxGap and no
SKIP interval lies between; connected components are peaks with
non-decreasing ids.  The gap-join scans are plain PyTorch.

Each peak's AUC and summit come from ``peak_reduce``: kernel K4
(``csrc/peaks.cu``) on CUDA tensors, which walks each peak's rows in
order and sums AUC in float32 in the exact engine's order, so a run
gives the same bytes every time.  Its plain version, for CPU tensors,
takes AUC as a difference of float64 prefix sums rounded to float32,
and the summit by segmented arg-maxima over the peak id with
``scatter_reduce`` (the JAX twin uses two lexicographic sorts; torch
has no multi-key sort).  Both keep the tie rules of updatePeak
(Genrich.c:948-964): the summit *position* goes to max stat, then
longest, then earliest; the summit p/q come from the *first* max-stat
row.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .. import kernels

SKIP = -1.0


class TilePeaks(NamedTuple):
    start: torch.Tensor       # int32 [K]
    end: torch.Tensor         # int32 [K]
    auc: torch.Tensor         # f32 [K]
    summit_pval: torch.Tensor
    summit_qval: torch.Tensor
    summit_pos: torch.Tensor  # int32 [K]
    valid: torch.Tensor       # bool [K]: candidate passing minAUC/minLen
    cand: torch.Tensor        # bool [K]: candidate before the filters
    summit_stat: torch.Tensor  # f32 [K]: max statistic
    summit_len: torch.Tensor   # int32 [K]: its interval length
    skip_head: torch.Tensor    # bool []: SKIP before the first site
    skip_tail: torch.Tensor    # bool []: SKIP after the last site
    n_peaks: torch.Tensor      # int32 []: total candidates (cap check)


def _shift_right(x, fill):
    """[fill, x[0], ..., x[-2]]."""
    return torch.cat([torch.full((1,), fill, dtype=x.dtype,
                                 device=x.device), x[:-1]])


def _seg_reduce(seg, src, n_seg, reduce, init):
    """Per-segment reduction of ``src`` by segment index ``seg``."""
    out = torch.full((n_seg,), init, dtype=src.dtype, device=src.device)
    return out.scatter_reduce(0, seg, src, reduce=reduce,
                              include_self=True)


def peak_reduce_plain(starts, ends, stat, pval, qval, sig, pid, first,
                      last, min_pq):
    """Plain PyTorch version of kernel K4 (see ``peak_reduce``)."""
    m = starts.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=starts.device)
    lens = ends - starts
    contrib = torch.where(sig, lens.to(torch.float32) * (stat - min_pq),
                          torch.zeros_like(stat))
    csum = torch.cumsum(contrib.to(torch.float64), dim=0)
    zero = torch.zeros_like(csum[:1])
    csum0 = torch.cat([zero, csum])           # csum0[i] = sum of rows < i
    auc = (csum0[last + 1] - csum0[first]).to(torch.float32)

    # segmented arg-maxima over seg = pid + 1 (segment 0 holds the rows
    # before the first peak and is never read)
    seg = pid + 1
    n_seg = m + 1
    stat_m = torch.where(sig, stat, torch.full_like(stat, -float("inf")))
    seg_max = _seg_reduce(seg, stat_m, n_seg, "amax", -float("inf"))
    at_max = sig & (stat_m == seg_max[seg])
    len_m = torch.where(at_max, lens.to(torch.int64),
                        torch.full_like(idx, -(1 << 40)))
    seg_len = _seg_reduce(seg, len_m, n_seg, "amax", -(1 << 40))
    big = torch.full_like(idx, m)
    best = _seg_reduce(seg, torch.where(at_max & (len_m == seg_len[seg]),
                                        idx, big), n_seg, "amin", m)
    first_best = _seg_reduce(seg, torch.where(at_max, idx, big), n_seg,
                             "amin", m)

    rseg = seg[last.clamp(0, m - 1)]
    pi = best[rseg].clamp(0, m - 1)
    pf = first_best[rseg].clamp(0, m - 1)
    # int64 midpoint: start + end overflows int32 past 2^30 bp (the JAX
    # twin's int32 sum wraps there)
    summit_pos = ((starts[pi].long() + ends[pi].long()) // 2
                  - starts[first].long()).to(torch.int32)
    return (auc, seg_max[rseg], pval[pf], qval[pf], summit_pos, lens[pi])


def _peak_reduce_cuda(starts, ends, stat, pval, qval, sig, first, last,
                      min_pq):
    """Launch csrc/peaks.cu on the card (see its header)."""
    k = first.shape[0]
    dev = starts.device
    args = [t.contiguous() for t in (starts, ends, stat, pval, qval)]
    sig = sig.contiguous().view(torch.uint8)
    first = first.contiguous()
    last = last.contiguous()
    with torch.cuda.device(dev):
        lib = kernels.library()
        f32 = [torch.empty(k, dtype=torch.float32, device=dev)
               for _ in range(4)]
        i32 = [torch.empty(k, dtype=torch.int32, device=dev)
               for _ in range(2)]
        rc = lib.peak_reduce_launch(
            *(kernels.ptr(t) for t in args), kernels.ptr(sig),
            kernels.ptr(first), kernels.ptr(last), k,
            float(np.float32(min_pq)),
            *(kernels.ptr(t) for t in f32 + i32),
            kernels.stream_of(starts))
        kernels.check(rc, "peak_reduce")
    kernels.LAUNCHES["peak_reduce"] += 1
    auc, max_stat, spv, sqv = f32
    spos, slen = i32
    return auc, max_stat, spv, sqv, spos, slen


def peak_reduce(starts, ends, stat, pval, qval, sig, pid, first, last,
                min_pq):
    """Per-peak AUC and summit over rows in genomic order.

    Rows: starts/ends int32 [M], stat/pval/qval f32 [M], sig bool [M]
    (live, non-empty and above ``min_pq``), pid int64 [M] (peak id,
    read by the plain version only).  Candidates: first/last int64 [K],
    each peak's first row and last significant row; last < first marks
    a candidate with no rows.  Returns (auc, max_stat, summit_pval,
    summit_qval, summit_pos, summit_len) [K]; summit_pos is relative
    to starts[first].  Kernel K4 on CUDA tensors, the plain version on
    CPU tensors.
    """
    for t, dt in ((starts, torch.int32), (ends, torch.int32),
                  (stat, torch.float32), (pval, torch.float32),
                  (qval, torch.float32), (sig, torch.bool),
                  (first, torch.int64), (last, torch.int64)):
        if t.dtype != dt or t.dim() != 1:
            raise TypeError("peak_reduce takes int32 starts/ends, f32 "
                            "stat/pval/qval, bool sig, int64 first/last")
        if t.device != starts.device:
            raise ValueError("peak_reduce inputs must share a device")
    if starts.device.type == "cuda":
        return _peak_reduce_cuda(starts, ends, stat, pval, qval, sig,
                                 first, last, min_pq)
    if starts.device.type != "cpu":
        raise ValueError(f"unsupported device {starts.device}")
    return peak_reduce_plain(starts, ends, stat, pval, qval, sig, pid,
                             first, last, min_pq)


class PeakRows(NamedTuple):
    sig: torch.Tensor      # bool [M]: live, non-empty, above min_pq
    skp: torch.Tensor      # bool [M]: live SKIP rows
    pid: torch.Tensor      # int64 [M]: peak id, -1 before the first
    first: torch.Tensor    # int64 [K]: each candidate's first row
    last: torch.Tensor     # int64 [K]: its last sig row; first - 1 if none
    exists: torch.Tensor   # bool [K]: a real candidate


def peak_candidates(starts, ends, stat, live, min_pq, max_gap,
                    k_peaks: int) -> PeakRows:
    """The gap-join of call_peaks: peak ids and each candidate's rows.

    Candidates are compacted with ``topk`` in genomic order at the END
    of the K = min(k_peaks, M) rows.
    """
    m = starts.shape[0]
    dev = starts.device
    idx = torch.arange(m, dtype=torch.int64, device=dev)
    lens = ends - starts
    live = live & (lens > 0)
    sig = live & (stat > min_pq)
    skp = live & (stat == SKIP)

    # previous significant interval's end / skip count at it
    neg = torch.full_like(ends, -1)
    prev_end = _shift_right(torch.cummax(torch.where(sig, ends, neg),
                                         dim=0).values, -1)
    has_prev = prev_end >= 0
    skip_cum = torch.cumsum(skp.to(torch.int64), dim=0)
    prev_sc = _shift_right(torch.cummax(
        torch.where(sig, skip_cum, torch.full_like(skip_cum, -1)),
        dim=0).values, -1)
    join = (sig & has_prev & (starts - prev_end <= max_gap)
            & (skip_cum - prev_sc == 0))
    new_peak = sig & ~join
    pid = torch.cumsum(new_peak.to(torch.int64), dim=0) - 1

    is_last = torch.cat([pid[:-1] != pid[1:],
                         torch.ones(1, dtype=torch.bool, device=dev)])
    exists_row = is_last & (pid >= 0)

    neg64 = torch.full_like(idx, -1)
    first_idx = torch.cummax(torch.where(new_peak, idx, neg64),
                             dim=0).values
    lastsig_inc = torch.cummax(torch.where(sig, idx, neg64), dim=0).values

    # compact the boundary rows: the k largest row indices, reversed
    k = min(k_peaks, m)
    score = torch.where(exists_row, idx, neg64).to(torch.int32)
    top, rows = torch.topk(score, k)
    rows = torch.flip(rows, dims=[0]).clamp(0, m - 1)
    exists = torch.flip(top, dims=[0]) >= 0

    fi = first_idx[rows].clamp(0, m - 1)
    li = torch.where(exists, lastsig_inc[rows].clamp(0, m - 1), fi - 1)
    return PeakRows(sig, skp, pid, fi, li, exists)


def call_peaks(starts, ends, stat, pval, qval, live, min_pq, min_auc,
               min_len, max_gap, k_peaks: int = 4096) -> TilePeaks:
    """Peak calling over one tile's intervals (rows in genomic order).

    live masks real intervals; zero-length intervals are ignored.
    Returns up to ``k_peaks`` peak rows, compacted with ``topk`` in
    genomic order at the END of the K rows; ``valid``/``cand`` mask the
    real ones.  ``n_peaks`` counts every candidate, so a caller can see
    that the cap dropped some.
    """
    m = starts.shape[0]
    sig, skp, pid, fi, li, exists = peak_candidates(
        starts, ends, stat, live, min_pq, max_gap, k_peaks)
    p_start = starts[fi]
    p_end = ends[li.clamp(0, m - 1)]
    (auc, max_stat, summit_pval, summit_qval, summit_pos,
     summit_len) = peak_reduce(starts, ends, stat, pval, qval, sig, pid,
                               fi, li, min_pq)

    valid = (exists & (auc >= min_auc) & ((p_end - p_start) >= min_len))

    # boundary metadata (kept for parity with the JAX twin's record)
    idx = torch.arange(m, dtype=torch.int64, device=starts.device)
    any_sig = sig.any()
    sig_i = sig.to(torch.int32)
    first_sig = torch.argmax(sig_i)
    last_sig = m - 1 - torch.argmax(torch.flip(sig_i, dims=[0]))
    skip_head = (skp & (idx < first_sig)).any() & any_sig
    skip_tail = (skp & (idx > last_sig)).any() & any_sig

    n_peaks = torch.clamp_min(pid[-1] + 1, 0).to(torch.int32)
    return TilePeaks(p_start, p_end, auc, summit_pval, summit_qval,
                     summit_pos, valid, exists, max_stat, summit_len,
                     skip_head, skip_tail, n_peaks)
