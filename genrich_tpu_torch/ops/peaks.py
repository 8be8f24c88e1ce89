"""Peak calling by masked scans (twin of ops/peaks_jax.py).

callPeaks (Genrich.c:977-1069) in two steps.  ``peak_candidates``, the
gap-join: a significant interval joins the previous one iff the gap is
within maxGap and no SKIP interval lies between; connected components
are peaks, and each candidate is its first row and last significant
row, compacted in genomic order at the end of K slots.  Kernel K5
(``csrc/gapjoin.cu``: one launch per call, persistent blocks fed by TMA
bulk copies, one pass with decoupled look-back, the K slots placed by
the last block) on CUDA tensors; its plain version, for CPU tensors, is
the JAX twin's masked scans (``cummax``, ``cumsum``) and ``topk``.

Each peak's AUC and summit come from ``peak_reduce``: kernel K4
(``csrc/peaks.cu``) on CUDA tensors, which walks each peak's rows in
order and sums AUC in float32 in the exact engine's order, so a run
gives the same bytes every time.  Its plain version, for CPU tensors,
takes AUC as a difference of float64 prefix sums rounded to float32,
and the summit by segmented arg-maxima over the candidates' row ranges
with ``scatter_reduce`` (the JAX twin uses two lexicographic sorts;
torch has no multi-key sort).  Both keep the tie rules of updatePeak
(Genrich.c:948-964): the summit *position* goes to max stat, then
longest, then earliest; the summit p/q come from the *first* max-stat
row.
"""

from __future__ import annotations

from typing import Dict, List, NamedTuple, Tuple

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


def peak_reduce_plain(starts, ends, stat, pval, qval, sig, first, last,
                      min_pq):
    """Plain PyTorch version of kernel K4 (see ``peak_reduce``)."""
    m = starts.shape[0]
    k = first.shape[0]
    idx = torch.arange(m, dtype=torch.int64, device=starts.device)
    lens = ends - starts
    contrib = torch.where(sig, lens.to(torch.float32) * (stat - min_pq),
                          torch.zeros_like(stat))
    csum = torch.cumsum(contrib.to(torch.float64), dim=0)
    zero = torch.zeros_like(csum[:1])
    csum0 = torch.cat([zero, csum])           # csum0[i] = sum of rows < i
    auc = (csum0[last + 1] - csum0[first]).to(torch.float32)

    # segmented arg-maxima: segment j + 1 holds the rows from the j-th
    # real candidate's first row to the next one's (the candidates are
    # consecutive peaks, so every sig row there is that peak's); segment
    # 0 holds the rows before the first and is never read
    ex = last >= first
    mark = torch.zeros(m + 1, dtype=torch.int64, device=starts.device)
    mark.scatter_add_(0, torch.where(ex, first, torch.full_like(first, m)),
                      ex.to(torch.int64))
    seg = torch.cumsum(mark[:m], dim=0)
    n_seg = k + 1
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
    # the row columns take 16-byte loads, sig 4-byte ones
    args = [kernels.aligned(t.contiguous(), 16)
            for t in (starts, ends, stat, pval, qval)]
    args.append(kernels.aligned(sig.contiguous().view(torch.uint8), 4))
    first = first.contiguous()
    last = last.contiguous()
    with torch.cuda.device(dev):
        lib = kernels.library()
        # the six outputs, rows of one allocation (the last two int32)
        buf = torch.empty((6, k), dtype=torch.float32, device=dev)
        rows = [buf.data_ptr() + 4 * k * i for i in range(6)]
        rc = lib.peak_reduce_launch(
            *(t.data_ptr() for t in args), first.data_ptr(),
            last.data_ptr(), starts.shape[0], k,
            float(np.float32(min_pq)), *rows, kernels.stream_of(starts))
        kernels.check(rc, "peak_reduce")
    kernels.count("peak_reduce", dev)
    auc, max_stat, spv, sqv = buf[:4].unbind(0)
    spos, slen = buf[4:].view(torch.int32).unbind(0)
    return auc, max_stat, spv, sqv, spos, slen


def peak_reduce(starts, ends, stat, pval, qval, sig, first, last,
                min_pq):
    """Per-peak AUC and summit over rows in genomic order.

    Rows: starts/ends int32 [M], stat/pval/qval f32 [M], sig bool [M]
    (live, non-empty and above ``min_pq``).  Candidates: first/last
    int64 [K], consecutive peaks in genomic order (``peak_candidates``),
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
    return peak_reduce_plain(starts, ends, stat, pval, qval, sig, first,
                             last, min_pq)


class PeakRows(NamedTuple):
    sig: torch.Tensor      # bool [M]: live, non-empty, above min_pq
    skp: torch.Tensor      # bool [M]: live SKIP rows
    first: torch.Tensor    # int64 [K]: each candidate's first row, 0 if none
    last: torch.Tensor     # int64 [K]: its last sig row, -1 if none
    exists: torch.Tensor   # bool [K]: a real candidate
    n: torch.Tensor        # int64 []: every candidate, also past K


def peak_candidates_plain(starts, ends, stat, live, min_pq, max_gap,
                          k_peaks: int) -> PeakRows:
    """Plain PyTorch version of kernel K5 (see ``peak_candidates``):
    the JAX twin's masked scans, with the candidates compacted by
    ``topk``."""
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

    # an empty slot's row is any of topk's ties: it gets (0, -1)
    fi = torch.where(exists, first_idx[rows].clamp(0, m - 1), 0)
    li = torch.where(exists, lastsig_inc[rows].clamp(0, m - 1), -1)
    return PeakRows(sig, skp, fi, li, exists,
                    torch.clamp_min(pid[-1] + 1, 0))


# K5's zeroed scratch (its tile counter, done counter and the tiles'
# flags) per (device index, stream): a call leaves it zeroed for the next
# call on its stream, so no call clears it, and two streams never share
# one.  A scratch that grows keeps the smaller ones alive, so a CUDA graph
# captured on one stays valid.
SCRATCH: Dict[Tuple[int, int], List[torch.Tensor]] = {}


def _gap_join_state(lib, dev, stream: int, m: int) -> torch.Tensor:
    """The scratch of the calls on ``stream``, at least K5's size for m
    rows (a power of two of int32s); a new one is zeroed on the stream."""
    need = lib.gap_join_state_ints(m)
    held = SCRATCH.setdefault((dev.index, stream), [])
    if not held or held[-1].numel() < need:
        held.append(torch.zeros(1 << (need - 1).bit_length(),
                                dtype=torch.int32, device=dev))
    return held[-1]


def _gap_join_cuda(starts, ends, stat, live, min_pq, max_gap, k, lib=None):
    """Launch csrc/gapjoin.cu on the card (see its header); ``lib``, a
    build of it (default ``kernels.library()``)."""
    m = starts.shape[0]
    dev = starts.device
    # the columns take bulk copies of 16-byte aligned ranges
    args = [kernels.aligned(t.contiguous(), 16) for t in (starts, ends, stat)]
    args.append(kernels.aligned(live.contiguous().view(torch.uint8), 16))
    with torch.cuda.device(dev):
        lib = lib or kernels.library()
        stream = kernels.stream_of(starts)
        sig = torch.empty(m, dtype=torch.uint8, device=dev)
        skp = torch.empty(m, dtype=torch.uint8, device=dev)
        cand = torch.empty((2, k), dtype=torch.int64, device=dev)
        exists = torch.empty(k, dtype=torch.uint8, device=dev)
        n = torch.empty((), dtype=torch.int64, device=dev)
        pairs = torch.empty(2 * m, dtype=torch.int32, device=dev)
        state = _gap_join_state(lib, dev, stream.value or 0, m)
        rc = lib.gap_join_launch(
            *(t.data_ptr() for t in args), m, float(np.float32(min_pq)),
            int(max_gap), k, sig.data_ptr(), skp.data_ptr(),
            cand[0].data_ptr(), cand[1].data_ptr(), exists.data_ptr(),
            n.data_ptr(), state.data_ptr(), pairs.data_ptr(), stream)
        kernels.check(rc, "gap_join")
    kernels.count("gap_join", dev)
    return PeakRows(sig.view(torch.bool), skp.view(torch.bool), cand[0],
                    cand[1], exists.view(torch.bool), n)


def peak_candidates(starts, ends, stat, live, min_pq, max_gap,
                    k_peaks: int) -> PeakRows:
    """The gap-join of call_peaks: each row's flags and the candidates.

    Rows in genomic order: starts/ends int32 [M], stat f32 [M], live
    bool [M]; a significant row's end is not below an earlier one's.
    The last min(n, K) candidates, K = min(k_peaks, M), fill the end of
    the K slots in genomic order, empty slots (0, -1) before them; ``n``
    counts every candidate, so a caller sees that the cap dropped some.
    Kernel K5 on CUDA tensors, the plain version on CPU tensors; both
    give the same bits.
    """
    for t, dt in ((starts, torch.int32), (ends, torch.int32),
                  (stat, torch.float32), (live, torch.bool)):
        if t.dtype != dt or t.dim() != 1 or t.shape != starts.shape:
            raise TypeError("peak_candidates takes int32 starts/ends, f32 "
                            "stat and bool live, all [M]")
        if t.device != starts.device:
            raise ValueError("peak_candidates inputs must share a device")
    if starts.device.type == "cuda":
        return _gap_join_cuda(starts, ends, stat, live, min_pq, max_gap,
                              min(k_peaks, starts.shape[0]))
    if starts.device.type != "cpu":
        raise ValueError(f"unsupported device {starts.device}")
    return peak_candidates_plain(starts, ends, stat, live, min_pq, max_gap,
                                 k_peaks)


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
    sig, skp, fi, li, exists, n = peak_candidates(
        starts, ends, stat, live, min_pq, max_gap, k_peaks)
    p_start = starts[fi]
    p_end = ends[li.clamp(0, m - 1)]
    (auc, max_stat, summit_pval, summit_qval, summit_pos,
     summit_len) = peak_reduce(starts, ends, stat, pval, qval, sig, fi, li,
                               min_pq)

    valid = (exists & (auc >= min_auc) & ((p_end - p_start) >= min_len))

    # boundary metadata (kept for parity with the JAX twin's record)
    idx = torch.arange(m, dtype=torch.int64, device=starts.device)
    any_sig = sig.any()
    sig_i = sig.to(torch.int32)
    first_sig = torch.argmax(sig_i)
    last_sig = m - 1 - torch.argmax(torch.flip(sig_i, dims=[0]))
    skip_head = (skp & (idx < first_sig)).any() & any_sig
    skip_tail = (skp & (idx > last_sig)).any() & any_sig

    n_peaks = n.to(torch.int32)
    return TilePeaks(p_start, p_end, auc, summit_pval, summit_qval,
                     summit_pos, valid, exists, max_stat, summit_len,
                     skip_head, skip_tail, n_peaks)
