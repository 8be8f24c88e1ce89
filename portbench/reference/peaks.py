"""Genrich's peak calling over one chromosome, in plain PyTorch.

An interval is significant when its statistic (-log10 q with -q, else
-log10 p) exceeds the threshold.  Consecutive significant intervals
form a site; a site joins the previous one when the distance between
them is at most ``max_gap`` and no excluded (SKIP) interval lies
between.  A peak's area is the sum over its significant intervals of
length * (statistic - threshold); its summit statistics are those of
the first interval with the peak's highest statistic, and its summit
position is the midpoint of the first of the longest intervals with
that statistic.  A peak is reported when its area is at least
``min_auc`` and its length at least ``min_len``.

Beside each peak, its near ties: every significant interval whose
statistic lies within ``TIE`` (relative) of the peak's top, with its
p and q.  A program that computes the statistics in float32 may take
any of them as the summit.
"""

from __future__ import annotations

import torch

F32 = torch.float32
I64 = torch.int64
SKIP = -1.0
TIE = 1e-5      # relative: float32 statistics a program computes differ
                # from these by about 1e-6


def call(ends, stat, pval, qval, thr, min_auc, min_len, max_gap,
         prec=F32):
    """Peaks of one chromosome from its intervals (``ends`` int64,
    ``stat``/``pval``/``qval`` float32, ``qval`` None without -q).
    Returns a dict of tensors: start, end, auc (float64), pval, qval,
    summit (offset from start)."""
    dev = ends.device
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    sig = stat > thr
    idx = torch.nonzero(sig).flatten()
    if idx.numel() == 0:
        z = torch.zeros(0, dtype=I64, device=dev)
        return {"start": z, "end": z, "auc": z.to(torch.float64),
                "pval": z.to(F32), "qval": z.to(F32), "summit": z,
                "tie_peak": z, "tie_start": z, "tie_end": z,
                "tie_p": z.to(F32), "tie_q": z.to(F32)}
    new_run = torch.cat([torch.ones(1, dtype=torch.bool, device=dev),
                         idx[1:] - idx[:-1] > 1])
    run_of = torch.cumsum(new_run.to(I64), 0) - 1
    first = idx[new_run]
    last = idx[torch.cat([new_run[1:], torch.ones(1, dtype=torch.bool,
                                                  device=dev)])]
    skips = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                       torch.cumsum((stat == SKIP).to(I64), 0)])
    join = ((starts[first[1:]] - ends[last[:-1]]) <= max_gap) \
        & (skips[first[1:]] == skips[last[:-1] + 1])
    group_of_run = torch.cat([torch.zeros(1, dtype=I64, device=dev),
                              torch.cumsum((~join).to(I64), 0)])
    g = group_of_run[run_of]                   # group of each sig interval
    n = int(g[-1]) + 1
    lens = (ends[idx] - starts[idx])
    s = stat[idx]
    term = lens.to(F32) * (s - thr).to(prec).to(F32)
    auc = torch.zeros(n, dtype=torch.float64, device=dev).index_add_(
        0, g, term.to(torch.float64))
    auc = auc.to(prec).to(torch.float64)
    p_start = torch.full((n,), 2 ** 62, dtype=I64, device=dev) \
        .scatter_reduce_(0, g, starts[idx], "amin")
    p_end = torch.zeros(n, dtype=I64, device=dev) \
        .scatter_reduce_(0, g, ends[idx], "amax")
    top = torch.full((n,), -2.0, dtype=F32, device=dev) \
        .scatter_reduce_(0, g, s, "amax")
    at_top = s == top[g]
    pos = torch.arange(idx.numel(), device=dev)
    first_top = torch.full((n,), idx.numel(), dtype=I64, device=dev) \
        .scatter_reduce_(0, g, torch.where(at_top, pos, pos.new_full(
            pos.shape, idx.numel())), "amin")
    # the first of the longest top intervals: the largest key
    key = torch.where(at_top, (lens << 32) | (0xFFFFFFFF - pos),
                      torch.full_like(lens, -1))
    best = torch.full((n,), -1, dtype=I64, device=dev) \
        .scatter_reduce_(0, g, key, "amax")
    bi = idx[0xFFFFFFFF - (best & 0xFFFFFFFF)]
    summit = (starts[bi] + ends[bi]) // 2 - p_start
    fi = idx[first_top]
    qv = qval if qval is not None else torch.full_like(pval, SKIP)
    out = {"start": p_start, "end": p_end, "auc": auc, "pval": pval[fi],
           "qval": qv[fi], "summit": summit}
    keep = (auc >= float(min_auc)) & ((p_end - p_start) >= min_len)
    out = {k: v[keep] for k, v in out.items()}
    # near ties: the intervals whose statistic is within TIE of the
    # peak's top, any of which a float32 program may take as its summit
    near = s >= top[g] - TIE * torch.abs(top[g])
    new_id = torch.cumsum(keep.to(I64), 0) - 1
    near &= keep[g]
    ni = idx[near]
    out.update(tie_peak=new_id[g[near]], tie_start=starts[ni],
               tie_end=ends[ni], tie_p=pval[ni], tie_q=qv[ni])
    return out
