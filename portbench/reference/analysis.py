"""A whole Genrich analysis of one sample, in plain PyTorch.

What Genrich v0.6.2 computes after parsing its inputs, for each
replicate: the treatment pileup, lambda (the treatment's fragment sum
over the genome length outside exclusions), the control's scaling
factor (treatment over control fragment sums) and control pileup
max(factor * control, lambda) (lambda alone without a control), and
-log10 p per interval of the merged pileups.  Then, with several
replicates, Fisher's combination per interval; with -q,
Benjamini-Hochberg q-values over the genome's distinct p-values
weighted by their lengths; then peaks.

Computed per chromosome, one at a time, on whatever device the events
are given on: the caller runs it after the measured window, once the
program's state is freed.  ``prec`` is the precision values are stored
in: float32, as Genrich stores them, or bfloat16 for the control.
Nothing here imports the program under test.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from . import peaks, pileup
from .pvalue import FLT_MAX, SKIP, calc_pval_distinct, fisher_neglog10

F32 = torch.float32
I64 = torch.int64


def merge_bed(regions, length):
    """-E regions of one chromosome as a flat sorted list: sorted by
    start, ends clamped to the length, regions starting past the end
    dropped, overlapping or adjacent regions merged."""
    out = []
    for s, e in sorted((s, e) for s, e in regions if s < length):
        e = min(e, length)
        if out and s <= out[-1]:
            out[-1] = max(out[-1], e)
        else:
            out += [s, e]
    return out


def threshold(p):
    """-log10 of a -p/-q threshold as float32 (Genrich's cut)."""
    return float(np.float32(-math.log10(float(np.float32(p)))))


def _f32(x):
    return float(np.float32(x))


def _events(ev, dev):
    if ev is None or len(ev[0]) == 0:
        return None
    return tuple(torch.as_tensor(np.asarray(a), device=dev).to(I64)
                 for a in ev)


def replicate(chroms, treat, ctrl, dev, prec):
    """One replicate: {chrom name: (ends, -log10 p)}, lambda, factor.

    ``chroms``: (name, length, flat -E list) of every analysed
    chromosome; ``treat``/``ctrl``: {name: (start, end, count)} host
    arrays (``ctrl`` None without a control file)."""
    genome = sum(n - sum(b[1::2]) + sum(b[0::2]) for _, n, b in chroms)
    frag = cfrag = 0.0
    tr = {}
    for ci, n, b in chroms:
        bed = torch.tensor(b, dtype=I64, device=dev)
        ends, val, s = pileup.treatment(_events(treat.get(ci), dev), n,
                                        bed, prec)
        tr[ci] = (ends, val)
        frag += s
        if ctrl is not None:
            cfrag += pileup.control_sum(_events(ctrl.get(ci), dev), n, bed,
                                        prec)
    lam = _f32(frag / genome)
    factor = 1.0 if cfrag == 0.0 else _f32(frag / cfrag)
    out = {}
    for ci, n, b in chroms:
        bed = torch.tensor(b, dtype=I64, device=dev)
        cev = _events(ctrl.get(ci), dev) if ctrl is not None else None
        c_ends, c_val = pileup.control(cev, n, bed, factor, lam, prec)
        ends, ev, cv = pileup.merge(*tr.pop(ci), c_ends, c_val)
        out[ci] = (ends, calc_pval_distinct(ev, cv).to(prec).to(F32))
    return out, lam, factor


def combine(reps, prec):
    """Fisher's combination of replicates' {chrom: (ends, p)}."""
    out = {}
    for ci in reps[0]:
        live = [r[ci] for r in reps if ci in r]
        ends = torch.unique(torch.cat([e for e, _ in live]))
        total = torch.zeros(ends.shape, dtype=torch.float64,
                            device=ends.device)
        df = torch.zeros(ends.shape, dtype=I64, device=ends.device)
        for e, p in live:
            v = p[torch.searchsorted(e, ends)]
            ok = v != SKIP
            total += torch.where(ok, v.to(torch.float64),
                                 torch.zeros_like(total))
            df += 2 * ok
        comb = torch.full(ends.shape, SKIP, dtype=F32, device=ends.device)
        comb = torch.where(df == 2, total.to(F32), comb)
        many = df > 2
        comb = torch.where(many & (total == 0.0), total.to(F32), comb)
        sel = many & (total != 0.0)
        if bool(sel.any()):
            p = fisher_neglog10(total[sel], df[sel])
            p = torch.clamp_max(p, FLT_MAX).to(F32)
            comb[sel] = p
        out[ci] = (ends, comb.to(prec).to(F32))
    return out


def qvalues(final, genome, prec):
    """Benjamini-Hochberg over every distinct p-value weighted by its
    bp: q = p - log10(genome) + log10(1 + bp at larger p), made
    monotone from the largest p down and floored at 0 (float32).
    Returns (distinct p ascending, q)."""
    ps, ws = [], []
    for ends, p in final.values():
        lens = ends - torch.cat([ends.new_zeros(1), ends[:-1]])
        ok = p != SKIP
        ps.append(p[ok])
        ws.append(lens[ok])
    p = torch.cat(ps) + 0.0
    w = torch.cat(ws)
    up, inv = torch.unique(p, return_inverse=True)
    bp = torch.zeros(up.shape, dtype=I64, device=up.device) \
        .index_add_(0, inv, w)
    above = torch.flip(torch.cumsum(torch.flip(bp, [0]), 0), [0]) - bp
    k = (1 + above).to(F32)                      # Genrich's (float)k
    log_n = _f32(-math.log10(_f32(genome)))
    raw = (up + log_n) + torch.log10(k.to(torch.float64)).to(F32)
    q = torch.flip(torch.cummin(torch.flip(raw, [0]), 0).values, [0])
    return up, torch.clamp_min(q, 0.0).to(prec).to(F32)


def analyse(setup, sample, dev, prec=F32):
    """Peaks of one sample: {chrom name: peaks dict}, and per
    replicate (lambda, factor).

    ``setup``: the analysed chromosomes (name, length, flat -E list)
    and the thresholds (``thr``, ``qval``, ``min_auc``, ``min_len``,
    ``max_gap``); ``sample``: a list of replicates, each a pair of
    {chrom name: events} for the treatment and the control (None)."""
    chroms = setup["chroms"]
    reps, scalars = [], []
    for treat, ctrl in sample:
        out, lam, factor = replicate(chroms, treat, ctrl, dev, prec)
        reps.append(out)
        scalars.append((lam, factor))
    final = combine(reps, prec) if len(reps) > 1 else reps[0]
    genome = sum(n - sum(b[1::2]) + sum(b[0::2]) for _, n, b in chroms)
    table = qvalues(final, genome, prec) if setup["qval"] else None
    res = {}
    for ci, (ends, p) in final.items():
        q = None
        if table is not None:
            up, uq = table
            q = torch.where(p == SKIP, p,
                            uq[torch.searchsorted(up, p).clamp_max(
                                up.numel() - 1)])
        res[ci] = peaks.call(ends, q if q is not None else p, p, q,
                             setup["thr"], setup["min_auc"],
                             setup["min_len"], setup["max_gap"], prec)
    return res, scalars
