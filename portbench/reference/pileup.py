"""Pileups from fragment events, in plain PyTorch.

An event (start, end, N) adds 1/N of a read over [start, end): N is the
number of loci its template aligned to, one of 1, 2, 3, 4, 5, 6, 8 or
10 in Genrich.  120 is a common multiple of all of them, so 120 times
the pileup is an integer (its "level") and two positions have the same
pileup exactly when their levels are equal.  Genrich keeps the value
as a whole part plus independent residues of eighths (below a half),
halves, sixths (below a half) and tenths (below a half), and reads it
as ``(float)whole + e/8.0f + s/6.0f + t/10.0f`` in float32 (getVal);
``value`` turns a level into that float32.

An exclusion list is a flat sorted tensor [s0, e0, s1, e1, ...] of
merged -E regions; a coordinate lies inside one when an odd number of
its entries are at or below it.
"""

from __future__ import annotations

import torch

I64 = torch.int64
F32 = torch.float32
SKIP = -1.0
_W120 = {1: 120, 2: 60, 3: 40, 4: 30, 5: 24, 6: 20, 8: 15, 10: 12}


def weights(count):
    """120 / N per event, int64."""
    table = torch.zeros(11, dtype=I64, device=count.device)
    for n, w in _W120.items():
        table[n] = w
    return table[count.long()]


def changes(start, end, count):
    """(positions, level after each) where the pileup changes: sorted,
    distinct positions and the level from each up to the next."""
    w = weights(count)
    pos = torch.cat([start, end])
    delta = torch.cat([w, -w])
    pos, order = torch.sort(pos)
    upos, inv = torch.unique_consecutive(pos, return_inverse=True)
    agg = torch.zeros(upos.shape[0], dtype=I64, device=pos.device)
    agg.index_add_(0, inv, delta[order])
    level = torch.cumsum(agg, 0)
    keep = agg != 0
    return upos[keep], level[keep]


def value(level, prec=F32):
    """Genrich's float32 pileup value of an int64 level, rounded to
    ``prec`` (float32, or a lower precision for the control)."""
    c = torch.remainder(2 * level, 3)                # sixths residue
    t = torch.remainder(3 * level, 5)                # tenths residue
    q = torch.div(level - 20 * c - 12 * t, 15, rounding_mode="floor")
    e = torch.remainder(q, 8)                        # eighths with the half
    whole = torch.div(q, 8, rounding_mode="floor")
    v = whole.to(F32) + e.to(F32) / 8.0
    v = v + c.to(F32) / 6.0
    v = v + t.to(F32) / 10.0
    return v.to(prec).to(F32)


def inside(x, bed):
    """True where coordinate ``x`` lies in a region of ``bed``."""
    if bed.numel() == 0:
        return torch.zeros_like(x, dtype=torch.bool)
    return torch.remainder(torch.searchsorted(bed, x, right=True), 2) == 1


def bed_breaks(bed, length):
    return bed[(bed > 0) & (bed < length)]


def intervals(pos, level, length, bed, breaks=None):
    """Intervals of a chromosome that break at the -E boundaries and at
    the change positions outside exclusions (those of ``breaks``, a
    mask over ``pos``, when given).  Returns (starts, ends, the level
    over each, excluded)."""
    keep = (pos > 0) & (pos < length) & ~inside(pos - 1, bed)
    if breaks is not None:
        keep &= breaks
    ends = torch.unique(torch.cat([pos[keep], bed_breaks(bed, length)]))
    ends = torch.cat([ends, torch.tensor([length], dtype=I64,
                                         device=pos.device)])
    starts = torch.cat([ends.new_zeros(1), ends[:-1]])
    idx = torch.searchsorted(pos, ends) - 1        # last change below end
    lev = torch.where(idx >= 0, level[idx.clamp_min(0)],
                      torch.zeros_like(idx))
    return starts, ends, lev, inside(starts, bed)


def frag_sum(starts, ends, val, excluded):
    """Sum of float32 len * value over the intervals outside exclusions,
    each product rounded to float32, summed in float64 (Genrich's
    fragment length of a sample: the numerator of lambda)."""
    terms = (ends - starts).to(F32) * val
    return float(torch.where(excluded, torch.zeros_like(terms), terms)
                 .to(torch.float64).sum())


def treatment(ev, length, bed, prec=F32):
    """Treatment pileup of one chromosome: (ends, value with 0 inside
    exclusions, fragment sum)."""
    if ev is None:
        ends = torch.tensor([length], dtype=I64, device=bed.device)
        return ends, torch.zeros(1, dtype=F32, device=bed.device), 0.0
    pos, level = changes(*ev)
    starts, ends, lev, ex = intervals(pos, level, length, bed)
    val = value(lev, prec)
    return (ends, torch.where(ex, torch.zeros_like(val), val),
            frag_sum(starts, ends, val, ex))


def control_sum(ev, length, bed, prec=F32):
    """A control's fragment sum on one chromosome (the denominator of
    the scaling factor)."""
    if ev is None:
        return 0.0
    pos, level = changes(*ev)
    starts, ends, lev, ex = intervals(pos, level, length, bed)
    return frag_sum(starts, ends, value(lev, prec), ex)


def control(ev, length, bed, factor, lam, prec=F32):
    """Control pileup of one chromosome: max(factor * value, lambda) in
    float32, breaking where that changes; SKIP inside exclusions;
    lambda alone where the control has no events."""
    dev = bed.device
    if ev is None:
        ends = torch.unique(torch.cat([bed_breaks(bed, length), torch.tensor(
            [length], dtype=I64, device=dev)]))
        starts = torch.cat([ends.new_zeros(1), ends[:-1]])
        cov = torch.full(ends.shape, lam, dtype=F32, device=dev)
        return ends, torch.where(inside(starts, bed),
                                 torch.full_like(cov, SKIP), cov)
    pos, level = changes(*ev)
    net = torch.clamp_min(torch.tensor(factor, dtype=F32, device=dev)
                          * value(level, prec),
                          torch.tensor(lam, dtype=F32, device=dev))
    net = net.to(prec).to(F32)
    prev = torch.cat([net.new_full((1,), lam), net[:-1]])
    starts, ends, _, ex = intervals(pos, level, length, bed,
                                    breaks=net != prev)
    idx = torch.searchsorted(pos, ends) - 1
    cov = torch.where(idx >= 0, net[idx.clamp_min(0)],
                      torch.full_like(ends, 0, dtype=F32) + lam)
    return ends, torch.where(ex, torch.full_like(cov, SKIP), cov)


def merge(ends_a, val_a, ends_b, val_b):
    """Two step functions over one chromosome on the union of their
    breakpoints: (ends, value of a, value of b)."""
    ends = torch.unique(torch.cat([ends_a, ends_b]))
    return (ends, val_a[torch.searchsorted(ends_a, ends)],
            val_b[torch.searchsorted(ends_b, ends)])
