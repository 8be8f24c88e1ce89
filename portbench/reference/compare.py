"""The comparison that decides ``correct``: a narrowPeak file the
program wrote against the reference's peaks for the same sample.

Peaks are matched by (chromosome, start, end).  The numbers, each held
to its own limit from the configuration file:

- ``unmatched``: peaks in only one of the two sets, over the
  reference's peak count;
- ``auc_gap``: the largest relative gap of column 7 (area);
- ``p_gap``: the largest relative gap of column 8 (summit -log10 p);
- ``q_gap``: the largest relative gap of column 9 (summit -log10 q),
  with -q only;
- ``summit_moved``: the share of matched peaks whose summit (column 2
  plus column 10) lies in none of the peak's near-top intervals.

The gaps are taken over matched peaks.  A summit is any of the peak's
near ties (``peaks.TIE``): its p and q are compared with the nearest of
theirs, its position with their extents.  An interval with a statistic
equal to the top may be merged with a neighbour of the same statistic
by a program, so the summit's midpoint is only held to lie in one.
"""

from __future__ import annotations

import numpy as np


def parse(text):
    """narrowPeak text -> {chrom: (start, end, auc, p, q, summit)}."""
    rows = {}
    for line in text.splitlines():
        f = line.split("\t")
        rows.setdefault(f[0], []).append(
            (int(f[1]), int(f[2]), float(f[6]), float(f[7]), float(f[8]),
             int(f[9])))
    return {c: tuple(np.array(col) for col in zip(*r))
            for c, r in rows.items()}


def _gap(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-30)


def compare(got, want, use_q):
    """Numbers of one program output ``got`` (``parse``d) against the
    reference's ``want`` ({chrom: peaks dict of numpy arrays})."""
    n_ref = n_only = n_match = moved = 0
    gaps = {"auc_gap": 0.0, "p_gap": 0.0, "q_gap": 0.0}
    for chrom in set(got) | set(want):
        w = want.get(chrom)
        g = got.get(chrom)
        wk = {} if w is None else {
            (int(s), int(e)): i for i, (s, e) in enumerate(
                zip(w["start"], w["end"]))}
        n_ref += len(wk)
        if g is None:
            n_only += len(wk)
            continue
        gi, wi = [], []
        for i, key in enumerate(zip(g[0].tolist(), g[1].tolist())):
            j = wk.get(key)
            if j is None:
                n_only += 1
            else:
                gi.append(i)
                wi.append(j)
        n_only += len(wk) - len(wi)
        if not gi:
            continue
        gi, wi = np.array(gi), np.array(wi)
        n_match += len(gi)
        gaps["auc_gap"] = max(gaps["auc_gap"], float(np.max(_gap(
            g[2][gi], np.asarray(w["auc"], np.float64)[wi]))))
        # each matched peak against each of its near ties
        order = np.argsort(w["tie_peak"], kind="stable")
        lo = np.searchsorted(w["tie_peak"][order], wi)
        hi = np.searchsorted(w["tie_peak"][order], wi, side="right")
        pair = np.repeat(np.arange(len(gi)), hi - lo)
        tie = order[np.concatenate([np.arange(a, b) for a, b in
                                    zip(lo, hi)]).astype(np.int64)]
        first = np.concatenate([[0], np.cumsum(hi - lo)[:-1]])
        for key, col, ref in (("p_gap", 3, "tie_p"), ("q_gap", 4, "tie_q")):
            if key == "q_gap" and not use_q:
                continue
            d = _gap(g[col][gi][pair], np.asarray(w[ref], np.float64)[tie])
            gaps[key] = max(gaps[key], float(np.max(
                np.minimum.reduceat(d, first))))
        at = (g[0][gi] + g[5][gi])[pair]
        inside = (at >= w["tie_start"][tie]) & (at < w["tie_end"][tie])
        moved += int(np.sum(~np.logical_or.reduceat(inside, first)))
    out = {"unmatched": n_only / max(n_ref, 1), **gaps,
           "summit_moved": moved / max(n_match, 1)}
    if not use_q:
        del out["q_gap"]
    return out, n_ref, n_match


def to_text(peaks, names):
    """The reference's peaks as narrowPeak text (columns 1-3 and 7-10,
    printed with %f as Genrich prints them), in ``names`` order: the
    control's output, put where the program's would be."""
    lines = []
    for c in names:
        pk = peaks.get(c)
        if pk is None:
            continue
        for i in range(len(pk["start"])):
            q = pk["qval"][i]
            lines.append(f"{c}\t{pk['start'][i]}\t{pk['end'][i]}\t.\t0\t.\t"
                         f"{float(pk['auc'][i]):f}\t{float(pk['pval'][i]):f}\t"
                         f"{'-1' if q == -1 else f'{float(q):f}'}\t"
                         f"{pk['summit'][i]}")
    return "\n".join(lines) + ("\n" if lines else "")
