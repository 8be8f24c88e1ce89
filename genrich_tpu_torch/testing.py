"""Helpers shared by the port's tests and ``chip_smoke.py``.

``peak_rows`` makes a synthetic chromosome of coverage rows holding
peaks; ``auc_rowwise`` is the exact engine's AUC on the host (a float32
sum in row order); ``check_log`` holds a port's ``-f``/``-k`` log to
the exact engine's.  numpy only: nothing here touches a device.
"""

from __future__ import annotations

import numpy as np

F32 = np.float32


def peak_rows(rng, m, n_regions, region_rows=(3, 40), min_pq=2.0,
              skip_frac=0.002):
    """A contiguous chromosome of m rows holding about n_regions peaks.

    Rows are 1-60 bp; background stat lies below ``min_pq``; inside a
    region of ``region_rows`` rows (a [lo, hi) range), stat lies above
    it, on a 0.25 grid in every other region (so summit ties occur) and
    off it in the rest (so AUC rounds), with 10% sub-threshold gap
    rows; then a ``skip_frac`` share of all rows become SKIP (-1).
    Returns (ends int64, stat, pval, qval f32); row i spans
    ends[i-1]..ends[i], from 0.
    """
    lens = rng.randint(1, 61, m)
    ends = np.cumsum(lens).astype(np.int64)
    stat = rng.uniform(0.0, min_pq, m).astype(F32)
    starts = np.sort(rng.choice(max(m - region_rows[1], 1), n_regions,
                                replace=False))
    for i, s in enumerate(starts):
        n = rng.randint(*region_rows)
        hi = min_pq + 0.25 * rng.randint(1, 120, n)
        if i % 2:                     # off the grid: AUC rounds
            hi = hi + rng.uniform(0, 0.25, n)
        gap = rng.rand(n) < 0.1
        stat[s:s + n] = np.where(gap, stat[s:s + n], hi).astype(F32)
    stat[rng.rand(m) < skip_frac] = -1.0
    pval = (stat + rng.uniform(0, 1, m)).astype(F32)
    qval = (stat * 0.5).astype(F32)
    return ends, stat, pval, qval


def auc_rowwise(starts, ends, stat, sig, first, last, min_pq):
    """Each candidate's AUC as updatePeak adds it (Genrich.c:948-964,
    ``genrich_tpu/engine/peaks.py:107-131``): float32 (len * (stat -
    min_pq)) over the significant rows first..last, summed in float32
    in row order.  Rows: numpy [M]; candidates: first/last [K], last <
    first for one with no rows (AUC 0).  Returns f32 [K].
    """
    contrib = np.where(sig, (ends - starts).astype(F32)
                       * (stat - F32(min_pq)), F32(0.0)).astype(F32)
    out = np.zeros(len(first), F32)
    for j, (lo, hi) in enumerate(zip(first, last)):
        if hi >= lo:
            # add.accumulate is a sequential sum (no pairwise blocking)
            out[j] = np.cumsum(contrib[lo:hi + 1], dtype=F32)[-1]
    return out


def _log_rows(path):
    with open(path) as f:
        return [ln.rstrip("\n").split("\t") for ln in f
                if not ln.startswith("#") and not ln.startswith("chr\t")]


def check_log(exact_log, port_log, cols=(3, 4, 5)):
    """``test_engine_jax_cli.py:145-170``'s rule: every port row ends at
    a boundary of the exact log, with ``cols`` within 1e-3 relative
    (NA where the exact log has NA), and the covered bp agree.  Raises
    AssertionError; returns a summary."""
    fe, ff = _log_rows(exact_log), _log_rows(port_log)
    fe_map = {(r[0], r[2]): r for r in fe}
    missing = [r for r in ff if (r[0], r[2]) not in fe_map]
    if not ff or missing:
        raise AssertionError(f"{port_log}: {len(missing)} of {len(ff)} "
                             f"rows have no boundary in the exact log: "
                             f"{missing[:3]}")
    worst = 0.0
    for r in ff:
        e = fe_map[(r[0], r[2])]
        for col in cols:
            if e[col] == "NA" or r[col] == "NA":
                if e[col] != r[col]:
                    raise AssertionError(f"NA differs: {e} {r}")
                continue
            x, y = float(e[col]), float(r[col])
            d = abs(x - y) / max(1.0, abs(x))
            worst = max(worst, d)
            if d > 1e-3:
                raise AssertionError(f"log values differ: {e} {r}")

    def span(rs):
        return sum(int(r[2]) - int(r[1]) for r in rs)
    if span(fe) != span(ff):
        raise AssertionError(f"covered bp differ: {span(fe)} {span(ff)}")
    return {"rows_exact": len(fe), "rows_port": len(ff),
            "worst_rel_diff": worst, "bp": span(ff)}
