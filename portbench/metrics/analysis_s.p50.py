"""Median of the analyses' walls in the window (host clock)."""

import numpy as np


def read(run):
    t = [r["seconds"] for r in run["recs"]]
    return float(np.median(t)) if t else None
