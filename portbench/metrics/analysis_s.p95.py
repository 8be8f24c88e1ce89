"""95th percentile of the analyses' walls in the window (host clock,
from the hand-over of the events to the output's close; linear
interpolation between order statistics)."""

import numpy as np


def read(run):
    t = [r["seconds"] for r in run["recs"]]
    return float(np.percentile(t, 95)) if t else None
