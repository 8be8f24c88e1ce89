"""Peak calling from the final significance pileup.

Replicates callPeaks/updatePeak/checkPeak/printPeak semantics
(Genrich.c:885-1069) with a vectorized reformulation: the sequential
state machine is equivalent to

  1. mark intervals with stat > threshold (float32 compare);
  2. group consecutive significant intervals into sites;
  3. join adjacent sites iff the next site's start is within maxGap of
     the previous site's end AND no SKIP interval lies between them
     (SKIP hard-breaks peaks regardless of gap);
  4. per joined group: AUC = sum of len*(stat - threshold) in float32
     encounter order; summit = first interval with the maximal stat
     (p/q recorded there), summit position from the first longest
     interval among the maximal ones;
  5. emit iff AUC >= minAUC and length >= minLen.

The per-group accumulation runs in a small Python loop (groups are
tiny); grouping itself is vectorized.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from ..utils.cfloat import SKIP
from .pileup import Pileup

F32 = np.float32
_U32 = 1 << 32


@dataclass
class Peak:
    start: int
    end: int
    auc: np.float32       # 'signal' column
    summit_pval: np.float32
    summit_qval: np.float32
    summit_pos: int       # offset of summit from start


def call_peaks_chrom(stat_cov: np.ndarray, pval_cov: np.ndarray,
                     qval_cov: Optional[np.ndarray], ends: np.ndarray,
                     min_pqval: np.float32, min_auc: np.float32,
                     min_len: int, max_gap: int) -> List[Peak]:
    """Call peaks over one chromosome's interval arrays.

    ``stat_cov`` is the thresholded statistic (q-values when -q, else
    p-values); ``pval_cov``/``qval_cov`` supply the summit columns.
    """
    stat_cov = np.asarray(stat_cov, F32)
    n = len(stat_cov)
    if n == 0:
        return []

    # native streaming caller (identical float32 semantics); the
    # Python loop below is the reference implementation and fallback
    from ..ingest import native as native_mod
    nat = native_mod.call_peaks_native(stat_cov, pval_cov, qval_cov,
                                       ends, min_pqval, min_auc,
                                       min_len, max_gap)
    if nat is not None:
        p_start, p_end, auc, spv, sqv, spos = nat
        return [Peak(int(p_start[i]), int(p_end[i]), auc[i], spv[i],
                     sqv[i] if qval_cov is not None else F32(SKIP),
                     int(spos[i]))
                for i in range(len(p_start))]

    starts = np.concatenate([[0], ends[:-1]]).astype(np.int64)
    ends = np.asarray(ends, np.int64)

    sig = stat_cov > F32(min_pqval)
    sig_idx = np.flatnonzero(sig)
    if len(sig_idx) == 0:
        return []

    # runs of consecutive significant intervals
    run_start = np.flatnonzero(np.diff(sig_idx, prepend=sig_idx[0] - 2) > 1)
    run_first = sig_idx[run_start]                       # first interval idx
    run_last = sig_idx[np.append(run_start[1:] - 1, len(sig_idx) - 1)]

    # join adjacent runs: gap <= maxGap and no SKIP interval in between
    skip_cum = np.concatenate([[0], np.cumsum(stat_cov == SKIP)])
    if len(run_first) > 1:
        gap_ok = (starts[run_first[1:]] - ends[run_last[:-1]]) <= max_gap
        no_skip = (skip_cum[run_first[1:]]
                   - skip_cum[run_last[:-1] + 1]) == 0
        join = gap_ok & no_skip
    else:
        join = np.zeros(0, bool)
    group_id = np.concatenate([[0], np.cumsum(~join)])

    peaks: List[Peak] = []
    for g in range(group_id[-1] + 1 if len(group_id) else 0):
        runs = np.flatnonzero(group_id == g)
        idxs = np.concatenate([np.arange(run_first[r], run_last[r] + 1)
                               for r in runs])
        idxs = idxs[sig[idxs]]
        p_start = int(starts[idxs[0]])
        p_end = int(ends[idxs[-1]])

        # sequential float32 AUC and summit tracking (updatePeak)
        auc = F32(0.0)
        summit_val = F32(-1.0)
        summit_pv = F32(-1.0)
        summit_qv = F32(-1.0)
        summit_pos = 0
        summit_len = 0
        for m in idxs:
            length = int(ends[m] - starts[m])
            pq = stat_cov[m]
            auc = F32(auc + F32(np.uint32(length).astype(F32)
                                * F32(pq - F32(min_pqval))))
            if pq > summit_val:
                summit_val = pq
                summit_pv = pval_cov[m]
                summit_qv = (qval_cov[m] if qval_cov is not None
                             else F32(SKIP))
                summit_pos = (((int(ends[m]) + int(starts[m])) % _U32) // 2
                              - p_start) % _U32
                summit_len = length
            elif pq == summit_val and length > summit_len:
                summit_pos = (((int(ends[m]) + int(starts[m])) % _U32) // 2
                              - p_start) % _U32
                summit_len = length

        if auc >= F32(min_auc) and p_end - p_start >= min_len:
            peaks.append(Peak(p_start, p_end, auc, summit_pv,
                              summit_qv, summit_pos))
    return peaks


def peak_score(signal: np.float32, length: int) -> int:
    """narrowPeak score column (printPeak, Genrich.c:891-892)."""
    val = F32(F32(F32(1000.0) * F32(signal)) / F32(length)) + F32(0.5)
    return min(int(val), 1000)
