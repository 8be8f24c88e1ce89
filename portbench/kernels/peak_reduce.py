"""K4, ``csrc/peaks.cu``: each candidate peak's area and summit.

Work from the call's inputs (a copy of the port's
``testing.peak_reduce_bytes``): 13 bytes per row inside a candidate
(start, end, statistic, sig; the summit's p and q are two rows more)
and 40 per candidate (16 in, 24 out).  A recorded call keeps its
``first`` and ``last`` rows (the gap-join's candidate slots, which
nothing writes again) and launches nothing; the rows inside candidates
are summed when ``work`` reads the record, after the window, so the
benchmark's bookkeeping runs no kernel inside it."""

NAME = "peak_reduce"
DEVICE_NAMES = ("peak_reduce_kernel",)
ENTRY = ("genrich_tpu_torch.ops.peaks", "_peak_reduce_cuda")


def record(starts, ends, stat, pval, qval, sig, first, last, min_pq):
    return (first, last)


def work(rec):
    first, last = rec
    rows = int((last - first + 1).clamp_min(0).sum())
    return {"bytes": 13 * rows + 40 * int(first.shape[0]), "fp32_ops": 0,
            "fp64_ops": 0}
