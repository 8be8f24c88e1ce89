"""K5, ``csrc/gapjoin.cu``: each row's peak flags and the candidate
peaks (the gap-join).

Work from shapes (a copy of the port's ``testing.gap_join_bytes``): M
rows of starts, ends, statistic and live flag in (13 bytes a row), the
sig and skip flags out (2), per candidate slot of K its first and last
rows and existence out (17), and the count (8).  Its operations, a few
integer compares a row, bind far below its bytes."""

NAME = "gap_join"
DEVICE_NAMES = ("gap_join_kernel",)
ENTRY = ("genrich_tpu_torch.ops.peaks", "_gap_join_cuda")


def record(starts, ends, stat, live, min_pq, max_gap, k, lib=None):
    return (int(starts.shape[0]), int(k))


def work(rec):
    m, k = rec
    return {"bytes": 15 * m + 17 * k + 8, "fp32_ops": 0, "fp64_ops": 0}
