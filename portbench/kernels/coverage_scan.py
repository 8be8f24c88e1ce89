"""K1, ``csrc/scan.cu``: coverage of sorted packed class deltas.

Work from shapes (a copy of the port's ``testing.scan_bytes`` and the
first term of ``coverage_scan_opcount``): M packed int32 rows in, G
float32 coverage rows out (and a float32 -log10 p row in lambda mode);
6 float32 operations per row and group.  Lambda mode's p-value math
depends on the data and is not counted (the main path does not use
it), so a lambda-mode call's bound is its bytes."""

NAME = "coverage_scan"
DEVICE_NAMES = ("coverage_scan_kernel",)
ENTRY = ("genrich_tpu_torch.ops.scan", "_coverage_scan_cuda")


def record(packed, groups, carry, lam=None):
    return (int(packed.shape[0]), int(groups), lam is not None)


def work(rec):
    m, groups, lam = rec
    return {"bytes": 4 * m * (1 + groups + lam), "fp32_ops": 6 * groups * m,
            "fp64_ops": 0}
