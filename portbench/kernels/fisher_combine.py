"""K3, ``csrc/fisher.cu``: Fisher's combination of R replicates'
-log10 p over N merged intervals.

Work from shapes: R x N float32 in, N float32 out.  Its float64
operations (the chi-squared series) depend on the values and are not
counted, so its bound is its bytes: a lower bound of the least time,
and the kernel's share of it reads low."""

NAME = "fisher_combine"
DEVICE_NAMES = ("fisher_combine_kernel",)
ENTRY = ("genrich_tpu_torch.ops.chisq", "_fisher_combine_cuda")


def record(pvals):
    r, n = pvals.shape
    return (int(r), int(n))


def work(rec):
    r, n = rec
    return {"bytes": 4 * r * n + 4 * n, "fp32_ops": 0, "fp64_ops": 0}
