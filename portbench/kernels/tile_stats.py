"""K2, ``csrc/stats.cu``: -log10 p per interval from its coverage.

Work from shapes (a copy of the port's ``testing.stats_bytes``): per
row, the treatment and raw control float32 values and the excluded
flag in, the float32 -log10 p out, 13 bytes.  Its operations depend on
how many rows its tables cover and are not counted, so its bound is
its bytes."""

NAME = "tile_stats"
DEVICE_NAMES = ("tile_stats_table_kernel", "tile_stats_kernel")
ENTRY = ("genrich_tpu_torch.ops.pipeline", "_tile_stats_cuda")


def record(expt_val, ctrl_raw, excluded, factor, lam):
    return int(expt_val.shape[0])


def work(m):
    return {"bytes": 13 * m, "fp32_ops": 0, "fp64_ops": 0}
