"""torch.cuda.max_memory_allocated over the window (reset after the
warm-up), in MB of 10^6 bytes."""


def read(run):
    return run["peak"] / 1e6 if run["peak"] else None
