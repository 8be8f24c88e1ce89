"""Seconds from the start of the process's benchmark code to the
window: imports, CUDA start, the samples, the warm-up analyses (and in
a checkout's first run the build of the port's kernels)."""


def read(run):
    return run["setup_s"]
