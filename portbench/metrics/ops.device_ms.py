"""Device milliseconds per analysis, from the profiler's trace of the
window, in every kernel, memset and on-card copy that is not one of the
hand kernels (``kernels/``): PyTorch's sorts, scans, gathers and
copies.  Host-to-device and device-to-host copies are the engine's
staging and are left out."""


def read(run):
    tr = run["trace"]
    if not tr or not tr["analyses"]:
        return None
    return tr["ops_ns"] / 1e6 / tr["analyses"]
