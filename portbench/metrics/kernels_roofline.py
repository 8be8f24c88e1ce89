"""The hand kernels' (K1-K5) share of their roofline over the window:
the sum over their recorded calls of each call's least time on the
card (``kernels/<kernel>.py``'s work from the call's shapes, over
``roofline.py``'s peaks) over the sum of their device time in the
profiler's trace, in percent.  Every kernel that ran counts: where any
kernel's device records in the trace differ from what its recorded
calls launched (the profiler dropped records, or a call went past its
recorded entry), nothing is returned, so the share is never taken over
another set of kernels than the window ran.  Nothing is returned
without a kernel to read either."""

from portbench.roofline import bound_s


def read(run):
    tr = run["trace"]
    if not tr:
        return None
    least = device = 0.0
    for k in tr["hand"].values():
        if k["records"] != k["calls"] * k["per_call"]:
            return None
        if not k["calls"]:
            continue
        least += sum(bound_s(w["bytes"], w["fp32_ops"], w["fp64_ops"])
                     for w in k["work"])
        device += k["device_ns"] / 1e9
    return 100.0 * least / device if device else None
