"""K3's (``fisher_combine``) share of its roofline over the window: the
sum over its recorded calls of each call's least time on the card
(``kernels/fisher_combine.py``'s work from the call's shapes, over
``roofline.py``'s peaks) over its device time in the profiler's trace,
in percent.  K3's float64 operations (the chi-squared series) depend
on the values and are not counted, so its least time is its bytes
alone and the share reads low.  Nothing is returned where K3 made no
call, or where its device records differ from what its recorded calls
launched."""

from portbench.roofline import bound_s


def read(run):
    tr = run["trace"]
    k = tr["hand"].get("fisher_combine") if tr else None
    if not k or not k["calls"] or not k["device_ns"] \
            or k["records"] != k["calls"] * k["per_call"]:
        return None
    least = sum(bound_s(w["bytes"], w["fp32_ops"], w["fp64_ops"])
                for w in k["work"])
    return 100.0 * least / (k["device_ns"] / 1e9)
