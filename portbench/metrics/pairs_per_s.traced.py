"""Read pairs of every analysis completed in the traced window over the
window's seconds (host clock, with the profiler on)."""


def read(run):
    if not run["recs"]:
        return None
    return sum(r["pairs"] for r in run["recs"]) / run["window_s"]
