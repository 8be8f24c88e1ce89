"""Mean per analysis of the harness's span around
``pipeline._find_peaks_device`` (host clock)."""


def read(run):
    t = [r["spans"].get("pipeline._find_peaks_device") for r in run["recs"]]
    t = [x for x in t if x is not None]
    return sum(t) / len(t) if t else None
