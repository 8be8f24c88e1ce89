"""Mean per analysis of the harness's span around
``pipeline._replicate_device`` (summed over an analysis's replicates;
host clock)."""


def read(run):
    t = [r["spans"].get("pipeline._replicate_device") for r in run["recs"]]
    t = [x for x in t if x is not None]
    return sum(t) / len(t) if t else None
