"""Mean per analysis of the engine's ``perf["archive_s"]``: host seconds
in the replicate archive (``archive_replicate``, span
``pipeline.archive``: each replicate's p-value runs compacted, their
counts pulled, the runs kept).  A parent span of dispatches and a
fetch, not a further leaf.  Nothing without the key."""


def read(run):
    t = [r["perf"]["archive_s"] for r in run["recs"]
         if "archive_s" in r["perf"]]
    return sum(t) / len(t) if t else None
