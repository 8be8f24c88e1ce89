"""Mean per analysis of the engine's ``perf["fisher_s"]``: host seconds
in Fisher's combination of the replicates (``finalize_fisher``, span
``pipeline.fisher``: ``compact.merge_fisher``'s sort and searchsorted,
then K3, enqueued per chromosome).  A parent span of dispatches, not a
further leaf.  Nothing without the key."""


def read(run):
    t = [r["perf"]["fisher_s"] for r in run["recs"]
         if "fisher_s" in r["perf"]]
    return sum(t) / len(t) if t else None
