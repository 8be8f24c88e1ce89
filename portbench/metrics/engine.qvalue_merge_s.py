"""Mean per analysis of the engine's ``perf["qvalue_merge_s"]``: host
seconds in the merge of the distinct p-value tables and the BH sweep
(span ``pipeline.qvalue_merge``)."""


def read(run):
    t = [r["perf"]["qvalue_merge_s"] for r in run["recs"]
         if "qvalue_merge_s" in r["perf"]]
    return sum(t) / len(t) if t else None
