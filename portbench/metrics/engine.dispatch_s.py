"""Mean per analysis of the engine's ``perf["dispatch_s"]``: host
seconds spent enqueueing its tensor programs (spans
``pipeline.dispatch.<program>``)."""


def read(run):
    t = [r["perf"]["dispatch_s"] for r in run["recs"]
         if "dispatch_s" in r["perf"]]
    return sum(t) / len(t) if t else None
