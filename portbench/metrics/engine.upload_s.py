"""Mean per analysis of the engine's own ``perf["upload_s"]``: host
seconds in its host-to-device copies."""


def read(run):
    t = [r["perf"]["upload_s"] for r in run["recs"]
         if "upload_s" in r["perf"]]
    return sum(t) / len(t) if t else None
