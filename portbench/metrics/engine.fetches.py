"""Mean per analysis of the engine's ``perf["fetch_n"]``: the times
the host waited for the card and pulled results back."""


def read(run):
    t = [r["perf"]["fetch_n"] for r in run["recs"] if "fetch_n" in r["perf"]]
    return sum(t) / len(t) if t else None
