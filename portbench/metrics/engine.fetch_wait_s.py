"""Mean per analysis of the engine's ``perf["fetch_wait_s"]``: host
seconds blocked on the card's stream before a pull (span
``pipeline.fetch.wait``); near zero when the card is never what the
host waits for."""


def read(run):
    t = [r["perf"]["fetch_wait_s"] for r in run["recs"]
         if "fetch_wait_s" in r["perf"]]
    return sum(t) / len(t) if t else None
