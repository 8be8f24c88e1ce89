"""Mean per analysis of the engine's ``perf["cast_s"]``: host seconds
in the dtype casts of the events before their upload (the pipeline's
int64 copies and the engine's int32 and uint8 casts; span
``pipeline.cast``)."""


def read(run):
    t = [r["perf"]["cast_s"] for r in run["recs"] if "cast_s" in r["perf"]]
    return sum(t) / len(t) if t else None
