"""Mean per analysis of ``perf["peak_write_s"]``: host seconds in the
narrowPeak writer of ``pipeline._find_peaks_device`` (span
``pipeline.peaks_write``)."""


def read(run):
    t = [r["perf"]["peak_write_s"] for r in run["recs"]
         if "peak_write_s" in r["perf"]]
    return sum(t) / len(t) if t else None
