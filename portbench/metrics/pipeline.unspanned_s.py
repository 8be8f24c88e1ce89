"""Mean per analysis of the host seconds inside the harness's spans
around ``pipeline._replicate_device`` and ``pipeline._find_peaks_device``
that none of the program's disjoint leaf spans names: the two spans
less ``perf``'s cast, upload, dispatch, fetch (wait and copy), q-value
merge and peak-writer seconds.  Analyses that lack any of these are
left out."""

SPANS = ("pipeline._replicate_device", "pipeline._find_peaks_device")
LEAVES = ("cast_s", "upload_s", "dispatch_s", "fetch_s", "qvalue_merge_s",
          "peak_write_s")


def read(run):
    t = []
    for r in run["recs"]:
        if all(k in r["spans"] for k in SPANS) \
                and all(k in r["perf"] for k in LEAVES):
            t.append(sum(r["spans"][k] for k in SPANS)
                     - sum(r["perf"][k] for k in LEAVES))
    return sum(t) / len(t) if t else None
