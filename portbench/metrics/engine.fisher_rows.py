"""Mean per analysis of the engine's ``perf["fisher_rows"]``: the lanes
K3 combines, ``compact.merge_fisher``'s merged width (every
replicate's archived runs, not deduplicated) summed over the device
chromosomes.  Nothing without the key."""


def read(run):
    t = [r["perf"]["fisher_rows"] for r in run["recs"]
         if "fisher_rows" in r["perf"]]
    return sum(t) / len(t) if t else None
