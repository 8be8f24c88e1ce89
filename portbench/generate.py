"""Samples from a seed: fragment events as the port's ingest hands them.

A sample is the input files of one analysis, each described in the
configuration's ``sample`` section.  What a file holds after Genrich's
parsing is, per chromosome, its events in file order (queryname order:
not sorted by position): int64 start, int64 end and the int32 count
code N, the number of loci the template aligned to (weight 1/N).
PCR duplicates (removed by -r), reads on chromosomes that -e skips and
unmapped reads never become events, so a file's ``pairs`` are its
templates and ``kept_share`` of them are fragments on analysed
chromosomes.

Every seed gives the same work: the fragments, sites and multimapped
templates of each chromosome are fixed counts (proportional to its
length, by largest remainders), the site strengths the same log-normal
quantiles, and the seed draws only positions, lengths, which site gets
which strength, and file order.  Draws run on ``device`` with
one ``torch.Generator`` in a few large calls; the events are then
copied to host memory, where the program's ingest would have left
them.

Fragment model (per file):
- a share ``sites.frip`` of the fragments lies at ``sites.count``
  binding sites (treatment files only), each site's midpoint uniform
  outside the -E regions, its strength a quantile of a log-normal with
  sigma ``sites.sigma``, a fragment's midpoint uniform within ``sites.width``
  of its site's; the rest is background, uniform over the chromosome;
- fragment lengths uniform in ``frag_len`` [lo, hi);
- a share ``multimap.share`` of the templates aligned to N loci, N
  drawn in the proportions of ``multimap.loci``; the other N - 1
  alignments lie uniformly over the analysed genome;
- ``events`` "atac": Genrich's -j cut sites (+5 / -5 shift, each end
  widened to ``cut_len`` bp, one interval when the two overlap);
  "fragment": the fragment itself.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch

I64 = torch.int64


def sub_seed(seed: int, tag: str) -> int:
    """A 63-bit seed for one part of a run, from the run's seed."""
    h = hashlib.sha256(f"{seed}/{tag}".encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def shares(total: int, weights) -> list:
    """``total`` split in proportion to ``weights`` by largest
    remainders: the same integers for every seed."""
    w = np.asarray(weights, np.float64)
    raw = total * w / w.sum()
    out = np.floor(raw).astype(np.int64)
    rest = total - int(out.sum())
    out[np.argsort(-(raw - out), kind="stable")[:rest]] += 1
    return out.tolist()


def exclusions(config, seed):
    """The -E regions of a run: {chrom name: [(start, end), ...]}, each
    chromosome's regions in equal slots, one region at a seeded offset
    in each, so they never overlap and cover the same bp every seed."""
    spec = config.get("exclusions")
    if not spec:
        return {}
    kept = analysed(config)
    g = torch.Generator().manual_seed(sub_seed(seed, "exclusions"))
    n_black = shares(spec["blacklist_regions"], [n for _, n in kept])
    out = {}
    for (name, n), nb in zip(kept, n_black):
        sizes = [spec["blacklist_bp"]] * nb
        sizes += [int(n * spec["n_share"]) // spec["n_runs"]] \
            * spec["n_runs"]
        sizes = [sizes[i] for i in torch.randperm(len(sizes),
                                                  generator=g).tolist()]
        slot = n // len(sizes)
        out[name] = [(k * slot + off, k * slot + off + s)
                     for k, s in enumerate(sizes)
                     for off in [int(torch.randint(
                         0, max(slot - s, 1), (1,), generator=g))]]
    return out


def skipped(config):
    """Chromosomes the flags skip with -e."""
    f = config["flags"].split()
    return set(f[f.index("-e") + 1].split(",")) if "-e" in f else set()


def analysed(config):
    """(name, length) of the chromosomes a run analyses."""
    skip = skipped(config)
    return [(n, ln) for n, ln in config["genome"] if n not in skip]


def _free_positions(u, regions, dev):
    """Map u in [0, free bp) to coordinates outside ``regions``."""
    if not regions:
        return u
    r = torch.tensor(sorted(regions), dtype=I64, device=dev)
    skipped_bp = torch.cat([r.new_zeros(1),
                            torch.cumsum(r[:, 1] - r[:, 0], 0)])
    free_before = r[:, 0] - skipped_bp[:-1]
    return u + skipped_bp[torch.searchsorted(free_before, u, right=True)]


def _atac(start, end, length, cut_len):
    """Genrich -j: cut sites shifted +5 / -5, each widened to cut_len
    (half to each side, the larger half 3'), one interval when the two
    windows overlap; clipped to the chromosome."""
    l5, l3 = cut_len // 2, (cut_len + 1) // 2
    s, e = start + 5, end - 5
    one = s + l3 >= e - l3
    a0, a1 = s - l5, torch.where(one, e + l5, s + l3)
    b0, b1 = e - l3, e + l5
    two = ~one
    st = torch.stack([a0, torch.where(two, b0, a0)], 1)
    en = torch.stack([a1, torch.where(two, b1, a1)], 1)
    keep = torch.stack([torch.ones_like(two), two], 1)
    return (st.clamp(0, length)[keep], en.clamp(0, length)[keep], keep)


def sample(config, seed, index, device):
    """Pool sample ``index`` of a run: [(treatment, control)] per
    replicate, each {chrom name: (start, end, count)} numpy arrays (the
    control None when the replicate has none), and the sample's pairs."""
    spec = config["sample"]
    kept = analysed(config)
    regions = exclusions(config, seed)
    dev = torch.device(device)
    g = torch.Generator(device=dev).manual_seed(
        sub_seed(seed, f"sample{index}"))
    lengths = [n for _, n in kept]
    site_spec = spec.get("sites")
    # binding sites: shared by a sample's treatment files
    sites = {}
    if site_spec:
        for (name, n), k in zip(kept, shares(site_spec["count"], lengths)):
            reg = regions.get(name, [])
            free = n - sum(e - s for s, e in reg)
            u = torch.randint(0, free, (k,), generator=g, device=dev)
            mid = _free_positions(u, reg, dev)
            # the same log-normal quantiles every seed, in a seeded order
            q = (torch.arange(k, device=dev, dtype=torch.float64) + 0.5) / k
            strength = torch.exp(site_spec["sigma"] * torch.special.ndtri(q))[
                torch.randperm(k, generator=g, device=dev)].float()
            sites[name] = (mid, strength)
    files = {}
    for f in spec["files"]:
        frip = site_spec["frip"] if (site_spec and f["role"] == "treatment") \
            else 0.0
        files[f["name"]] = _file(spec, kept, sites, frip,
                                 round(f["pairs"] * spec["kept_share"]), g,
                                 dev)
    reps = []
    for r in sorted({f["replicate"] for f in spec["files"]}):
        role = {f["role"]: files[f["name"]] for f in spec["files"]
                if f["replicate"] == r}
        reps.append((role["treatment"], role.get("control")))
    return reps, sum(f["pairs"] for f in spec["files"])


def _file(spec, kept, sites, frip, fragments, g, dev):
    lengths = [n for _, n in kept]
    lo, hi = spec["frag_len"]
    mm = spec["multimap"]
    n_site = round(fragments * frip)
    # per chromosome: site fragments by its sites, background by length
    site_n = shares(n_site, [len(sites[n][0]) if n in sites else 0
                             for n, _ in kept]) if n_site else [0] * len(kept)
    back_n = shares(fragments - n_site, lengths)
    prim = [s + b for s, b in zip(site_n, back_n)]
    # multimapped templates of each chromosome by loci, fixed counts
    loci = mm["loci"]
    per_loci = shares(round(fragments * mm["share"]),
                      [loci.count(x) for x in sorted(set(loci))])
    multi = {x: shares(c, prim) for x, c in zip(sorted(set(loci)),
                                                per_loci)}
    extra = sum((x - 1) * c for x, c in zip(sorted(set(loci)), per_loci))
    sec_n = shares(extra, lengths)
    out = {}
    for ci, (name, n) in enumerate(kept):
        parts = []
        if site_n[ci]:
            mid, strength = sites[name]
            pick = torch.multinomial(strength, site_n[ci], replacement=True,
                                     generator=g)
            w = spec["sites"]["width"]
            parts.append(mid[pick] + torch.randint(-(w // 2), w - w // 2,
                                                   (site_n[ci],),
                                                   generator=g, device=dev))
        parts.append(torch.randint(0, n, (back_n[ci],), generator=g,
                                   device=dev))
        mid = torch.cat(parts)
        count = torch.ones(mid.shape[0], dtype=torch.int32, device=dev)
        at = 0
        for x in sorted(multi):
            c = multi[x][ci]
            count[at:at + c] = x
            at += c
        # secondary alignments landing here: their loci are spread in
        # the same proportions as the primaries'
        sec = sec_n[ci]
        if sec:
            xs = sorted(multi)
            code = torch.cat([torch.full((c,), x, dtype=torch.int32,
                                         device=dev) for x, c in zip(
                xs, shares(sec, [(x - 1) * sum(multi[x]) for x in xs]))])
            mid = torch.cat([mid, torch.randint(0, n, (sec,), generator=g,
                                                device=dev)])
            count = torch.cat([count, code])
        flen = torch.randint(lo, hi, mid.shape, generator=g, device=dev)
        start = (mid - flen // 2).clamp(0, max(n - hi, 0))
        end = (start + flen).clamp_max(n)
        order = torch.randperm(mid.shape[0], generator=g, device=dev)
        start, end, count = start[order], end[order], count[order]
        if spec["events"] == "atac":
            start, end, keep = _atac(start, end, n, spec["cut_len"])
            count = count[:, None].expand(-1, 2)[keep]
        out[name] = (start.cpu().numpy(), end.cpu().numpy(),
                     count.cpu().numpy())
    return out
