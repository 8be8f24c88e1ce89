"""Genrich's ChIP-seq configuration through the port's device engines.

The flags a ChIP-seq user runs: no ``-j`` (whole fragments), an input
control for each replicate (``-c``), an ``-E`` blacklist
(``testing.blacklist_regions``: overlapping and adjacent regions, one
across each tile boundary, one at a chromosome's end, one over a
cluster), ``-e`` of a chromosome and Genrich's default threshold
``-p 0.01``, with ``-r``.  The exclusions make K2's excluded branch,
the merge's breaks at ``-E`` coordinates and the sharded engine's
per-tile exclusions run; ``-p`` feeds the p statistic to K5 and K4.
For one replicate and for two replicates with controls, both engines
against the JAX twin (``--engine jax`` / ``--engine sharded`` on the
8 virtual devices: columns 1-6 identical, 8-9 within 1e-5 relative,
as test_torch_cli.py and test_torch_sharded.py hold them) and against
the port's ``--engine exact`` (columns 1-6 identical, column 7 within
1e-6 relative, where the JAX twin's AUC is up to 8e-5 off, column 10
by ``testing.check_summits``).  Then the sharded engine (2^17-bp tiles)
on an excluded region at a tile boundary with a significant interval
on each side within max_gap: the SKIP rows of the tiles' ends
(``skip_tail``, ``skip_head``) keep the two peaks apart in the
boundary merge, as the exact engine and TorchEngine keep them.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)

from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from genrich_tpu_torch.testing import (blacklist_regions, check_summits,
                                       write_bed)

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

CHROMS = (("chr1", 1_000_000), ("chr2", 300_000), ("chr3", 100_000))
TILE = 1 << 17                    # n_shards=8 on the 1 Mbp chr1
FLAGS = ["-r", "-p", "0.01", "-a", "20", "-e", "chr3"]
# cluster centres: two across tile boundaries, one that the blacklist
# cuts (CUT), two on the skipped chr3
CUT = ("chr1", 700_000)
SPOTS = ([("chr1", x) for x in (50_000, 131_072, 240_000, 393_216,
                                520_000, 700_000, 860_000)]
         + [("chr2", x) for x in (40_000, 150_000, 250_000)]
         + [("chr3", x) for x in (30_000, 70_000)])


def chip_sam(path, seed, spots=SPOTS, background=900, chroms=CHROMS):
    """Pairs only: 20-60 fragments of 60-400 bp around each of ``spots``
    (none for a control, ``spots=()``), ``background`` fragments spread
    over the chromosomes by length, and 10% of all fragments twice
    (PCR duplicates for ``-r``)."""
    b = oracle.SamBuilder(list(chroms), seed=seed)
    rng = b.rng
    frags = []
    for name, c in spots:
        for _ in range(rng.randrange(20, 60)):
            p1 = c + rng.randrange(-300, 300)
            frags.append((name, p1, p1 + rng.randrange(10, 350)))
    total = sum(size for _, size in chroms)
    for name, size in chroms:
        for _ in range(background * size // total):
            p1 = rng.randrange(0, size - 600)
            frags.append((name, p1, p1 + rng.randrange(10, 350)))
    for name, p1, p2 in frags:
        b.add_pair(name, p1, p2, score=0)
        if rng.random() < 0.1:
            b.add_pair(name, p1, p2, score=0)
    return b.write(path)


def _port(tmp_path, name, args, engine):
    """The port's pipeline.run on ``engine`` ("exact" for none), writing
    tmp/name/out.np (and summit.log for the exact engine)."""
    d = tmp_path / name
    d.mkdir()
    extra = ["-f", str(d / "summit.log")] if engine == "exact" else []
    perf = {}
    pipeline.run(params.parse_args(args + ["-o", str(d / "out.np")]
                                   + extra),
                 engine=None if engine == "exact" else engine, perf=perf)
    return (d / "out.np").read_text().splitlines(), d / "summit.log", perf


def _jax(tmp_path, args, engine):
    d = tmp_path / f"jax_{engine}"
    d.mkdir()
    r = oracle.run_ours(args + ["-o", "out.np", "--engine", engine],
                        cwd=str(d))
    assert r.returncode == 0, r.stderr[-1500:]
    return (d / "out.np").read_text().splitlines()


def _chip_args(tmp_path, reps):
    """The ChIP flags on ``reps`` treatment SAMs, each with the one
    control SAM, and the blacklist BED."""
    rng = np.random.RandomState(5)
    bed = write_bed(str(tmp_path / "blk.bed"), blacklist_regions(
        rng, CHROMS[:2], 12, (300, 3_000), TILE, cut=[CUT]))
    ts = [chip_sam(str(tmp_path / f"t{i}.sam"), 21 + i)
          for i in range(reps)]
    c = chip_sam(str(tmp_path / "c.sam"), 31, spots=(), background=600)
    return ["-t", ",".join(ts), "-c", ",".join([c] * reps), "-E",
            bed] + FLAGS


@pytest.mark.parametrize("reps", [1, 2])
@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_chip_config_matches_jax_twin_and_exact(tmp_path, kind, reps):
    args = _chip_args(tmp_path, reps)
    engine = TorchEngine("cpu") if kind == "jax" \
        else ShardedTorchEngine("cpu", n_shards=8)
    got, _, perf = _port(tmp_path, "port", args, engine)
    exact, log, _ = _port(tmp_path, "exact", args, "exact")
    want = _jax(tmp_path, args, kind)
    assert len(got) == len(want) == len(exact) > 10
    for a, b, c in zip(want, got, exact):
        fa, fb, fc = a.split("\t"), b.split("\t"), c.split("\t")
        assert fa[:6] == fb[:6] == fc[:6], (a, b, c)
        for i in (7, 8):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= 1e-5 * max(1.0, abs(x)), (a, b)
        # column 7 against the exact engine: the JAX twin's float32
        # prefix-sum AUC is up to 8e-5 off it here (ROADMAP Queue 3)
        x, y = float(fc[6]), float(fb[6])
        assert abs(x - y) <= 1e-6 * abs(x), (b, c)
    chroms = {ln.split("\t")[0] for ln in got}
    assert chroms == {"chr1", "chr2"}            # -e chr3
    # the cluster the blacklist cuts still gives a peak, cut short
    assert any(ln.startswith("chr1\t") and int(ln.split("\t")[2])
               <= CUT[1] < int(ln.split("\t")[2]) + 400 for ln in got)
    n, ties = check_summits(exact, got, log, 1e-5)
    assert n == len(exact) and (ties == 0 or reps > 1)
    assert perf["host_peak_chroms"] == 0
    if kind == "sharded":
        assert (perf["grid_tile_len"], perf["grid_tiles"]) == (TILE, 8)


def _boundary_bed(path, where):
    """An 80-bp -E region at the tile boundary 2 * TILE: across it,
    ending at it or starting at it."""
    lo = {"across": 2 * TILE - 40, "ends_at": 2 * TILE - 80,
          "starts_at": 2 * TILE}[where]
    return write_bed(path, [("chr1", lo, lo + 80)]), lo


@pytest.mark.parametrize("where", ["across", "ends_at", "starts_at"])
def test_sharded_exclusion_at_a_tile_boundary(tmp_path, where):
    """Clusters cover an 80-bp excluded region at a tile boundary from
    both sides, so a significant interval ends at the region's start
    and another starts at its end, 80 bp apart, within max_gap (100).
    The excluded rows between them are SKIP and break the peak: the
    exact engine calls two peaks there, and the sharded engine, whose
    boundary merge sees them only as the tiles' ``skip_tail`` and
    ``skip_head``, calls the same two, as TorchEngine does."""
    chroms = CHROMS[:1]
    bed, lo = _boundary_bed(str(tmp_path / "b.bed"), where)
    t = chip_sam(str(tmp_path / "t.sam"), 41, chroms=chroms,
                 spots=[("chr1", lo - 150), ("chr1", lo + 230),
                        ("chr1", 600_000)])
    c = chip_sam(str(tmp_path / "c.sam"), 42, spots=(), chroms=chroms)
    args = ["-t", t, "-c", c, "-E", bed] + FLAGS[:-2]
    exact, log, _ = _port(tmp_path, "exact", args, "exact")
    one, _, _ = _port(tmp_path, "torch", args, TorchEngine("cpu"))
    got, _, perf = _port(tmp_path, "sharded", args,
                         ShardedTorchEngine("cpu", n_shards=8))
    assert [ln.split("\t")[:6] for ln in got] \
        == [ln.split("\t")[:6] for ln in one] \
        == [ln.split("\t")[:6] for ln in exact]
    assert check_summits(exact, got, log, 1e-5) == (len(exact), 0)
    spans = [(int(f[1]), int(f[2])) for f in
             (ln.split("\t") for ln in got)]
    assert any(e == lo for _, e in spans), spans
    assert any(s == lo + 80 for s, _ in spans), spans
    assert perf["grid_tile_len"] == TILE and perf["straddling_peaks"] == 0
