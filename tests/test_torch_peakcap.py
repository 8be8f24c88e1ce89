"""Peak calling stays on the device whatever a chromosome's candidate count.

Both device engines give K5 and K4 a fixed number of candidate slots
(``torch_bridge.PEAK_CAP`` a chromosome, ``sharded_bridge.PEAK_CAP`` a
tile).  When a chromosome has more candidates, its peak step runs again
on the device with the count rounded up to a power of two as its slots
(``perf["peak_redispatch"]``); the host peak caller
(``engine/peaks.call_peaks_chrom``) is kept for what the device cannot
hold (``perf["host_peak_chroms"]``).  On a fixture with many
candidates, with the caps monkeypatched small: no host peak call, the
bytes of the run with the default caps, each re-dispatch's slots the
rule's, and the rows of the JAX package's device engine, which takes
its host fallback there (columns 1-6 and 8-10 equal, column 7 within
1e-6 relative: the host caller sums AUC in another order).  Then the
sharded engine on two gloo ranks whose tiles' largest counts differ:
both ranks re-dispatch with the same slots and write one process's
bytes.  Last, a -g longer than the sharded engine's tiles would be:
the tiles grow past it and the peaks stay on the device; a -g longer
than its largest tile: each chromosome's peaks are called once over its
gathered rows, on one rank and on two.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)

from genrich_tpu import cli as jcli
from genrich_tpu.engine import jax_bridge
from genrich_tpu.engine import peaks as jpeaks
from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine import peaks as tpeaks
from genrich_tpu_torch.engine import sharded_bridge, torch_bridge
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine, pow2
from genrich_tpu_torch.parallel import mesh
from genrich_tpu_torch.testing import check_summits

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402
from test_torch_parallel import HERE, REPO, _free_port  # noqa: E402

FLAGS = ["-y", "-p", "0.01", "-a", "20"]
# (module, small cap) per engine kind; the fixture has 51 and 17
# candidates on its chromosomes and up to 14 on a 2^17-bp tile
CAPS = {"jax": (torch_bridge, 8), "sharded": (sharded_bridge, 4)}


def many_peaks_sam(path, seed=11):
    """chr1 (1 Mbp) and chr2 (300 kbp): 67 clusters over background
    pairs, denser in chr1's first half (the first rank's tiles with two
    ranks and n_shards=8), so tiles' candidate counts differ."""
    b = oracle.SamBuilder([("chr1", 1_000_000), ("chr2", 300_000)],
                          seed=seed)
    rng = b.rng
    spots = [("chr1", rng.randrange(2_000, 524_000)) for _ in range(40)]
    spots += [("chr1", rng.randrange(525_000, 998_000)) for _ in range(12)]
    spots += [("chr2", rng.randrange(2_000, 298_000)) for _ in range(15)]
    for name, c in spots:
        for _ in range(rng.randrange(20, 60)):
            p1 = c + rng.randrange(-300, 300)
            b.add_pair(name, p1, p1 + rng.randrange(60, 300), score=0)
    for name, size, n in (("chr1", 1_000_000, 1500),
                          ("chr2", 300_000, 450)):
        for _ in range(n):
            p1 = rng.randrange(0, size - 600)
            b.add_pair(name, p1, p1 + rng.randrange(60, 400), score=0)
    return b.write(path)


def _engine(kind):
    return TorchEngine("cpu") if kind == "jax" \
        else ShardedTorchEngine("cpu", n_shards=8)


def _spy_slots(monkeypatch, kind):
    """Record (slots, rows, candidate count) of every call_peaks the
    engine makes (the sharded engine's: one per tile), in order."""
    mod = torch_bridge if kind == "jax" else mesh
    real = mod.call_peaks
    calls = []

    def spy(*args, **kw):
        res = real(*args, **kw)
        k = kw["k_peaks"] if "k_peaks" in kw else args[10]
        calls.append((k, args[0].shape[0], int(res.n_peaks)))
        return res
    monkeypatch.setattr(mod, "call_peaks", spy)
    return calls


def _run(path, kind, sam, capped, monkeypatch):
    """``sam`` through the port's engine ``kind``; with ``capped`` the
    cap is small and the host peak caller refused.  Returns the bytes,
    perf and the recorded call_peaks calls."""
    if capped:
        mod, cap = CAPS[kind]
        monkeypatch.setattr(mod, "PEAK_CAP", cap)

        def refuse(*a, **kw):
            raise AssertionError("host peak caller called")
        monkeypatch.setattr(tpeaks, "call_peaks_chrom", refuse)
    calls = _spy_slots(monkeypatch, kind)
    perf = {}
    pipeline.run(params.parse_args(["-t", sam, "-o", path] + FLAGS),
                 engine=_engine(kind), perf=perf)
    monkeypatch.undo()
    return open(path, "rb").read(), perf, calls


@pytest.mark.parametrize("kind", ["jax", "sharded"])
def test_capped_engine_redispatches_on_the_device(tmp_path, monkeypatch,
                                                  kind):
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    free, free_perf, _ = _run(str(tmp_path / "free.np"), kind, sam, False,
                              monkeypatch)
    got, perf, calls = _run(str(tmp_path / "capped.np"), kind, sam, True,
                            monkeypatch)
    assert got == free and got.count(b"\n") > 20
    assert free_perf["peak_redispatch"] == 0
    assert perf["peak_redispatch"] == 2 and perf["host_peak_chroms"] == 0
    assert free_perf["host_peak_chroms"] == 0
    cap = CAPS[kind][1]
    # every chromosome is submitted at the cap, then each fetch
    # re-dispatches its chromosome with the largest count of its tiles
    # (its own count for TorchEngine) rounded up
    per_chrom = 1 if kind == "jax" else 8
    for chrom in range(2):
        first = calls[chrom * per_chrom:(chrom + 1) * per_chrom]
        again = calls[(chrom + 2) * per_chrom:(chrom + 3) * per_chrom]
        n = max(c[2] for c in first)
        assert n > cap and all(c[0] == min(cap, c[1]) for c in first)
        assert all(c[0] == min(pow2(n), c[1]) for c in again)
        assert [c[2] for c in again] == [c[2] for c in first]


def test_capped_engines_match_jax_host_fallback(tmp_path, monkeypatch):
    """The JAX device engine, its cap as small, finishes the fixture's
    chromosomes with its host peak caller; the port's capped engines do
    not, and give the same rows."""
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    host_calls = []
    real = jpeaks.call_peaks_chrom

    def count(*a, **kw):
        host_calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(jax_bridge, "PEAK_CAP", 8)
    monkeypatch.setattr(jpeaks, "call_peaks_chrom", count)
    assert jcli.main(["-t", sam, "-o", str(tmp_path / "jax.np")] + FLAGS
                     + ["--engine", "jax"]) == 0
    monkeypatch.undo()
    assert len(host_calls) == 2
    want = (tmp_path / "jax.np").read_text().splitlines()
    for kind in CAPS:
        got, perf, _ = _run(str(tmp_path / f"{kind}.np"), kind, sam, True,
                            monkeypatch)
        got = got.decode().splitlines()
        assert perf["peak_redispatch"] == 2 and len(got) == len(want) > 20
        for a, b in zip(want, got):
            fa, fb = a.split("\t"), b.split("\t")
            assert fa[:6] == fb[:6] and fa[7:] == fb[7:], (a, b)
            x, y = float(fa[6]), float(fb[6])
            assert abs(x - y) <= 1e-6 * abs(x), (a, b)


def test_sharded_gap_longer_than_a_tile_stays_on_the_device(tmp_path,
                                                            monkeypatch):
    """A -g longer than the 2^17-bp tiles the fixture's grid would have:
    ``prepare`` lengthens the tiles past the gap, so no chromosome goes
    to the host peak caller, and the rows are the exact engine's
    (columns 1-6 identical, 7 within 1e-6 relative, 8-9 within 1e-5,
    column 10 by ``check_summits``).  A gap that not even a
    ``MAX_TILE_LEN`` tile holds calls each chromosome's peaks once over
    its gathered rows, on the device too: the bytes of TorchEngine, and
    the exact engine's rows by the same rule, but column 7 within 1e-5:
    such a gap joins chr1 into one 963-kbp peak, whose AUC the exact
    engine sums row by row in float32 and the CPU's plain K4 as a
    float64 prefix difference (1.3e-6 apart; K4 on the card sums as the
    exact engine does)."""
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    huge = str(ShardedTorchEngine.MAX_TILE_LEN)
    for gap, tile_len, auc_tol in (("200000", 1 << 18, 1e-6),
                                   (huge, 1 << 28, 1e-5)):
        args = ["-t", sam] + FLAGS + ["-g", gap]
        perf = _gap_runs(tmp_path, args, monkeypatch, gap == huge)
        assert perf["grid_tile_len"] == tile_len
        assert perf["host_peak_chroms"] == 0
        assert (perf["straddling_peaks"] > 0) == (gap == "200000")
        _same_as_exact(tmp_path, auc_tol)


def _gap_runs(tmp_path, args, monkeypatch, like_torch_engine,
             patch=lambda: None):
    """The exact engine (e.np, e.log) and the sharded engine on 8 shards
    (s.np, host peak caller refused) on ``args``; with
    ``like_torch_engine`` also TorchEngine (t.np), whose bytes the
    sharded run must write.  ``patch`` sets the test's own patches again
    after the host peak caller's is undone.  Returns the sharded run's
    perf."""
    pipeline.run(params.parse_args(args + [
        "-o", str(tmp_path / "e.np"), "-f", str(tmp_path / "e.log")]),
        engine=None)

    def refuse(*a, **kw):
        raise AssertionError("host peak caller called")
    monkeypatch.setattr(tpeaks, "call_peaks_chrom", refuse)
    perf = {}
    pipeline.run(params.parse_args(args + ["-o", str(tmp_path / "s.np")]),
                 engine=ShardedTorchEngine("cpu", n_shards=8), perf=perf)
    if like_torch_engine:
        pipeline.run(params.parse_args(args + ["-o",
                                               str(tmp_path / "t.np")]),
                     engine=TorchEngine("cpu"))
        assert (tmp_path / "s.np").read_bytes() \
            == (tmp_path / "t.np").read_bytes()
    monkeypatch.undo()
    patch()
    return perf


def _same_as_exact(tmp_path, auc_tol):
    """s.np against the exact engine's e.np: columns 1-6 identical, 7
    within ``auc_tol`` relative, 8-9 within 1e-5, column 10 by
    ``check_summits`` on e.log; fewer than 20 rows (clusters joined
    across the long gap)."""
    exact = (tmp_path / "e.np").read_text().splitlines()
    got = (tmp_path / "s.np").read_text().splitlines()
    assert 0 < len(got) == len(exact) < 20
    for a, b in zip(exact, got):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i, tol in ((6, auc_tol), (7, 1e-5), (8, 1e-5)):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= tol * max(1.0, abs(x)), (a, b)
    check_summits(exact, got, str(tmp_path / "e.log"), 1e-5)


# One rank of the two-process run of the chromosome peak call: argv is
# repo, tests, then the CLI flags; prints the rows and slots of every
# chromosome call and perf.
_CHROM_WORKER = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch.distributed as td
from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine import sharded_bridge
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
ShardedTorchEngine.MAX_TILE_LEN = 1 << 17
real = sharded_bridge.chrom_peaks
calls = []
def spy(*args):
    calls.append((args[0].shape[0], args[-1]))
    return real(*args)
sharded_bridge.chrom_peaks = spy
perf = {}
pipeline.run(params.parse_args(sys.argv[3:]),
             engine=ShardedTorchEngine("cpu", n_shards=8), perf=perf)
print(json.dumps({"calls": calls, "tile_len": perf["grid_tile_len"],
                  "host": perf["host_peak_chroms"]}))
td.destroy_process_group()
"""


def test_sharded_gap_past_the_largest_tile_joins_cut_rows(tmp_path,
                                                          monkeypatch):
    """With ``MAX_TILE_LEN`` cut to 2^17 bp, a -g of 200,000 reaches the
    tiles, so each chromosome's peaks are called once over its rows of
    every tile, with each row that a tile boundary cut joined back into
    one: TorchEngine's bytes (the longest-interval summit and the AUC
    see whole intervals), the exact engine's rows.  Then on two gloo
    ranks, four tiles each: both gather the same rows, launch the same
    slots and write the bytes of one process."""
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    args = ["-t", sam] + FLAGS + ["-g", "200000"]
    rows = {"sharded": [], "jax": []}
    real = torch_bridge.chrom_peaks

    def spy(kind):
        def keep(starts, ends, pv, live, *rest):
            on = live & (ends > starts)
            rows[kind].append((starts[on], ends[on], pv[on]))
            return real(starts, ends, pv, live, *rest)
        return keep

    def patch():
        monkeypatch.setattr(ShardedTorchEngine, "MAX_TILE_LEN", 1 << 17)
        monkeypatch.setattr(sharded_bridge, "chrom_peaks", spy("sharded"))
        monkeypatch.setattr(torch_bridge, "chrom_peaks", spy("jax"))
    patch()
    perf = _gap_runs(tmp_path, args, monkeypatch, True, patch)
    assert perf["grid_tile_len"] == 1 << 17
    assert perf["host_peak_chroms"] == perf["straddling_peaks"] == 0
    # the exact engine's intervals, as TorchEngine holds them: every row
    # that 2^17-bp tiles cut is whole again
    assert len(rows["sharded"]) == len(rows["jax"]) == 2
    for got, want in zip(rows["sharded"], rows["jax"]):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    _same_as_exact(tmp_path, 1e-5)       # chr1 is one peak again

    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CHROM_WORKER, REPO, HERE] + args
        + ["-o", str(tmp_path / f"r{i}.np")], env={**env, "RANK": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    logs = [p.communicate(timeout=300) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][1][-2000:]}"
    ranks = [json.loads(out.splitlines()[-1]) for out, _ in logs]
    assert ranks[0] == ranks[1]
    assert ranks[0]["tile_len"] == 1 << 17 and ranks[0]["host"] == 0
    assert [c[0] for c in ranks[0]["calls"]] == [
        r[0].shape[0] for r in rows["sharded"]]
    one = (tmp_path / "s.np").read_bytes()
    assert (tmp_path / "r0.np").read_bytes() == one \
        == (tmp_path / "r1.np").read_bytes()


# A rank of the two-process capped run: argv is repo, tests, then the CLI
# flags; prints the (slots, rows, count) of every call_peaks and perf.
_CAPPED_WORKER = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch.distributed as td
from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine import peaks, sharded_bridge
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.parallel import mesh
from genrich_tpu_torch.testing import check_summits
sharded_bridge.PEAK_CAP = 4
def refuse(*a, **kw):
    raise AssertionError("host peak caller called")
peaks.call_peaks_chrom = refuse
real = mesh.call_peaks
calls = []
def spy(*args, **kw):
    res = real(*args, **kw)
    calls.append((args[10], args[0].shape[0], int(res.n_peaks)))
    return res
mesh.call_peaks = spy
perf = {}
pipeline.run(params.parse_args(sys.argv[3:]),
             engine=ShardedTorchEngine("cpu", n_shards=8), perf=perf)
print(json.dumps({"calls": calls, "redispatch": perf["peak_redispatch"],
                  "host": perf["host_peak_chroms"]}))
td.destroy_process_group()
"""


def test_two_gloo_ranks_redispatch_the_same_slots(tmp_path):
    """Two ranks, four tiles each: the largest candidate count of
    chr1's tiles is 14 on the first rank and 8 on the second, of chr2's
    7 and 0; both ranks re-dispatch each chromosome with the slots of
    the larger count, and both write the bytes of one uncapped
    process."""
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    args = ["-t", sam] + FLAGS
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _CAPPED_WORKER, REPO, HERE] + args
        + ["-o", str(tmp_path / f"r{i}.np")], env={**env, "RANK": str(i)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    logs = [p.communicate(timeout=300) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][1][-2000:]}"
    ranks = [json.loads(out.splitlines()[-1]) for out, _ in logs]
    for r in ranks:
        assert r["redispatch"] == 2 and r["host"] == 0
    local_max = []
    for r in ranks:
        calls = r["calls"]
        # chr1 and chr2 at the cap, then chr1 and chr2 again
        assert len(calls) == 16
        assert [c[0] for c in calls[:8]] == [4] * 8
        assert [c[0] for c in calls[8:]] == [16] * 4 + [8] * 4
        local_max.append([max(c[2] for c in calls[:4]),
                          max(c[2] for c in calls[4:8])])
    assert local_max == [[14, 7], [8, 0]]
    pipeline.run(params.parse_args(args + ["-o", str(tmp_path / "one.np")]),
                 engine=ShardedTorchEngine("cpu", n_shards=8))
    one = (tmp_path / "one.np").read_bytes()
    assert (tmp_path / "r0.np").read_bytes() == one \
        == (tmp_path / "r1.np").read_bytes()
