"""Several shards a rank of a process group, on two gloo ranks.

The JAX package's multi-process mesh spans every process's devices
(tests/test_distributed_2proc.py: 2 processes x 4 devices).  The port's
``CardGroup`` does the same with several contexts a rank: shard
``rank * n_local + c`` is context c of that rank, and a gather joins a
rank's contexts on its first before one ``all_gather`` across the
ranks.  Here, on the CPU under gloo (spawned processes, the port only):

- dist2_worker's fixture through ``distributed_analyze`` on 2 ranks x 4
  contexts: both ranks agree, bitwise with the port's one process (1 x
  8 contexts and one context) and with 2 ranks x 1 context, and within
  1e-5 relative of ``dist2_worker.run()`` through JAX on the conftest's
  8 virtual devices, the peak across the process boundary present;
- the collectives over ``CardGroup(["cpu"] * 2, procs=gloo)`` on two
  ranks equal ``CardGroup(["cpu"] * 4)`` in one process;
- ``ShardedTorchEngine(["cpu", "cpu"], n_shards=8)`` through
  ``pipeline.run`` on two ranks writes one process's bytes on six
  fixtures: peaks across a tile boundary inside a context, across the
  contexts' boundary inside each rank and across the ranks' boundary,
  and peaks only on a rank's second context; a Fisher peak across the
  ranks' boundary (column 10 the exact engine's); the ChIP flags on two
  controlled replicates; the caps cut small (re-dispatch on the
  device); a -g of 2^28 (one call a chromosome over every shard's
  rows); and the -f/-k logs;
- ranks of unequal shard counts raise on both ranks; torchrun's
  ``LOCAL_WORLD_SIZE`` splits a host's cards evenly or raises;
- the bench's ``--scaling`` legs on the script's rung at D = 1, 2 and 4
  contexts and 2 ranks x 1 and x 2 contexts give the same peaks, under
  the JSON keys of scripts/bench_scaling.py.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)
import dist2_worker as w

from genrich_tpu_torch import bench, params, pipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.parallel import distributed as tdist
from genrich_tpu_torch.parallel import mesh
from genrich_tpu_torch.testing import check_summits
from test_torch_chip import _chip_args
from test_torch_lambda import fisher_straddle_args
from test_torch_multicard import _collectives, _inputs
from test_torch_parallel import HERE, REPO, _free_port
from test_torch_peakcap import many_peaks_sam
from test_torch_sharded import _exact, _straddle_sam

FLAGS = ["-y", "-p", "0.01", "-a", "20"]
TIMEOUT = 120
# 2 ranks x 2 contexts, n_shards=8 on a 1 Mbp chromosome: 2^17-bp
# tiles, two a context; the contexts' boundaries inside the ranks and
# the ranks' boundary
CARD_EDGES = (262_144, 786_432)
RANK_EDGE = 524_288

# Refuses jax and genrich_tpu in a rank process (the port alone).
_REFUSE = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
"""


def _ranks(script, argv_of, n=2, timeout=TIMEOUT):
    """``script`` as ``n`` gloo ranks on 127.0.0.1 (argv: repo, tests,
    then ``argv_of(rank)``); returns each rank's (rc, stdout, stderr),
    every process ended."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    # the ranks share the cores: each spinning on all of them slows
    # gloo's collectives many times over
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)))
    procs = [subprocess.Popen(
        [sys.executable, "-c", _REFUSE + script, REPO, HERE]
        + argv_of(i), env={**env, "RANK": str(i)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in range(n)]
    try:
        logs = [p.communicate(timeout=timeout) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, logs)]


def _ok(runs):
    for i, (rc, _, err) in enumerate(runs):
        assert rc == 0, f"rank {i}:\n{err[-2000:]}"
    return [json.loads(out.splitlines()[-1]) for _, out, _ in runs]


# --- distributed_analyze on 2 ranks x 4 contexts -----------------------------

# A rank of dist2_worker's fixture through distributed_analyze; argv is
# repo, tests, then the number of CPU contexts of the rank.
_ANALYZE = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import dist2_worker as w
import torch.distributed as td
from genrich_tpu_torch.parallel import distributed as dist
expt, ctrl = w.make_fixture()
peaks, lam, factor = dist.distributed_analyze(
    expt[0], expt[1], expt[2], w.N_TILES, w.TILE_LEN, w.GENOME_LEN,
    w.MIN_PQ, w.MIN_AUC, min_len=0, max_gap=w.MAX_GAP, qval_opt=True,
    ctrl=ctrl, excl_bed=w.EXCL_BED, device=["cpu"] * int(sys.argv[3]))
print(json.dumps({"peaks": [[int(s), int(e), float(a), float(p), float(q),
                             int(x)] for (s, e, a, p, q, x) in peaks],
                  "lam": lam, "factor": factor,
                  "rank": td.get_rank()}))
td.destroy_process_group()
"""


def _one_process(devices):
    expt, ctrl = w.make_fixture()
    peaks, lam, factor = tdist.distributed_analyze(
        expt[0], expt[1], expt[2], w.N_TILES, w.TILE_LEN, w.GENOME_LEN,
        w.MIN_PQ, w.MIN_AUC, min_len=0, max_gap=w.MAX_GAP, qval_opt=True,
        ctrl=ctrl, excl_bed=w.EXCL_BED, device=devices)
    return {"peaks": [[int(s), int(e), float(a), float(p), float(q), int(x)]
                      for (s, e, a, p, q, x) in peaks],
            "lam": lam, "factor": factor}


def test_two_ranks_of_four_contexts_match_one_process_and_jax(tmp_path):
    by_local = {k: _ok(_ranks(_ANALYZE, lambda r, k=k: [str(k)]))
                for k in (4, 1)}
    for k, (r0, r1) in by_local.items():
        assert (r0["rank"], r1["rank"]) == (0, 1)
        assert {**r0, "rank": 0} == {**r1, "rank": 0}, f"{k} contexts"
    got = {key: by_local[4][0][key] for key in ("peaks", "lam", "factor")}
    assert got == {key: by_local[1][0][key] for key in got}
    assert got == _one_process(["cpu"] * 8) == _one_process("cpu")

    want = w.run()      # JAX, this process's 8-device mesh
    assert len(want["peaks"]) == len(got["peaks"]) > 0
    for g, ref in zip(got["peaks"], want["peaks"]):
        assert (g[0], g[1], g[5]) == (ref[0], ref[1], ref[5])
        np.testing.assert_allclose(g[2:5], ref[2:5], rtol=1e-5)
    np.testing.assert_allclose([got["lam"], got["factor"]],
                               [want["lam"], want["factor"]], rtol=1e-5)
    assert any(s < 4 * w.TILE_LEN < e for s, e, *_ in got["peaks"]), \
        "fixture lost its process-boundary-straddling peak"


# --- the collectives ------------------------------------------------------

# A rank of two CPU contexts in the collective check; argv is repo,
# tests.  Context c of rank r takes shard 2r + c's inputs.
_COLLECTIVES = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch.distributed as td
from test_torch_multicard import _collectives, _inputs
from genrich_tpu_torch.parallel import distributed, mesh
procs = distributed.init_distributed("cpu")
cards = mesh.CardGroup(["cpu", "cpu"], procs)
rank = td.get_rank()
xs = [_inputs(2 * rank + c) for c in (0, 1)]
out = _collectives([list(x) for x in zip(*xs)], cards)
print(json.dumps({"world": mesh.world_rank(cards),
                  "out": [[c.tolist() for c in x] for x in out]}))
td.destroy_process_group()
"""


def test_collectives_of_two_ranks_of_two_contexts_match_one_process(
        tmp_path):
    ranks = _ok(_ranks(_COLLECTIVES, lambda r: []))
    assert [r["world"] for r in ranks] == [[4, 0], [4, 2]]
    group = mesh.CardGroup(["cpu"] * 4)
    want = _collectives([list(x) for x in zip(*(_inputs(s)
                                                for s in range(4)))], group)
    for j, res in enumerate(want):
        for r, rank in enumerate(ranks):
            assert rank["out"][j] == [c.tolist() for c in res[2 * r:
                                                              2 * r + 2]], j
    # the ragged rows differ in length by shard: 2 + 3 + 4 + 5
    assert len(want[3][0]) == 14


# --- the sharded engine on 2 ranks x 2 contexts ------------------------------

# A rank of the engine run; argv is repo, tests, the run's settings as
# JSON ({"cap": the sharded engine's PEAK_CAP, the host peak caller
# refused, or null}), then the CLI flags.
_ENGINE = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch.distributed as td
from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine import peaks, sharded_bridge
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
cfg = json.loads(sys.argv[3])
if cfg["cap"]:
    sharded_bridge.PEAK_CAP = cfg["cap"]
    def refuse(*a, **kw):
        raise AssertionError("host peak caller called")
    peaks.call_peaks_chrom = refuse
eng = ShardedTorchEngine(["cpu", "cpu"], n_shards=8)
perf = {}
pipeline.run(params.parse_args(sys.argv[4:]), engine=eng, perf=perf)
print(json.dumps({"shards": [eng.world, eng.rank, len(eng.devices)],
                  **{k: perf[k] for k in (
                      "straddling_peaks", "host_peak_chroms",
                      "peak_redispatch", "grid_tile_len", "grid_tiles")}}))
td.destroy_process_group()
"""

# the straddle fixture's clusters: across a tile boundary inside a
# context (131,072), across the contexts' boundaries (262,144, 786,432),
# across the ranks' (524,288), and on a rank's second context only
# (400,000, 900,000)
CENTERS = (131_072, 262_144, 400_000, RANK_EDGE, 786_432, 900_000)


def _fixture(tmp_path, name):
    """(argv without -o, the cut cap or None)."""
    if name in ("straddle", "logs"):
        sam = _straddle_sam(str(tmp_path / "in.sam"), centers=CENTERS)
        logs = ["-f", "f.log", "-k", "k.log"] if name == "logs" else []
        return ["-t", sam] + FLAGS + logs, None
    if name == "fisher_straddle":
        return fisher_straddle_args(tmp_path), None
    if name == "chip_fisher":
        return _chip_args(tmp_path, 2), None
    sam = many_peaks_sam(str(tmp_path / "in.sam"))
    if name == "capped":
        return ["-t", sam] + FLAGS, 4
    assert name == "huge_gap"
    return ["-t", sam] + FLAGS + ["-g", str(1 << 28)], None


def _argv(d, args):
    """``args`` with their -f/-k paths and -o in directory ``d``."""
    return [str(d / a) if i and args[i - 1] in ("-f", "-k") else a
            for i, a in enumerate(args)] + ["-o", str(d / "out.np")]


def _outputs(d):
    return {n: (d / n).read_bytes() for n in ("out.np", "f.log", "k.log")
            if (d / n).exists()}


@pytest.mark.parametrize("fixture", ["straddle", "logs", "fisher_straddle",
                                     "chip_fisher", "capped", "huge_gap"])
def test_two_ranks_of_two_contexts_write_one_process_bytes(tmp_path,
                                                           fixture):
    args, cap = _fixture(tmp_path, fixture)
    dirs = [tmp_path / f"r{i}" for i in (0, 1)]
    for d in dirs + [tmp_path / "one"]:
        d.mkdir()
    ranks = _ok(_ranks(_ENGINE, lambda r: [
        json.dumps({"cap": cap})] + _argv(dirs[r], args)))
    perf = {}
    pipeline.run(params.parse_args(_argv(tmp_path / "one", args)),
                 engine=ShardedTorchEngine("cpu", n_shards=8), perf=perf)
    one = _outputs(tmp_path / "one")
    assert _outputs(dirs[0]) == one == _outputs(dirs[1])
    assert [r["shards"] for r in ranks] == [[4, 0, 2], [4, 2, 2]]
    for r in ranks:
        assert r["host_peak_chroms"] == 0
        assert (r["grid_tile_len"], r["grid_tiles"]) \
            == (perf["grid_tile_len"], perf["grid_tiles"])
        assert r["straddling_peaks"] == perf["straddling_peaks"]
    rows = one["out.np"].decode().splitlines()
    spans = [(int(f[1]), int(f[2])) for f in (ln.split("\t") for ln in rows)]
    # a -g of 2^28 joins each chromosome's clusters into one peak
    assert len(rows) == 2 if fixture == "huge_gap" else len(rows) > 2
    if fixture in ("straddle", "logs"):
        for edge in (131_072, RANK_EDGE) + CARD_EDGES:
            assert any(s < edge < e for s, e in spans), (edge, spans)
        for lo, hi in ((CARD_EDGES[0], RANK_EDGE), (CARD_EDGES[1], 1 << 20)):
            assert any(lo < s and e < hi for s, e in spans), (lo, spans)
    if fixture == "logs":
        assert set(one) == {"out.np", "f.log", "k.log"}
    if fixture == "fisher_straddle":
        assert any(s < RANK_EDGE < e for s, e in spans)
        exact, log = _exact(tmp_path, args + ["-o", "out.np"])
        assert check_summits(exact, rows, log, 1e-4) == (len(exact), 0)
    if fixture == "capped":
        assert [r["peak_redispatch"] for r in ranks] == [2, 2]
    if fixture == "huge_gap":
        assert perf["grid_tile_len"] == 1 << 28
        assert all(r["straddling_peaks"] == 0 for r in ranks)


# --- refusals -------------------------------------------------------------

# A rank that asks for as many CPU contexts as argv[3] says; prints the
# error its CardGroup raised, if any.
_UNEQUAL = """
import json, sys
sys.path[:0] = sys.argv[1:3]
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
try:
    ShardedTorchEngine(["cpu"] * int(sys.argv[3]))
    err = None
except ValueError as e:
    err = str(e)
print(json.dumps({"error": err}))
"""


def test_ranks_of_unequal_shard_counts_raise_on_every_rank(tmp_path):
    ranks = _ok(_ranks(_UNEQUAL, lambda r: [str(2 - r)],
                       timeout=60))
    for r in ranks:
        assert r["error"] is not None and "[2, 1] cards" in r["error"], r


def test_local_world_size_splits_the_host_cards(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    cards = lambda *ids: [torch.device("cuda", i) for i in ids]  # noqa: E731
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    # no torchrun: the one card RANK modulo the host's
    assert tdist.rank_devices("cuda", 5) == cards(1)
    assert tdist.rank_devices("cuda:3", 0) == cards(3)
    assert tdist.rank_devices(["cuda:2", "cuda:2"], 0) == cards(2, 2)
    assert tdist.rank_devices("cpu", 1) == [torch.device("cpu")]
    for lws, local, want in (("2", "0", (0, 1)), ("2", "1", (2, 3)),
                             ("1", "0", (0, 1, 2, 3)), ("4", "3", (3,))):
        monkeypatch.setenv("LOCAL_WORLD_SIZE", lws)
        monkeypatch.setenv("LOCAL_RANK", local)
        assert tdist.rank_devices("cuda", 7) == cards(*want)
        # an explicit card or list is the caller's
        assert tdist.rank_devices("cuda:0", 7) == cards(0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="split evenly"):
        tdist.rank_devices("cuda", 0)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "2")
    monkeypatch.delenv("LOCAL_RANK")
    with pytest.raises(ValueError, match="LOCAL_RANK"):
        tdist.rank_devices("cuda", 0)


# --- the bench's scaling leg ----------------------------------------------

def test_bench_scaling_legs_agree_on_the_cpu():
    out = bench.scaling(torch.device("cpu"), ds=(1, 2, 4),
                        rungs=bench.SCALING_RUNGS[:1], reps=1)
    assert out["device"] == "cpu"
    (rung,) = out["rungs"]
    assert (rung["tiles"], rung["tile_len"], rung["events_per_tile"]) \
        == (8, 1 << 16, 1 << 12)
    assert rung["peaks"] > 0
    forms = rung["forms"]
    assert set(forms) == {"contexts", "ranks"}
    assert list(forms["contexts"]["t_ms_by_D"]) == ["1", "2", "4"]
    assert list(forms["ranks"]["t_ms_by_D"]) == ["2", "4"]
    for form in forms.values():
        assert set(form) == {"devices", "t_ms_by_D", "overhead_pct_by_D",
                             "efficiency_pct_by_D"}
        for d, t in form["t_ms_by_D"].items():
            assert t > 0
            base = forms["contexts"]["t_ms_by_D"]["1"]
            assert form["efficiency_pct_by_D"][d] == pytest.approx(
                100.0 * base / t)
    assert forms["ranks"]["devices"]["4"] == [["cpu", "cpu"],
                                              ["cpu", "cpu"]]
