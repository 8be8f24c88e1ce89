"""Several shards a rank of a process group, on two gloo ranks.

The JAX package's multi-process mesh spans every process's devices
(tests/test_distributed_2proc.py: 2 processes x 4 devices).  The port's
``CardGroup`` does the same with several contexts a rank: shard
``rank * n_local + c`` is context c of that rank, and a gather joins a
rank's contexts on its first before one ``all_gather`` across the
ranks.  Here, on the CPU under gloo (spawned processes, the port only):

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
  rows); the -f/-k logs; and, with four contexts a rank (one tile
  each), a control, -E regions and -q, peaks across the contexts' and
  the ranks' boundaries;
- ranks of unequal shard counts raise on both ranks, through the CLI's
  own path; torchrun's ``LOCAL_WORLD_SIZE`` splits a host's cards
  evenly or raises;
- ``python -m genrich_tpu_torch --engine sharded --device cpu`` itself as
  two gloo ranks: the bytes of one process of two shards, and every rank
  leaves the group it joined before the interpreter's teardown, after a
  run and after an analysis error; in this process, ``scoped_group``
  and the CLI and the server under a one-rank group leave a group
  joined inside them and keep one made before;
- every rank process of this file ends with no process group and no
  gloo thread left when its interpreter starts to finalize (``_AT_EXIT``;
  a gloo worker still running there can take the interpreter lock
  after finalization began, and the process aborts with "terminate
  called without an active exception").
"""

from __future__ import annotations

import contextlib
import io
import json
import os
import subprocess
import sys
import tempfile

import pytest
import torch
import torch.distributed as td

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)
import oracle

from genrich_tpu_torch import cli, params, pipeline, serve
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

# Registered when the interpreter starts, so it runs last of the atexit
# calls, just before the interpreter finalizes: writes whether a process
# group is still up and the names of the gloo threads still running.
_AT_EXIT = """
import atexit, json, os, sys
def _at_exit():
    names = []
    for t in os.listdir("/proc/self/task"):
        try:
            names.append(open(f"/proc/self/task/{t}/comm").read().strip())
        except OSError:
            pass
    dist = sys.modules.get("torch.distributed")
    up = bool(dist and dist.is_available() and dist.is_initialized())
    sys.stderr.write("at exit: " + json.dumps(
        {"group": up, "gloo_threads": sorted(n for n in names
                                             if "gloo" in n)}) + "\\n")
atexit.register(_at_exit)
"""
LEFT = {"group": False, "gloo_threads": []}
# what a rank's stderr must not hold: an abort at exit, a group never
# left (PyTorch's two wordings)
UNCLEAN = ("terminate called", "has NOT been destroyed",
           "destroy_process_group() was not called")


def _ranks(script, argv_of, n=2, timeout=TIMEOUT):
    """``script`` as ``n`` gloo ranks on 127.0.0.1 (argv: repo, tests,
    then ``argv_of(rank)``), or with ``script`` None ``python -m
    genrich_tpu_torch`` itself (argv: ``argv_of(rank)``); every rank
    refuses jax and genrich_tpu and runs ``_AT_EXIT`` (a
    ``sitecustomize``).  Returns each rank's (rc, stdout, stderr), every
    process ended."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    # the ranks share the cores: each spinning on all of them slows
    # gloo's collectives many times over
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(n), GLOO_SOCKET_IFNAME="lo",
               OMP_NUM_THREADS=str(max(1, (os.cpu_count() or n) // n)))
    cmd = [sys.executable, "-m", "genrich_tpu_torch"] if script is None \
        else [sys.executable, "-c", script, REPO, HERE]
    with tempfile.TemporaryDirectory() as site:
        with open(os.path.join(site, "sitecustomize.py"), "w") as f:
            f.write(_REFUSE + _AT_EXIT)
        env["PYTHONPATH"] = os.pathsep.join([site, REPO])
        procs = [subprocess.Popen(
            cmd + argv_of(i), env={**env, "RANK": str(i)},
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for i in range(n)]
        try:
            logs = [p.communicate(timeout=timeout) for p in procs]
        finally:
            for p in procs:
                p.kill()
                p.wait()
    return [(p.returncode, out, err) for p, (out, err) in zip(procs, logs)]


def _at_exit(err):
    """A rank's ``_AT_EXIT`` record from its stderr."""
    lines = [ln for ln in err.splitlines() if ln.startswith("at exit: ")]
    assert len(lines) == 1, err[-2000:]
    return json.loads(lines[0][len("at exit: "):])


def _ok(runs, rc=0):
    """Each rank's last stdout line as JSON, once every rank exited with
    ``rc``, a stderr free of ``UNCLEAN`` and no group or gloo thread
    left at its interpreter's teardown."""
    for i, (got, _, err) in enumerate(runs):
        assert got == rc, f"rank {i}:\n{err[-2000:]}"
        assert not [m for m in UNCLEAN if m in err], f"rank {i}:\n{err}"
        assert _at_exit(err) == LEFT, f"rank {i}:\n{err[-2000:]}"
    return [json.loads(out.splitlines()[-1]) if out.strip() else None
            for _, out, _ in runs]


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
# the group's holders go first: destroy_process_group then drops its
# last reference and joins its threads
del cards, procs
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
# refused, or null; "contexts": the rank's CPU contexts}), then the CLI
# flags.
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
eng = ShardedTorchEngine(["cpu"] * cfg["contexts"], n_shards=8)
perf = {}
pipeline.run(params.parse_args(sys.argv[4:]), engine=eng, perf=perf)
print(json.dumps({"shards": [eng.world, eng.rank, len(eng.devices)],
                  **{k: perf[k] for k in (
                      "straddling_peaks", "host_peak_chroms",
                      "peak_redispatch", "grid_tile_len", "grid_tiles")}}))
del eng    # the group's holder goes first (as in _COLLECTIVES)
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
    if name == "four_contexts":
        # dist2_worker's design on the straddle fixture: a control, an
        # exclusion inside tile 0 and one across a tile boundary, -q
        sam = _straddle_sam(str(tmp_path / "in.sam"), centers=CENTERS)
        ctrl = oracle.random_sam(str(tmp_path / "c.sam"),
                                 chroms=(("chr1", 1_000_000),), seed=7,
                                 n_pairs=1500, cluster=False)
        bed = tmp_path / "x.bed"
        bed.write_text("chr1\t1000\t1400\nchr1\t393016\t393516\n")
        return ["-t", sam, "-c", ctrl, "-E", str(bed), "-y", "-q", "0.05",
                "-a", "20"], None
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
                                     "chip_fisher", "capped", "huge_gap",
                                     "four_contexts"])
def test_two_ranks_of_two_contexts_write_one_process_bytes(tmp_path,
                                                           fixture):
    """Two ranks of two CPU contexts each (four each on
    ``four_contexts``, one 2^17-bp tile a context) write one process's
    bytes."""
    args, cap = _fixture(tmp_path, fixture)
    n = 4 if fixture == "four_contexts" else 2
    dirs = [tmp_path / f"r{i}" for i in (0, 1)]
    for d in dirs + [tmp_path / "one"]:
        d.mkdir()
    ranks = _ok(_ranks(_ENGINE, lambda r: [
        json.dumps({"cap": cap, "contexts": n})] + _argv(dirs[r], args)))
    perf = {}
    pipeline.run(params.parse_args(_argv(tmp_path / "one", args)),
                 engine=ShardedTorchEngine("cpu", n_shards=8), perf=perf)
    one = _outputs(tmp_path / "one")
    assert _outputs(dirs[0]) == one == _outputs(dirs[1])
    assert [r["shards"] for r in ranks] == [[2 * n, 0, n], [2 * n, n, n]]
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
    if fixture == "four_contexts":
        # every tile boundary is a boundary of contexts: inside a rank
        # (131,072, 262,144) and the ranks' (524,288)
        assert perf["grid_tile_len"] == 131_072
        for edge in (131_072, 262_144, RANK_EDGE):
            assert any(s < edge < e for s, e in spans), (edge, spans)


# --- the CLI itself as ranks, and leaving the group -------------------------

def _cli_argv(sam, out):
    return ["-t", sam, "-o", out] + FLAGS + ["--engine", "sharded",
                                             "--device", "cpu"]


@pytest.mark.parametrize("case", ["analysis", "analysis_error"])
def test_cli_as_two_gloo_ranks_leaves_its_group_before_teardown(tmp_path,
                                                                case):
    """``python -m genrich_tpu_torch --engine sharded --device cpu`` itself
    as two gloo ranks (one CPU context each) on the straddle fixture,
    and on an input that is not there (met after the engine joined the
    group): rc 0 (1), a stderr free of ``UNCLEAN``, and at each rank's
    last atexit call no group up and no gloo thread running (a gloo
    worker that still runs then can release a finished collective's
    tensors after finalization began, and the rank aborts with
    "terminate called without an active exception").  After a run each
    rank's narrowPeak is the bytes of one process of the same two shards
    (the grid sets column 7 of a peak across a tile boundary on the
    CPU, ROADMAP's "Not a fault")."""
    sam = _straddle_sam(str(tmp_path / "in.sam"), centers=CENTERS)
    given = sam if case == "analysis" else str(tmp_path / "missing.sam")
    runs = _ranks(None, lambda r: _cli_argv(given, str(tmp_path / f"r{r}.np")))
    _ok(runs, rc=0 if case == "analysis" else 1)
    if case == "analysis_error":
        for _, _, err in runs:
            assert "missing.sam: cannot open file" in err, err[-2000:]
        return
    pipeline.run(params.parse_args(_cli_argv(sam, str(tmp_path / "one.np"))
                                   [:-4]),
                 engine=ShardedTorchEngine("cpu", n_shards=2))
    one = (tmp_path / "one.np").read_bytes()
    assert one.count(b"\n") > 2
    for r in (0, 1):
        assert (tmp_path / f"r{r}.np").read_bytes() == one, r


def _gloo_threads() -> list:
    """The names of this process's gloo threads."""
    names = []
    for t in os.listdir("/proc/self/task"):
        try:
            names.append(open(f"/proc/self/task/{t}/comm").read().strip())
        except OSError:
            pass
    return sorted(n for n in names if "gloo" in n)


@pytest.fixture
def one_rank(monkeypatch):
    """The environment of a one-rank gloo group on 127.0.0.1; a group
    still up after the test is ended.  Yields the gloo threads that ran
    before."""
    monkeypatch.setenv("MASTER_ADDR", "127.0.0.1")
    monkeypatch.setenv("MASTER_PORT", str(_free_port()))
    monkeypatch.setenv("WORLD_SIZE", "1")
    monkeypatch.setenv("RANK", "0")
    monkeypatch.setenv("GLOO_SOCKET_IFNAME", "lo")
    assert not td.is_initialized()
    yield _gloo_threads()
    if td.is_initialized():
        td.destroy_process_group()


@pytest.mark.parametrize("how", ["clean", "raised"])
def test_scoped_group_leaves_the_group_its_block_joined(one_rank, how):
    with pytest.raises(KeyError) if how == "raised" \
            else contextlib.nullcontext():
        with tdist.scoped_group():
            assert tdist.init_distributed("cpu") is not None
            mesh.CardGroup(["cpu"], td.group.WORLD)
            if how == "raised":
                raise KeyError("in the block")
    assert not td.is_initialized()
    assert _gloo_threads() == one_rank


def test_scoped_group_keeps_a_group_made_before_it(one_rank):
    group = tdist.init_distributed("cpu")
    with tdist.scoped_group():
        assert tdist.init_distributed("cpu") is group
    assert td.is_initialized() and td.group.WORLD is group


@pytest.mark.parametrize("path", ["cli", "cli_error", "serve"])
def test_cli_and_serve_leave_the_group_they_joined(tmp_path, monkeypatch,
                                                   one_rank, path):
    """``cli.main`` after a run and after an analysis error, and
    ``serve_loop`` after a sharded line, each under a one-rank gloo
    group joined from the environment: no group and no new gloo thread
    after them, and the run's bytes those of no group."""
    sam = _straddle_sam(str(tmp_path / "in.sam"), centers=CENTERS)
    out = str(tmp_path / "out.np")
    if path == "serve":
        reply = io.StringIO()
        line = " ".join(_cli_argv(sam, out)[:-2])
        assert serve.serve_loop(stdin=io.StringIO(f"{line}\nEXIT\n"),
                                stdout=reply, device="cpu") == 0
        assert reply.getvalue().splitlines()[1].startswith("OK "), \
            reply.getvalue()
    else:
        argv = _cli_argv(sam if path == "cli" else sam + ".missing", out)
        assert cli.main(argv) == (0 if path == "cli" else 1)
    assert not td.is_initialized()
    assert _gloo_threads() == one_rank
    if path != "cli_error":
        for k in ("MASTER_ADDR", "WORLD_SIZE", "RANK"):
            monkeypatch.delenv(k)       # the reference joins no group
        ref = str(tmp_path / "ref.np")
        pipeline.run(params.parse_args(_cli_argv(sam, ref)[:-4]),
                     engine=ShardedTorchEngine("cpu"))
        assert open(out, "rb").read() == open(ref, "rb").read()


# --- refusals -------------------------------------------------------------

# A rank of the CLI whose sharded engine asks for as many CPU contexts as
# argv[3] says (no flag asks for several CPU contexts); argv is repo,
# tests, that count, then the CLI flags.  The script makes no process
# group and ends none: the CLI joins the group and leaves it.
_UNEQUAL = """
import json, sys
sys.path[:0] = sys.argv[1:3]
from genrich_tpu_torch import cli
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
cli.make_engine = lambda kind, device: ShardedTorchEngine(
    ["cpu"] * int(sys.argv[3]))
print(json.dumps({"rc": cli.main(sys.argv[4:])}))
"""


def test_ranks_of_unequal_shard_counts_raise_on_every_rank(tmp_path):
    sam = _straddle_sam(str(tmp_path / "in.sam"), centers=CENTERS)
    runs = _ranks(_UNEQUAL, lambda r: [str(2 - r), "-t", sam, "-o", str(
        tmp_path / f"r{r}.np")] + FLAGS + ["--engine", "sharded"],
        timeout=60)
    for r, (_, _, err) in zip(_ok(runs), runs):
        assert r == {"rc": 1}
        assert "Error! the ranks of the process group hold [2, 1] cards" \
            in err, err[-2000:]


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
