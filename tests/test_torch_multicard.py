"""The sharded engine over several cards of one process, and over ranks.

With no process group ``ShardedTorchEngine`` spans the devices it is
given, one shard each (``parallel/mesh.CardGroup``), as the JAX
engine's mesh spans ``jax.devices()``.  On the CPU, W = 2 and 4 CPU
contexts (``["cpu"] * W``, ``n_shards=8``: 2^17-bp tiles on a 1 Mbp
chromosome, so the contexts' boundaries fall on tile boundaries) run
the fixtures of test_torch_parallel.py (peaks across a tile boundary
inside a context and across the contexts' boundary at 524,288; two
replicates whose Fisher peak straddles it), test_torch_peakcap.py (the
caps cut small: every chromosome re-dispatched on the device, none on
the host) and test_torch_chip.py (two controlled replicates with the
ChIP flags, an -E blacklist and clusters across tile boundaries).
Each writes the narrowPeak bytes (and on the logs fixture the -f/-k
bytes) of the one-context engine (``n_shards=8``) and of
``TorchEngine``, but for column 7 of a peak across a tile boundary,
which is TorchEngine's row-order sum over the peak's rows (what K4
gives on a card; its plain version on the CPU sums in float64), as
test_torch_sharded.py holds it.  The JAX package's
``ShardedEngine(n_devices=W)`` on the conftest's virtual devices gets
columns 1-6 identical and columns 7-9 within 1e-5 relative, as
test_torch_sharded.py holds them;
on the ChIP fixture column 7 is held to the port's ``--engine exact``
within 1e-6 instead, as test_torch_chip.py holds it (the JAX twin's
float32 prefix-sum AUC is up to 8e-5 off there, ROADMAP Queue 3).
The collectives over a ``CardGroup`` of two CPU contexts give what two
gloo ranks give.

On a host with CUDA cards (each test skips with fewer than it needs):
K1-K5 launched on ``cuda:1`` equal their plain versions, counted on
card 1; two and four NCCL ranks of the CLI (one card each) write the
bytes of one card and of every card in one process; and several cards
a rank, two ranks of the CLI with ``LOCAL_WORLD_SIZE=2`` on four cards
and one rank of two contexts on cuda:0, write the bytes of one card
with every kernel launched on every card.  These import no jax:
``python -m pytest tests/test_torch_multicard.py -k "second_card or
nccl"``.
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

from genrich_tpu_torch import kernels, params, pipeline
from genrich_tpu_torch.engine import peaks as tpeaks
from genrich_tpu_torch.engine import sharded_bridge
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from genrich_tpu_torch.parallel import mesh

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, HERE)
from test_torch_chip import _chip_args  # noqa: E402

FLAGS = ["-y", "-p", "0.01", "-a", "20"]
BOUNDARY = 524_288          # the contexts' boundary with W = 2 and 4


def _fixture(tmp_path, name):
    """(argv without -o, whether the caps are cut small)."""
    from test_torch_lambda import fisher_straddle_args
    from test_torch_peakcap import many_peaks_sam
    from test_torch_sharded import _straddle_sam
    if name in ("straddle", "logs"):
        sam = _straddle_sam(str(tmp_path / "in.sam"),
                            centers=(131_072, BOUNDARY, 800_000))
        logs = ["-f", "f.log", "-k", "k.log"] if name == "logs" else []
        return ["-t", sam] + FLAGS + logs, False
    if name == "fisher_straddle":
        return fisher_straddle_args(tmp_path), False
    if name == "redispatch":
        return ["-t", many_peaks_sam(str(tmp_path / "in.sam"))] + FLAGS, True
    assert name == "chip_fisher"
    return _chip_args(tmp_path, 2), False


def _run(tmp_path, label, args, engine):
    """``args`` through the port's pipeline on ``engine`` ("exact" for
    none), outputs in tmp/label; returns {output flag: bytes}, perf."""
    d = tmp_path / label
    d.mkdir()
    argv = [str(d / a) if i and args[i - 1] in ("-f", "-k") else a
            for i, a in enumerate(args)] + ["-o", str(d / "out.np")]
    perf = {}
    pipeline.run(params.parse_args(argv),
                 engine=None if engine == "exact" else engine, perf=perf)
    return {f: (d / n).read_bytes() for f, n in
            (("-o", "out.np"), ("-f", "f.log"), ("-k", "k.log"))
            if (d / n).exists()}, perf


def _jax_sharded(tmp_path, args, w):
    """The JAX package's ShardedEngine over ``w`` virtual devices."""
    from genrich_tpu import params as jparams
    from genrich_tpu import pipeline as jpipeline
    from genrich_tpu.engine.sharded_bridge import ShardedEngine
    d = tmp_path / "jax"
    d.mkdir()
    argv = [str(d / a) if i and args[i - 1] in ("-f", "-k") else a
            for i, a in enumerate(args)] + ["-o", str(d / "out.np")]
    jpipeline.run(jparams.parse_args(argv), engine=ShardedEngine(
        n_devices=w))
    return (d / "out.np").read_text().splitlines()


def _torch_engine(tmp_path, args, monkeypatch):
    """TorchEngine's run of ``args`` with its K4 calls kept: its outputs
    and {(start, end): AUC} summed over each peak's own rows in row
    order (``testing.auc_rowwise``, what K4 gives on a card; the CPU's
    plain version sums in float64)."""
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import peaks
    calls = []
    real = peaks.peak_reduce

    def keep(*a):
        calls.append(a)
        return real(*a)
    with monkeypatch.context() as m:
        m.setattr(peaks, "peak_reduce", keep)
        out, _ = _run(tmp_path, "torch", args, TorchEngine("cpu"))
    aucs = {}
    for starts, ends, stat, _, _, sig, first, last, min_pq in calls:
        host = [t.numpy() for t in (starts, ends, stat, sig, first, last)]
        ex = host[5] >= host[4]
        auc = testing.auc_rowwise(*host, min_pq)
        for f, la, a in zip(host[4][ex], host[5][ex], auc[ex]):
            aucs[(int(host[0][f]), int(host[1][la]))] = a
    return out, aucs


def _same_as_torch_engine(got, ref, row_order, tile=1 << 17):
    """The narrowPeak bytes of TorchEngine, but for column 7 of a peak
    across a tile boundary: there the sharded engine's AUC is the
    row-order sum over the peak's rows (K4's on a card), which
    TorchEngine's plain version on the CPU does not take."""
    got, ref = got.decode().splitlines(), ref.decode().splitlines()
    assert len(got) == len(ref)
    for a, b in zip(got, ref):
        fa, fb = a.split("\t"), b.split("\t")
        s, e = int(fa[1]), int(fa[2])
        if a != b:
            assert s // tile < (e - 1) // tile, (a, b)
            assert fa[:6] + fa[7:] == fb[:6] + fb[7:], (a, b)
            assert fa[6] == f"{row_order[(s, e)]:.6f}", (a, b)


def _refuse_host_peaks(*a, **kw):
    raise AssertionError("host peak caller called")


@pytest.mark.parametrize("fixture", ["straddle", "logs", "fisher_straddle",
                                     "redispatch", "chip_fisher"])
@pytest.mark.parametrize("w", [2, 4])
def test_cards_write_the_one_context_bytes(tmp_path, monkeypatch, w,
                                           fixture):
    args, capped = _fixture(tmp_path, fixture)
    if capped:
        monkeypatch.setattr(sharded_bridge, "PEAK_CAP", 4)
        monkeypatch.setattr(tpeaks, "call_peaks_chrom", _refuse_host_peaks)
    eng = ShardedTorchEngine(["cpu"] * w, n_shards=8)
    assert (eng.world, len(eng.devices), eng.cards.size) == (w, w, w)
    got, perf = _run(tmp_path, "cards", args, eng)
    one, one_perf = _run(tmp_path, "one", args,
                         ShardedTorchEngine("cpu", n_shards=8))
    ref, row_order = _torch_engine(tmp_path, args, monkeypatch)
    assert got == one
    assert {f: b for f, b in got.items() if f != "-o"} \
        == {f: b for f, b in ref.items() if f != "-o"}
    _same_as_torch_engine(got["-o"], ref["-o"], row_order)
    assert perf["host_peak_chroms"] == 0
    assert perf["grid_tiles"] == one_perf["grid_tiles"] \
        and perf["grid_tiles"] % w == 0
    # every step ran once on each context
    assert perf["dispatch_n"] > one_perf["dispatch_n"]
    rows = got["-o"].decode().splitlines()
    spans = [(ln.split("\t")[0], int(ln.split("\t")[1]),
              int(ln.split("\t")[2])) for ln in rows]
    if fixture in ("straddle", "fisher_straddle"):
        # a peak across the contexts' boundary, merged from both sides
        assert any(s < BOUNDARY < e for _, s, e in spans), spans
        assert perf["straddling_peaks"] >= 1
    if fixture == "redispatch":
        assert perf["peak_redispatch"] == one_perf["peak_redispatch"] == 2
    want = _jax_sharded(tmp_path, args, w)
    exact = None
    if fixture == "chip_fisher":
        exact = _run(tmp_path, "exact", args, "exact")[0]["-o"]
        exact = exact.decode().splitlines()
    assert len(want) == len(rows) > 2
    for j, (a, b) in enumerate(zip(want, rows)):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7, 8):
            x, tol = float(fa[i]), 1e-5
            if i == 6 and exact is not None:
                x, tol = float(exact[j].split("\t")[6]), 1e-6
            assert abs(x - float(fb[i])) <= tol * max(1.0, abs(x)), (a, b)


def test_engine_on_cards_refuses_what_it_cannot_use(monkeypatch):
    """No fallback: a device this process does not have, a shard count
    the cards do not divide, or ranks of a process group that hold
    unequal card counts (here the gather of the counts stands in for two
    ranks; test_torch_multirank.py runs them), raise."""
    with pytest.raises(RuntimeError, match="CUDA card"):
        ShardedTorchEngine(["cpu", f"cuda:{torch.cuda.device_count()}"])
    with pytest.raises(ValueError, match="multiple"):
        ShardedTorchEngine(["cpu"] * 4, n_shards=6)
    monkeypatch.setattr(mesh, "world_rank", lambda procs: (2, 0))
    monkeypatch.setattr(mesh, "gather_rows",
                        lambda x, procs: torch.cat([x, x - 1]))
    with pytest.raises(ValueError, match=r"\[2, 1\] cards"):
        mesh.CardGroup(["cpu", "cpu"], procs=object())


# --- the collectives ------------------------------------------------------

def _inputs(rank):
    """Shard ``rank``'s inputs of the collective check: [3, 2] int32
    rows, [3] bools, [3, 4] class totals and 1-D rows of rank + 2."""
    rng = np.random.RandomState(rank)
    return (torch.from_numpy(rng.randint(-9, 9, (3, 2)).astype(np.int32)),
            torch.from_numpy(rng.rand(3) < 0.5),
            torch.from_numpy(rng.randint(-3, 4, (3, 4)).astype(np.int32)),
            torch.from_numpy(rng.uniform(0, 1, rank + 2).astype(
                np.float32)))


def _collectives(xs, group):
    """gather_rows of the rows and the bools, exclusive_carries of the
    totals, gather_ragged of the 1-D rows, as lists of ints/floats."""
    rows, flags, totals, ragged = xs
    return [mesh.gather_rows(rows, group), mesh.gather_rows(flags, group),
            mesh.exclusive_carries(totals, group),
            mesh.gather_ragged(ragged, group)]


# A gloo rank of the collective check: argv is repo, tests, output path.
_COLLECTIVE_WORKER = """
import json, sys
sys.path[:0] = sys.argv[1:3]
import torch.distributed as dist
from test_torch_multicard import _collectives, _inputs
from genrich_tpu_torch.parallel import distributed
group = distributed.init_distributed("cpu")
rank = dist.get_rank()
out = _collectives(_inputs(rank), group)
json.dump([x.tolist() for x in out], open(sys.argv[3], "w"))
dist.destroy_process_group()
"""


def test_card_group_collectives_match_two_gloo_ranks(tmp_path):
    from test_torch_parallel import _free_port
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    outs = [str(tmp_path / f"r{i}.json") for i in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-c", _COLLECTIVE_WORKER, REPO, HERE, outs[i]],
        env={**env, "RANK": str(i)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True) for i in (0, 1)]
    logs = [p.communicate(timeout=120) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][1][-2000:]}"
    ranks = [json.load(open(o)) for o in outs]
    group = mesh.CardGroup(["cpu", "cpu"])
    assert mesh.world_rank(group) == (2, 0)
    per_card = [_inputs(r) for r in (0, 1)]
    got = _collectives([list(x) for x in zip(*per_card)], group)
    for j, res in enumerate(got):
        assert isinstance(res, list) and len(res) == 2
        for card, rank in zip(res, ranks):
            assert card.tolist() == rank[j], j
    # the gathers are every card's rows, so both cards agree
    assert got[0][0].dtype == torch.int32 and got[1][0].dtype == torch.bool
    # one card: the identity, as without a group
    one = mesh.CardGroup(["cpu"])
    rows = per_card[0][0]
    assert mesh.gather_rows([rows], one)[0] is rows
    assert mesh.exclusive_carries([per_card[0][2]], one)[0].tolist() \
        == mesh.exclusive_carries(per_card[0][2], None).tolist()


# --- on the cards ---------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _cards(n):
    if torch.cuda.device_count() < n:
        pytest.skip(f"needs {n} CUDA cards, this host has "
                    f"{torch.cuda.device_count()}")


def test_kernels_on_the_second_card_match_plain(cuda):
    """K1-K5 on cuda:1 (their SM-count caches and K5's shared-memory
    attribute are per card) against their plain versions on the CPU,
    each launch counted on card 1."""
    _cards(2)
    from genrich_tpu_torch import testing
    from genrich_tpu_torch.ops import chisq, peaks, pileup, scan
    from genrich_tpu_torch.ops import pipeline as ops
    dev = torch.device("cuda", 1)
    rng = np.random.RandomState(3)
    m = 33 * 4096 + 5
    cols = [rng.randint(-1, 2, m), rng.randint(0, 8, m), rng.randint(0, 3, m),
            rng.randint(0, 5, m)] * 2
    packed = pileup.pack_deltas(torch.from_numpy(
        np.stack(cols, axis=-1).astype(np.int32)))
    carry = torch.tensor([1, 2, 3, 4, 0, 7, 2, 9], dtype=torch.int32)
    ev = torch.from_numpy(rng.uniform(0, 60, m).astype(np.float32))
    cr = torch.from_numpy(rng.uniform(0, 20, m).astype(np.float32))
    ex = torch.from_numpy(rng.rand(m) < 0.05)
    pv = torch.from_numpy(rng.uniform(0, 8, (2, m)).astype(np.float32))
    pv[rng.rand(2, m) < 0.1] = -1.0
    rows = [torch.from_numpy(a) for a in testing.peak_row_columns(
        np.random.RandomState(5), 300_007, 1000)]
    live = torch.ones(rows[0].shape[0], dtype=torch.bool)
    kernels.reset_launches()
    vals, _ = scan.coverage_scan(packed.to(dev), 2, carry.to(dev))
    stats = ops.tile_stats(ev.to(dev), cr.to(dev), ex.to(dev), 1.37, 0.61)
    comb = chisq.fisher_combine(pv.to(dev))
    got = peaks.call_peaks(*(t.to(dev) for t in rows), live.to(dev), 2.0,
                           20.0, 0, 100, k_peaks=rows[0].shape[0])
    torch.cuda.synchronize(dev)
    assert vals.device == dev and got.auc.device == dev
    assert kernels.CARD_LAUNCHES == {1: {
        "coverage_scan": 1, "tile_stats": 1, "fisher_combine": 1,
        "gap_join": 1, "peak_reduce": 1}}
    assert torch.equal(vals.cpu(), scan.coverage_scan_plain(packed, 2,
                                                            carry)[0])
    torch.testing.assert_close(stats.cpu(), ops.tile_stats_plain(
        ev, cr, ex, 1.37, 0.61), rtol=1e-5, atol=1e-5)
    want = chisq.fisher_combine_plain(pv)
    assert torch.equal(comb.cpu() == -1.0, want == -1.0)
    torch.testing.assert_close(comb.cpu(), want, rtol=1e-6, atol=0.0)
    plain = peaks.call_peaks(*rows, live, 2.0, 20.0, 0, 100,
                             k_peaks=rows[0].shape[0])
    c = plain.cand
    assert torch.equal(got.cand.cpu(), c) and int(c.sum()) >= 500
    for f in ("start", "end", "summit_pos", "summit_pval", "summit_stat",
              "summit_len", "valid"):
        assert torch.equal(getattr(got, f).cpu()[c], getattr(plain, f)[c]), f
    torch.testing.assert_close(got.auc.cpu()[c], plain.auc[c], rtol=1e-5,
                               atol=0.0)


def _cli(args, env, out):
    return subprocess.Popen(
        [sys.executable, "-m", "genrich_tpu_torch"] + args + ["-o", out],
        env=env, cwd=REPO, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)


@pytest.mark.parametrize("ranks", [2, 4])
def test_nccl_ranks_write_the_one_card_bytes(cuda, tmp_path, ranks):
    """``--engine sharded`` as ``ranks`` NCCL ranks (one card each),
    on one card (``--device cuda:0``) and over every card of one
    process: the same bytes, the ChIP Fisher fixture."""
    _cards(ranks)
    from test_torch_parallel import _free_port
    args = _chip_args(tmp_path, 2) + ["--engine", "sharded"]
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK",
                        "WORLD_SIZE")}
    env["PYTHONPATH"] = REPO
    one = _cli(args + ["--device", "cuda:0"], env, str(tmp_path / "one.np"))
    every = _cli(args + ["--device", "cuda"], env,
                 str(tmp_path / "every.np"))
    for p in (one, every):
        assert p.wait(timeout=300) == 0, p.stderr.read()[-2000:]
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(ranks))
    procs = [_cli(args + ["--device", "cuda"], {**env, "RANK": str(i)},
                  str(tmp_path / f"r{i}.np")) for i in range(ranks)]
    logs = [p.communicate(timeout=300) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][1][-2000:]}"
    want = (tmp_path / "one.np").read_bytes()
    assert want.count(b"\n") > 10
    assert (tmp_path / "every.np").read_bytes() == want
    for i in range(ranks):
        assert (tmp_path / f"r{i}.np").read_bytes() == want, i


# A rank of the several-cards check: argv is the repo, the engine's
# devices as JSON (null: the CLI with --engine sharded --device cuda),
# then the CLI flags; prints the launches per card and perf.
_RANK = """
import json, sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as td
from genrich_tpu_torch import cli, kernels, pipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
devices, argv = json.loads(sys.argv[2]), sys.argv[3:]
perf = {}
if devices is None:
    assert cli.main(argv + ["--engine", "sharded", "--device", "cuda"],
                    perf=perf) == 0
else:
    p = cli.parse_port_args(argv)
    cli.native_ingest(p)
    eng = ShardedTorchEngine(devices)
    pipeline.run(p, engine=eng, perf=perf)
print(json.dumps({"cards": kernels.CARD_LAUNCHES, "world": [
    td.get_world_size(), td.get_rank()],
    "host_peak_chroms": perf["host_peak_chroms"],
    "loaded": sorted({m.split(".")[0] for m in sys.modules}
                     & {"jax", "genrich_tpu"})}))
td.destroy_process_group()
"""


@pytest.mark.parametrize("form", ["two_ranks_of_two_cards",
                                  "one_rank_of_two_contexts"])
def test_nccl_ranks_of_several_cards_write_the_one_card_bytes(
        cuda, tmp_path, form):
    """Several cards a rank of an NCCL group, on the ChIP Fisher fixture:
    two ranks of the CLI with ``LOCAL_WORLD_SIZE=2`` (each rank two of
    four cards), or one rank of two contexts on cuda:0; each rank writes
    the bytes of one card, with K1-K5 launched on every card and no
    host peak call."""
    from test_torch_parallel import _free_port
    _cards(4 if form == "two_ranks_of_two_cards" else 1)
    args = _chip_args(tmp_path, 2)
    env = {k: v for k, v in os.environ.items()
           if k not in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE",
                        "LOCAL_WORLD_SIZE", "LOCAL_RANK")}
    env["PYTHONPATH"] = REPO
    one = _cli(args + ["--engine", "sharded", "--device", "cuda:0"], env,
               str(tmp_path / "one.np"))
    assert one.wait(timeout=300) == 0, one.stderr.read()[-2000:]
    ranks = 2 if form == "two_ranks_of_two_cards" else 1
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE=str(ranks))
    procs = []
    for r in range(ranks):
        extra = {"LOCAL_WORLD_SIZE": "2", "LOCAL_RANK": str(r)} \
            if ranks == 2 else {}
        devices = None if ranks == 2 else ["cuda:0", "cuda:0"]
        procs.append(subprocess.Popen(
            [sys.executable, "-c", _RANK, REPO, json.dumps(devices)] + args
            + ["-o", str(tmp_path / f"r{r}.np")],
            env={**env, **extra, "RANK": str(r)}, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True))
    try:
        logs = [p.communicate(timeout=300) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    for r, p in enumerate(procs):
        assert p.returncode == 0, f"rank {r}:\n{logs[r][1][-2000:]}"
    want = (tmp_path / "one.np").read_bytes()
    assert want.count(b"\n") > 10
    every = {}
    for r, (out, _) in enumerate(logs):
        rec = json.loads(out.splitlines()[-1])
        assert rec["world"] == [ranks, r] and rec["loaded"] == []
        assert rec["host_peak_chroms"] == 0
        every.update(rec["cards"])
        assert (tmp_path / f"r{r}.np").read_bytes() == want, r
    assert sorted(every) == (["0", "1", "2", "3"] if ranks == 2 else ["0"])
    for c in every.values():
        assert all(n > 0 for n in c.values()), every
