"""The port's tile helpers and distributed layer against the JAX package's.

The numpy copies in ``genrich_tpu_torch.parallel`` (the tile splitters,
the boundary merge and its loop oracle, the exact BH over gathered
tables) are bitwise equal to ``genrich_tpu.parallel.mesh``'s on the
cases of test_tile_split.py, test_mesh_merge.py and
test_compact_jax.py:73-93; the sharded engine's flat staging wire
round-trips; ``local_tile_range`` keeps the JAX module's contract.
Then ``ShardedTorchEngine`` through ``pipeline.run`` on two gloo ranks
(spawned processes) against one process, on peaks that straddle a tile
boundary inside a rank and the boundary between the ranks (a 1 Mbp
chromosome, and dist2_worker's draw without its control): the same
narrowPeak bytes (the row-order AUC gathers each straddling peak's
rows from both ranks); and on two replicates whose
Fisher peak straddles the ranks' boundary, column 10 equal to the exact
engine's (each tile's ``cont`` from the previous rank's last run).
"""

from __future__ import annotations

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (8 virtual CPU devices for JAX)
import dist2_worker as w
import torch

from genrich_tpu.ops.pipeline_jax import TileResult
from genrich_tpu.parallel import mesh as jmesh
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.parallel import distributed as tdist
from genrich_tpu_torch.parallel import mesh as tmesh
from genrich_tpu_torch.testing import check_summits
from test_mesh_merge import _rand_tilepeaks
from test_tile_split import _random_events
from test_torch_lambda import fisher_straddle_args
from test_torch_sharded import _exact, _straddle_sam

import oracle  # noqa: E402  (tests/ is on the path: dist2_worker)

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)


def _equal(got, want):
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
        assert g.dtype == x.dtype


def _split_case(case):
    if case in (300, 5000, 40000):
        n_tiles, tile_len = 16, 1 << 12
        ev = _random_events(np.random.RandomState(case), 3000,
                            n_tiles * tile_len, case)
        return ev + (n_tiles, tile_len), {}
    if case == "whole_genome":
        return (np.array([0]), np.array([8 * 1024]), np.array([1], np.int32),
                8, 1024), {}
    if case == "exact_end":
        return (np.array([500, 1000]), np.array([1000, 2000]),
                np.array([1, 2], np.int32), 4, 1000), {}
    if case == "grow":
        return (np.zeros(10, np.int64), np.full(10, 5, np.int64),
                np.ones(10, np.int32), 2, 1000), {"pad_to": 4}
    assert case == "empty"
    return (np.zeros(0), np.zeros(0), np.zeros(0, np.int32), 3, 100), \
        {"pad_to": 8}


@pytest.mark.parametrize("case", [300, 5000, 40000, "whole_genome",
                                  "exact_end", "grow", "empty"])
def test_split_events_to_tiles_equal(case):
    args, kw = _split_case(case)
    _equal(tmesh.split_events_to_tiles(*args, **kw),
           jmesh.split_events_to_tiles(*args, **kw))


@pytest.mark.parametrize("case", [300, 5000, 40000, "whole_genome",
                                  "exact_end", "grow", "empty"])
def test_split_events_flat_is_the_padded_split(case):
    """``split_events_flat`` (the port's own) holds each tile's pieces of
    the JAX split in the same order, without the padding rows."""
    (start, end, count, n_tiles, tile_len), kw = _split_case(case)
    s, e, c, off = tmesh.split_events_flat(start, end, count, n_tiles,
                                           tile_len)
    ps, pe, pc = jmesh.split_events_to_tiles(start, end, count, n_tiles,
                                             tile_len, **kw)
    assert off[0] == 0 and (np.diff(off) >= 0).all() and off[-1] == len(s)
    for t in range(n_tiles):
        n = off[t + 1] - off[t]
        _equal([s[off[t]:off[t + 1]], e[off[t]:off[t + 1]],
                c[off[t]:off[t + 1]]], [ps[t, :n], pe[t, :n], pc[t, :n]])
        assert (ps[t, n:] == tile_len).all() and (pc[t, n:] == 0).all()


@pytest.mark.parametrize("args,kw", [
    ((np.zeros(10, np.int64), np.full(10, 5, np.int64),
      np.ones(10, np.int32), 2, 1000), {"pad_to": 4, "on_overflow": "error"}),
    ((np.array([5]), np.array([5]), np.array([1], np.int32), 2, 100), {}),
    ((np.array([250]), np.array([260]), np.array([1], np.int32), 2, 100),
     {})], ids=["overflow", "empty_event", "off_grid"])
def test_split_events_to_tiles_same_errors(args, kw):
    msgs = []
    for mod in (jmesh, tmesh):
        with pytest.raises(ValueError) as e:
            mod.split_events_to_tiles(*args, **kw)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("seed,density", [(0, 50), (1, 2000), (2, 200000),
                                          ("edges", 0)])
def test_split_excl_to_tiles_equal(seed, density):
    if seed == "edges":
        for bed, n, tl in (([], 3, 100), ([5, 5, 350, 360, 90, 210], 3, 100)):
            _equal([tmesh.split_excl_to_tiles(bed, n, tl)],
                   [jmesh.split_excl_to_tiles(bed, n, tl)])
        return
    n_tiles, tile_len = 16, 1 << 12
    rng = np.random.RandomState(seed)
    a = np.sort(rng.randint(0, n_tiles * tile_len - 1, density))
    b = np.minimum(a + rng.choice([1, 1, 1, 5, 100, 9000], density),
                   n_tiles * tile_len)
    bed = np.empty(2 * density, np.int64)
    bed[0::2], bed[1::2] = a, b
    _equal([tmesh.split_excl_to_tiles(bed, n_tiles, tile_len)],
           [jmesh.split_excl_to_tiles(bed, n_tiles, tile_len)])


def _same_peaks(got, want):
    assert len(got) == len(want)
    for g, x in zip(got, want):
        assert g == x and all(type(a) is type(b) for a, b in zip(g, x))


@pytest.mark.parametrize("trial", range(12))
def test_merge_tile_peaks_equal(trial):
    rng = np.random.RandomState(100 + trial)
    tile_len = 4096
    pk = _rand_tilepeaks(rng, int(rng.randint(1, 40)),
                         int(rng.randint(1, 16)), tile_len, trial % 3 == 2)
    res = TileResult(pk, None, None)
    args = (tile_len, float(rng.rand() * 30), int(rng.randint(0, 50)),
            int(rng.randint(0, 200)))
    want = jmesh.merge_tile_peaks(res, *args)
    _same_peaks(tmesh.merge_tile_peaks(res, *args), want)
    _same_peaks(tmesh._merge_tile_peaks_loop(res, *args),
                jmesh._merge_tile_peaks_loop(res, *args))
    _same_peaks(tmesh._merge_tile_peaks_loop(res, *args), want)


def test_merge_tile_peaks_dense_10k_tiles_equal():
    res = TileResult(_rand_tilepeaks(np.random.RandomState(5), 10_000, 64,
                                     1 << 16), None, None)
    got = tmesh.merge_tile_peaks(res, 1 << 16, 10.0, 0, 100)
    assert len(got) > 1000
    _same_peaks(got, jmesh.merge_tile_peaks(res, 1 << 16, 10.0, 0, 100))


def _gathered_tables(k):
    """Three shards' distinct tables of the test_compact_jax.py:73-93
    kind, at fixed stride k: (p, bp, counts)."""
    rng = np.random.RandomState(3)
    pv, wt, d = [], [], []
    for n in (257, 40, 0):
        p = np.unique(rng.choice(np.arange(0, 60, 0.5, dtype=np.float32),
                                 n))
        pv.append(np.concatenate([p, np.full(k - len(p), np.inf,
                                             np.float32)]))
        wt.append(np.concatenate([rng.randint(1, 10_000, len(p)),
                                  np.zeros(k - len(p), np.int64)]))
        d.append(len(p))
    return np.concatenate(pv), np.concatenate(wt), np.array(d, np.int32)


def test_exact_q_table_equal():
    k = 128
    pv, wt, d = _gathered_tables(k)
    got = tmesh.exact_q_table(pv, wt, d, k, 5_000_000)
    want = jmesh.exact_q_table(pv, wt, d, k, 5_000_000)
    _equal(got[:2], want[:2])
    assert got[2:] == want[2:] and d[:2].min() > 1
    for mod in (tmesh, jmesh):
        with pytest.raises(ValueError, match="overflow"):
            mod.exact_q_table(pv, wt, d + k, k, 5_000_000)


def test_stage_events_flat_wire_roundtrip():
    """The flat tile-major wire of ``split_events_flat`` (starts, ends,
    count codes and [T+1] offsets) expands to the padded [T, w] triple
    on the device, equal to the JAX engine's ``_stage_events`` of the
    JAX split (int32 ends and the JAX uint16-length wire give the same
    triple), the no-event case included; a piece longer than 2^16 bp
    rides the same int32 wire."""
    from genrich_tpu.engine.sharded_bridge import ShardedEngine
    jeng = ShardedEngine(n_devices=1)
    eng = ShardedTorchEngine("cpu")
    tile_len, n_tiles, wd = 1 << 12, 8, 64
    rng = np.random.RandomState(3)
    s = np.sort(rng.randint(0, n_tiles * tile_len - 40, 200).astype(np.int64))
    e = np.minimum(s + rng.randint(1, 5000, 200), n_tiles * tile_len)
    c = rng.randint(1, 11, 200).astype(np.int64)
    none = np.zeros(0, np.int64)
    for ev, padded in (((s, e, c), jmesh.split_events_to_tiles(
            s, e, c, n_tiles, tile_len)),
            ((none,) * 3, (np.full((n_tiles, 0), tile_len, np.int64),) * 3)):
        flat = tmesh.split_events_flat(*ev, n_tiles, tile_len)
        got = [x.numpy() for x in eng._stage_events(*flat, wd, tile_len)]
        want = [np.asarray(x) for x in jeng._stage_events(*padded, wd,
                                                          tile_len)]
        _equal(got, want)
        assert (got[2][got[0] == tile_len] == 0).all()
    big = 1 << 18
    flat = tmesh.split_events_flat(np.array([0]), np.array([big]),
                                   np.array([1]), 2, big)
    ds, de, dc = (x.numpy() for x in eng._stage_events(*flat, 4, big))
    assert ds[0, 0] == 0 and de[0, 0] == big and dc[0, 0] == 1
    assert (ds[0, 1:] == big).all() and (dc[1] == 0).all()
    assert eng.perf["upload_bytes"] > 0


def test_local_tile_range_single():
    assert list(tdist.local_tile_range(8)) == list(range(8))


# --- two gloo ranks ---------------------------------------------------------

def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


# A rank of the two-process engine run: argv is repo, the engine's least
# tile length, then the CLI flags.
_ENGINE_WORKER = """
import sys
sys.path.insert(0, sys.argv[1])
import torch.distributed as td
from genrich_tpu_torch import params, pipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
perf = {}
pipeline.run(params.parse_args(sys.argv[3:]),
             engine=ShardedTorchEngine("cpu", n_shards=8,
                                       min_tile_len=int(sys.argv[2])),
             perf=perf)
print("RUN", td.get_world_size(), perf["straddling_peaks"])
td.destroy_process_group()
"""


def _two_ranks(tmp_path, args, min_tile_len=1 << 16):
    """``args`` through ShardedTorchEngine on two gloo ranks (processes),
    each writing tmp/r{rank}.np; returns their stdout."""
    env = {k: v for k, v in os.environ.items()
           if k not in ("XLA_FLAGS", "PYTHONPATH")}
    env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=str(_free_port()),
               WORLD_SIZE="2", GLOO_SOCKET_IFNAME="lo")
    procs = [subprocess.Popen(
        [sys.executable, "-c", _ENGINE_WORKER, REPO, str(min_tile_len)]
        + args + ["-o", str(tmp_path / f"r{i}.np")],
        env={**env, "RANK": str(i)}, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
        for i in (0, 1)]
    logs = [p.communicate(timeout=300) for p in procs]
    for i, p in enumerate(procs):
        assert p.returncode == 0, f"rank {i}:\n{logs[i][1][-2000:]}"
    return [out for out, _ in logs]


def _dist2_sam(path):
    """dist2_worker's treatment draw, without its control, as pairs on
    one chromosome of 8 x 4,096 bp: an event of weight 1/c is one of a
    read's c alignments of equal score, the events of each weight taken
    c at a time in draw order (a remainder of fewer is left out)."""
    (start, end, count), _ = w.make_fixture()
    b = oracle.SamBuilder([("chr1", w.GENOME_LEN)])
    for c in np.unique(count).tolist():
        idx = np.flatnonzero(count == c)
        for j in range(0, len(idx) - c + 1, c):
            q = None
            for i in idx[j:j + c].tolist():
                q = b.add_pair("chr1", int(start[i]), int(end[i]) - 50,
                               score=0, secondary=q is not None, qname=q)
    return b.write(path)


@pytest.mark.parametrize("case", ["straddle", "dist2_no_control"])
def test_two_gloo_ranks_sharded_engine_match_one_process(tmp_path, case):
    """Peaks across a tile boundary inside a rank and across the ranks'
    boundary: on a 1 Mbp chromosome of 2^17-bp tiles, and on
    dist2_worker's draw (weights 1, 1/2 and 1/5, its -E regions, -q) on
    tiles of 4,096 bp, whose cluster straddles the ranks' boundary."""
    if case == "straddle":
        sam = _straddle_sam(str(tmp_path / "in.sam"),
                            centers=(131_072, 524_288, 800_000))
        args = ["-t", sam, "-y", "-p", "0.01", "-a", "20"]
        tile, edges, n_straddling = 1 << 16, (131_072, 524_288), 2
    else:
        bed = tmp_path / "x.bed"
        ex = w.EXCL_BED
        bed.write_text("".join(f"chr1\t{ex[i]}\t{ex[i + 1]}\n"
                               for i in range(0, len(ex), 2)))
        args = ["-t", _dist2_sam(str(tmp_path / "in.sam")), "-y", "-q",
                "0.05", "-a", "20", "-E", str(bed)]
        tile, edges, n_straddling = w.TILE_LEN, (4 * w.TILE_LEN,), 1
    for out in _two_ranks(tmp_path, args, tile):
        assert f"RUN 2 {n_straddling}" in out, out
    from genrich_tpu_torch import params, pipeline
    pipeline.run(params.parse_args(args + ["-o", str(tmp_path / "one.np")]),
                 engine=ShardedTorchEngine("cpu", n_shards=8,
                                           min_tile_len=tile))
    one = (tmp_path / "one.np").read_bytes()
    assert (tmp_path / "r0.np").read_bytes() == one \
        == (tmp_path / "r1.np").read_bytes()
    spans = [(int(f[1]), int(f[2])) for f in
             (ln.split("\t") for ln in one.decode().splitlines())]
    for edge in edges:
        assert any(s < edge < e for s, e in spans), (edge, spans)


def test_two_gloo_ranks_sharded_fisher_straddle(tmp_path):
    """Two replicates whose Fisher peak straddles the boundary between
    the two ranks' tiles (524,288), its highest interval cut there: the
    ``cont`` of the later rank's first tile comes from the earlier
    rank's last run.  Both ranks write one process's bytes, and column
    10 equals the exact engine's on every row, with no near tie."""
    args = fisher_straddle_args(tmp_path)
    for out in _two_ranks(tmp_path, args):
        assert "RUN 2 " in out and int(out.split()[-1]) >= 1, out
    from genrich_tpu_torch import params, pipeline
    pipeline.run(params.parse_args(args + ["-o", str(tmp_path / "one.np")]),
                 engine=ShardedTorchEngine("cpu", n_shards=8))
    one = (tmp_path / "one.np").read_bytes()
    assert (tmp_path / "r0.np").read_bytes() == one \
        == (tmp_path / "r1.np").read_bytes()
    exact, log = _exact(tmp_path, args + ["-o", "out.np"])
    got = one.decode().splitlines()
    assert any(ln.split("\t")[1:3] == ["524119", "524457"] for ln in got)
    assert check_summits(exact, got, log, 1e-4) == (len(exact), 0)


def test_distributed_layer_is_local_without_a_group():
    """No MASTER_ADDR/WORLD_SIZE/RANK: no group, local steps."""
    assert not torch.distributed.is_initialized()
    assert tdist.init_distributed("cpu") is None
    assert tmesh.gather_rows(torch.arange(3), None).tolist() == [0, 1, 2]
