"""Fragment sums, lambda and the control factor of the device engines,
and the summits of sharded Fisher peaks that straddle a tile boundary.

``tile_coverage``'s fragment sums (``ops/pipeline.frag_sum``) are the
same bits for 1, 2, 3 and 8 CPU threads on more than 2^17 terms of
fractional pileup values (a float32 ``.sum()`` splits its work by the
thread count).  On the ATAC fixtures of scripts/perf_synth.py (``-r -j``,
whole weights, so every term is an integer), both device engines'
fragment sums, lambda and control factor equal ``--engine exact``'s
bitwise.  Then two replicates whose merged Fisher peak straddles a tile
boundary of the sharded engine (2^17-bp tiles), its highest interval
cut by the boundary: column 10 equals the exact engine's on every row
with no near tie (``merge_tile_peaks``' best of the tiles' summits took
the midpoint of a piece of that interval).
"""

from __future__ import annotations

import os
import sys

import numpy as np
import pytest
import torch

from genrich_tpu_torch import params as tparams
from genrich_tpu_torch import pipeline as tpipeline
from genrich_tpu_torch.engine.sharded_bridge import ShardedTorchEngine
from genrich_tpu_torch.engine.torch_bridge import TorchEngine
from genrich_tpu_torch.ops import pipeline
from genrich_tpu_torch.testing import check_summits

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402
from test_torch_sharded import (BASE, _exact, _lines, _port,  # noqa: E402
                                _straddle_sam)

F32 = np.float32
WEIGHTS = (1, 2, 3, 4, 5, 6, 8, 10)     # count codes: weight 1/N


def _events(rng, n, length):
    start = rng.randint(0, length - 500, n)
    end = start + rng.randint(60, 400, n)
    code = rng.choice(WEIGHTS, n)
    return [torch.from_numpy(a.astype(np.int32)) for a in (start, end)] \
        + [torch.from_numpy(code.astype(np.uint8))]


def test_frag_sums_do_not_depend_on_the_thread_count():
    rng = np.random.RandomState(5)
    length = 4_000_000
    ev, cv = _events(rng, 45_000, length), _events(rng, 25_000, length)
    excl = torch.tensor([[10_000, 60_000], [length, length]],
                        dtype=torch.int32)
    zero4 = torch.zeros(4, dtype=torch.int32)
    before = torch.get_num_threads()
    sums = {}
    try:
        for n in (1, 2, 3, 8):
            torch.set_num_threads(n)
            out = pipeline.tile_coverage(*ev, *cv, excl, length, zero4,
                                         zero4)
            sums[n] = (out[6], out[7])
    finally:
        torch.set_num_threads(before)
    assert out[0].shape[0] >= 1 << 17
    # the values are fractional (weights 1/N), so the terms round
    assert bool((out[2] != out[2].round()).any())
    for n, (f, c) in sums.items():
        assert f.dtype == c.dtype == torch.float64
        assert f.item() == sums[1][0].item() and c.item() == sums[1][1]\
            .item(), n


def test_frag_sum_is_the_chunked_float64_sum():
    """``frag_sum`` adds float32 terms in float64, FRAG_CHUNK at a time,
    whatever the count (a ragged last chunk, a single term)."""
    rng = np.random.RandomState(6)
    for n in (1, 4095, 4097, 3 * 4096):
        t = rng.uniform(0, 1e3, n).astype(F32)
        want = np.cumsum([np.sum(t[i:i + 4096].astype(np.float64))
                          for i in range(0, n, 4096)])[-1]
        got = pipeline.frag_sum(torch.from_numpy(t))
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.item(), want, rtol=1e-15)


def _synth(tmp_path):
    sys.path.insert(0, os.path.join(oracle.REPO, "scripts"))
    import perf_synth
    chroms = (("chr1", 150_000), ("chr2", 100_000))
    for name, seed in (("a.bam", 7), ("b.bam", 8)):
        perf_synth.synth_bam(str(tmp_path / name), 30_000, seed=seed,
                             chroms=chroms)
    return str(tmp_path / "a.bam"), str(tmp_path / "b.bam")


def _wrap(monkeypatch, obj, name, seen):
    real = getattr(obj, name)

    def keep(*args):
        out = real(*args)
        seen.setdefault(name, []).append((args, out))
        return out
    monkeypatch.setattr(obj, name, keep)


def _run(tmp_path, monkeypatch, argv, engine):
    """One pipeline.run; returns (fragment sums, lambda, factor) as the
    engine (or, for None, the exact engine) took them."""
    seen = {}
    if engine is None:
        _wrap(monkeypatch, tpipeline, "_calc_lambda", seen)
        _wrap(monkeypatch, tpipeline, "calc_factor", seen)
    else:
        _wrap(monkeypatch, engine, "coverage_finish", seen)
        _wrap(monkeypatch, engine, "stats_all", seen)
    tpipeline.run(tparams.parse_args(argv + ["-o", str(tmp_path / "o.np")]),
                  engine=engine)
    monkeypatch.undo()
    if engine is None:
        (args, lam), = seen["_calc_lambda"]
        if "calc_factor" not in seen:
            return (args[1], None), lam, None
        (fargs, factor), = seen["calc_factor"]
        return fargs, lam, factor
    (_, frags), = seen["coverage_finish"]
    ((lam, factor), _), = seen["stats_all"]
    return frags, F32(lam), F32(factor)


@pytest.mark.parametrize("ctrl", [False, True])
def test_device_lambda_is_the_exact_engines(tmp_path, monkeypatch, ctrl):
    a, b = _synth(tmp_path)
    argv = ["-t", a, "-r", "-j", "-q", "0.05", "-a", "20"]
    if ctrl:
        argv += ["-c", b]
    (frag, cfrag), lam, factor = _run(tmp_path, monkeypatch, argv, None)
    assert frag > 1e6 and frag == int(frag)
    for eng in (TorchEngine("cpu"), ShardedTorchEngine("cpu", n_shards=8)):
        (f, c), lam_d, factor_d = _run(tmp_path, monkeypatch, argv, eng)
        assert f == frag, type(eng).__name__
        assert lam_d.view(np.uint32) == lam.view(np.uint32)
        if ctrl:
            assert c == cfrag and factor_d.view(np.uint32) \
                == F32(factor).view(np.uint32)
            assert factor_d != F32(1.0)
        else:
            assert c == 0.0 and factor_d == F32(1.0)
        eng.release()


def fisher_straddle_args(tmp_path):
    """Two replicates (seeds 5 and 6) whose Fisher peak at 524,288, a
    tile boundary (n_shards=8: 2^17-bp tiles) and the boundary of two
    ranks' tiles, has its highest interval cut by it."""
    sams = [_straddle_sam(str(tmp_path / f"r{s}.sam"), seed=s,
                          spanning=100) for s in (5, 6)]
    return ["-t", ",".join(sams)] + BASE[2:]


def test_sharded_fisher_straddling_summit_is_the_exact_engines(tmp_path):
    """Column 10 equals the exact engine's on every row, with no near
    tie, where the sharded Fisher rows now carry ``cont``; before, the
    straddling peak at 524,119 took the best of its tiles' summits
    (244, a near tie at 1e-4) where the exact engine has 202."""
    args = fisher_straddle_args(tmp_path) + ["-o", "out.np"]
    got_d, perf = _port(tmp_path, args)
    got = _lines(got_d)
    exact, log = _exact(tmp_path, args)
    assert [a.split("\t")[:6] for a in got] \
        == [c.split("\t")[:6] for c in exact]
    assert perf["straddling_peaks"] >= 1
    spans = [(int(f[1]), int(f[2]), int(f[9])) for f in
             (ln.split("\t") for ln in got)]
    assert (524_119, 524_457, 202) in spans
    assert check_summits(exact, got, log, 1e-4) == (len(exact), 0)
