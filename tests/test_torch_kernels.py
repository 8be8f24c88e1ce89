"""CUDA kernels of the port against their plain PyTorch versions.

These tests need a CUDA card (the kernels have no CPU mode) and import
no jax, so they run on a GPU host with ``python -m pytest
tests/test_torch_kernels.py``; without a card each one skips.  Inputs
are made with numpy from a seed.  Tolerances: coverage bitwise,
-log10 p rtol = atol = 1e-5 (CUDA's libm against PyTorch's).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genrich_tpu_torch import kernels
from genrich_tpu_torch.ops import pileup, pipeline, scan

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")
    return torch.device("cuda")


def _packed(seed, m, groups):
    rng = np.random.RandomState(seed)
    cols = []
    for _ in range(groups):
        cols += [rng.randint(-1, 2, m), rng.randint(0, 8, m),
                 rng.randint(0, 3, m), rng.randint(0, 5, m)]
    d = np.stack(cols, axis=-1).astype(np.int32)
    return pileup.pack_deltas(torch.from_numpy(d))


@pytest.mark.parametrize("m", [1, 2047, 2048, 3 * 2048 + 77, 1 << 20])
def test_coverage_scan_two_groups(cuda, m):
    packed = _packed(3, m, 2).to(cuda)
    carry = torch.tensor([1, 2, 3, 4, 0, 7, 2, 9], dtype=torch.int32,
                         device=cuda)
    kernels.reset_launches()
    vals, pval = scan.coverage_scan(packed, 2, carry)
    torch.cuda.synchronize()
    assert pval is None and kernels.LAUNCHES["coverage_scan"] == 1
    ref, _ = scan.coverage_scan_plain(packed, 2, carry)
    assert torch.equal(vals, ref)


@pytest.mark.parametrize("m", [4096, 3 * 2048 + 77])
def test_coverage_scan_lambda_mode(cuda, m):
    packed = _packed(4, m, 1).to(cuda)
    vals, pval = scan.coverage_pval_fused(packed, 2.5)
    torch.cuda.synchronize()
    ref_v, ref_p = scan.coverage_scan_plain(
        packed, 1, torch.zeros(4, dtype=torch.int32, device=cuda), 2.5)
    assert torch.equal(vals, ref_v[0])
    torch.testing.assert_close(pval, ref_p, rtol=1e-5, atol=1e-5)


def test_tile_stats_kernel(cuda):
    rng = np.random.RandomState(5)
    m = 100_003
    ev = torch.from_numpy(rng.uniform(0, 60, m).astype(np.float32))
    cr = torch.from_numpy(rng.uniform(0, 20, m).astype(np.float32))
    ev[:100] = 0.0
    cr[100:200] = 0.0
    ex = torch.from_numpy(rng.rand(m) < 0.05)
    args = [t.to(cuda) for t in (ev, cr, ex)]
    kernels.reset_launches()
    pv = pipeline.tile_stats(*args, 1.37, 0.61)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tile_stats"] == 1
    torch.testing.assert_close(pv, pipeline.tile_stats_plain(*args, 1.37,
                                                             0.61),
                               rtol=1e-5, atol=1e-5)
    torch.testing.assert_close(pv.cpu(), pipeline.tile_stats(
        ev, cr, ex, 1.37, 0.61), rtol=1e-5, atol=1e-5)


def test_tile_coverage_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(14)
    length = 80_000
    es = rng.randint(0, length - 500, 3000).astype(np.int32)
    ee = (es + rng.randint(30, 400, 3000)).astype(np.int32)
    ec = rng.choice([1, 2, 3, 4, 5, 6, 8, 10], 3000).astype(np.uint8)
    cs = rng.randint(0, length - 500, 900).astype(np.int32)
    ce = (cs + rng.randint(30, 400, 900)).astype(np.int32)
    cc = np.ones(900, np.uint8)
    excl = np.array([[1000, 5000], [length, length]], np.int32)
    host = [torch.from_numpy(a) for a in (es, ee, ec, cs, ce, cc, excl)]
    z4 = torch.zeros(4, dtype=torch.int32)
    ref = pipeline.tile_coverage(*host, length, z4, z4)
    got = pipeline.tile_coverage(*(t.to(cuda) for t in host), length,
                                 z4.to(cuda), z4.to(cuda))
    got = [x.cpu() for x in got]
    real = ref[1] > ref[0]
    for i in (0, 1, 4, 5):
        assert torch.equal(got[i], ref[i])
    for i in (2, 3):
        assert torch.equal(got[i][real], ref[i][real])
    for i in (6, 7):
        torch.testing.assert_close(got[i], ref[i], rtol=1e-6, atol=0.0)


def test_cli_on_card_matches_cpu(cuda, tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=71)
    outs = {}
    for dev in ("cpu", "cuda"):
        r = subprocess.run(
            [sys.executable, "-m", "genrich_tpu_torch", "-t",
             str(tmp_path / "in.sam"), "-o", f"{dev}.np", "-y", "-p",
             "0.01", "-a", "20", "--device", dev], cwd=str(tmp_path),
            capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": oracle.REPO})
        assert r.returncode == 0, r.stderr[-1500:]
        outs[dev] = (tmp_path / f"{dev}.np").read_text().splitlines()
    assert outs["cpu"] and len(outs["cpu"]) == len(outs["cuda"])
    for a, b in zip(outs["cpu"], outs["cuda"]):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7):
            assert abs(float(fa[i]) - float(fb[i])) \
                <= 1e-4 * max(1.0, abs(float(fa[i]))), (a, b)
