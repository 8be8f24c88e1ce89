"""CUDA kernels of the port against their plain PyTorch versions.

These tests need a CUDA card (the kernels have no CPU mode) and import
no jax, so they run on a GPU host with ``python -m pytest
tests/test_torch_kernels.py``; without a card each one skips.  Inputs
are made with numpy from a seed.  Tolerances: coverage bitwise,
-log10 p rtol = atol = 1e-5 (CUDA's libm against PyTorch's); Fisher
combination (K3) rtol 1e-6 against the float64 plain version, SKIP
lanes identical; peak reduction (K4) summit fields exact, AUC rtol 1e-5
against the plain version (a float32 sum in row order against a
float64 prefix difference) and bitwise against the exact engine's
row-order float32 sum (``testing.auc_rowwise``).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from genrich_tpu_torch import kernels, testing
from genrich_tpu_torch.ops import (chisq, compact, peaks, pileup, pipeline,
                                   scan)

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


def _fisher_rows(seed, r, n):
    rng = np.random.RandomState(seed)
    pv = rng.uniform(0, 8, (r, n)).astype(np.float32)
    pv[rng.rand(r, n) < 0.1] = -1.0               # 10% SKIP lanes
    pv[:, :50] = -1.0                             # no live replicate
    pv[:, 50:80] = 0.0                            # zero totals
    pv[0, 80:100] = rng.uniform(200, 3000, 20)    # far tails
    return torch.from_numpy(pv)


@pytest.mark.parametrize("r,n", [(2, 1), (2, 4099), (3, 100_003),
                                 (5, 2048)])
def test_fisher_combine_kernel(cuda, r, n):
    pv = _fisher_rows(r + n, r, max(n, 100))[:, :n].contiguous().to(cuda)
    kernels.reset_launches()
    got = chisq.fisher_combine(pv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fisher_combine"] == 1
    want = chisq.fisher_combine_plain(pv)
    assert torch.equal(got == -1.0, want == -1.0)
    torch.testing.assert_close(got, want, rtol=1e-6, atol=0.0)
    torch.testing.assert_close(got.cpu(), chisq.fisher_combine(pv.cpu()),
                               rtol=1e-6, atol=0.0)


def test_merge_fisher_on_card_matches_cpu(cuda):
    rng = np.random.RandomState(9)
    reps = []
    for _ in range(3):
        ends = np.unique(rng.randint(1, 50_000, 3000)).astype(np.int32)
        ends[-1] = 50_000
        pv = rng.uniform(0, 6, len(ends)).astype(np.float32)
        pv[rng.rand(len(ends)) < 0.05] = -1.0
        reps.append((torch.from_numpy(ends), torch.from_numpy(pv)))
    want = compact.merge_fisher([e for e, _ in reps], [p for _, p in reps])
    got = compact.merge_fisher([e.to(cuda) for e, _ in reps],
                               [p.to(cuda) for _, p in reps])
    for i in (0, 1, 3):
        assert torch.equal(got[i].cpu(), want[i])
    torch.testing.assert_close(got[2].cpu(), want[2], rtol=1e-6, atol=0.0)


def _peak_rows(seed, m, n_regions, **kw):
    """testing.peak_rows as (starts, ends, stat, pval, qval) tensors."""
    ends, stat, pval, qval = testing.peak_rows(np.random.RandomState(seed),
                                               m, n_regions, **kw)
    starts = np.concatenate([[0], ends[:-1]])
    return [torch.from_numpy(a) for a in (starts.astype(np.int32),
                                          ends.astype(np.int32), stat,
                                          pval, qval)]


def _check_peaks(got, want):
    assert torch.equal(got.cand.cpu(), want.cand)
    c = want.cand
    for f in ("start", "end", "summit_pos", "summit_pval", "summit_qval",
              "summit_stat", "summit_len", "valid"):
        assert torch.equal(getattr(got, f).cpu()[c], getattr(want, f)[c]), f
    torch.testing.assert_close(got.auc.cpu()[c], want.auc[c], rtol=1e-5,
                               atol=0.0)
    return int(c.sum())


@pytest.mark.parametrize("m,regions", [(1, 0), (5000, 40),
                                       (300_007, 1000)])
def test_peak_reduce_kernel(cuda, m, regions):
    rows = _peak_rows(m + regions, m, regions)
    live = torch.ones(m, dtype=torch.bool)
    args = (2.0, 20.0, 0, 100)
    want = peaks.call_peaks(*rows, live, *args, k_peaks=m)
    kernels.reset_launches()
    got = peaks.call_peaks(*(t.to(cuda) for t in rows), live.to(cuda),
                           *args, k_peaks=m)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["peak_reduce"] == 1
    assert _check_peaks(got, want) >= regions // 2


@pytest.mark.parametrize("m,regions,region_rows,max_gap", [
    (300_007, 1000, (3, 40), 100),
    # main-path peak lengths: hundreds to thousands of rows each
    (400_000, 40, (1000, 6000), 10_000)])
def test_peak_reduce_kernel_auc_in_row_order(cuda, m, regions,
                                             region_rows, max_gap):
    """AUC bitwise equal to the exact engine's float32 row-order sum
    (testing.auc_rowwise), summit fields equal to the plain version."""
    rows = _peak_rows(m, m, regions, region_rows=region_rows,
                      skip_frac=0.0)
    c = peaks.peak_candidates(*(t.to(cuda) for t in rows[:3]),
                              torch.ones(m, dtype=torch.bool, device=cuda),
                              2.0, max_gap, 4096)
    args = [t.to(cuda) for t in rows] + [c.sig, c.pid, c.first, c.last,
                                         2.0]
    got = [t.cpu() for t in peaks.peak_reduce(*args)]
    want = [t.cpu() for t in peaks.peak_reduce_plain(*args)]
    ex = c.exists.cpu()
    assert int(ex.sum()) >= regions // 2
    for g, w in list(zip(got, want))[1:]:
        assert torch.equal(g[ex], w[ex])
    first, last = c.first.cpu().numpy(), c.last.cpu().numpy()
    ref = testing.auc_rowwise(*(t.numpy() for t in rows[:3]),
                              c.sig.cpu().numpy(), first, last, 2.0)
    assert np.array_equal(got[0].numpy()[ex.numpy()], ref[ex.numpy()])


def test_peak_reduce_kernel_summit_tie_rules(cuda):
    """test_torch_pipeline.py::test_call_peaks_summit_tie_rules on the
    card: the position goes to max stat, then longest, then earliest;
    p/q come from the first max-stat row (Genrich.c:948-964)."""
    starts = np.array([0, 10, 20, 35, 40, 60, 70, 80], np.int32)
    ends = np.array([10, 20, 35, 40, 60, 70, 80, 95], np.int32)
    stat = np.array([1, 5, 5, 3, 5, 9, 9, 9], np.float32)
    pval = np.arange(8, dtype=np.float32) + 100
    qval = np.arange(8, dtype=np.float32) + 200
    rows = [torch.from_numpy(a).to(cuda)
            for a in (starts, ends, stat, pval, qval)]
    got = peaks.call_peaks(*rows, torch.ones(8, dtype=torch.bool,
                                             device=cuda),
                           2.0, 0.0, 0, 100, k_peaks=8)
    k = int(torch.nonzero(got.cand).flatten()[0])
    assert int(got.cand.sum()) == 1
    assert int(got.summit_pos[k]) == (80 + 95) // 2 - 10
    assert float(got.summit_pval[k]) == 105.0
    assert float(got.summit_qval[k]) == 205.0
    # every sig row in order: len * (stat - 2), integers, exact in f32
    assert float(got.auc[k]) == 10 * 3 + 15 * 3 + 5 * 1 + 20 * 3 \
        + 10 * 7 + 10 * 7 + 15 * 7


def test_peak_reduce_kernel_is_deterministic(cuda):
    rows = [t.to(cuda) for t in _peak_rows(11, 400_000, 1500)]
    live = torch.ones(400_000, dtype=torch.bool, device=cuda)
    a = peaks.call_peaks(*rows, live, 2.0, 20.0, 0, 100, k_peaks=4096)
    b = peaks.call_peaks(*rows, live, 2.0, 20.0, 0, 100, k_peaks=4096)
    assert torch.equal(a.auc, b.auc) and torch.equal(a.valid, b.valid)


def test_fisher_cli_on_card_matches_cpu(cuda, tmp_path):
    oracle.random_sam(str(tmp_path / "a.sam"), seed=81)
    oracle.random_sam(str(tmp_path / "b.sam"), seed=82, n_pairs=250)
    outs = {}
    for dev in ("cpu", "cuda"):
        r = subprocess.run(
            [sys.executable, "-m", "genrich_tpu_torch", "-t",
             f"{tmp_path / 'a.sam'},{tmp_path / 'b.sam'}", "-o",
             f"{dev}.np", "-y", "-q", "0.5", "-a", "20", "--device", dev],
            cwd=str(tmp_path), capture_output=True, text=True,
            env={**os.environ, "PYTHONPATH": oracle.REPO})
        assert r.returncode == 0, r.stderr[-1500:]
        outs[dev] = (tmp_path / f"{dev}.np").read_text().splitlines()
    assert outs["cpu"] and len(outs["cpu"]) == len(outs["cuda"])
    for a, b in zip(outs["cpu"], outs["cuda"]):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in (6, 7, 8):
            assert abs(float(fa[i]) - float(fb[i])) \
                <= 1e-4 * max(1.0, abs(float(fa[i]))), (a, b)
