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
row-order float32 sum (``testing.auc_rowwise``).  K1-K4 are also held
bitwise to their first designs (``csrc/reference``), K4 on all six
outputs of every candidate.  The gap-join (K5) is bitwise to its plain
version and its first design on every output (the rows' flags, every
slot and the count), also when calls on one stream grow and shrink, on
two streams at once, and replayed from a CUDA graph.
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


@pytest.mark.parametrize("m", [1, 2047, 2048, 3 * 2048 + 77, 4095, 4096,
                               33 * 4096 + 5, 1 << 20])
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
    first, _ = testing.coverage_scan_first_design(packed, 2, carry)
    assert torch.equal(vals, first)


def test_coverage_scan_unaligned_input_and_large_carry(cuda):
    """A packed view one row into a larger tensor (not 16-byte aligned)
    and carries near a real chromosome's depth."""
    m = 200 * 4096 + 3
    big = _packed(6, m + 1, 2).to(cuda)
    carry = torch.tensor([90_000, 7, 2, 4, 1000, 3, 1, 0],
                         dtype=torch.int32, device=cuda)
    assert big[1:].data_ptr() % 16 != 0
    vals, _ = scan.coverage_scan(big[1:], 2, carry)
    ref, _ = scan.coverage_scan_plain(big[1:], 2, carry)
    assert torch.equal(vals, ref)


@pytest.mark.parametrize("m", [4096, 3 * 2048 + 77, 40 * 4096 + 9])
def test_coverage_scan_lambda_mode(cuda, m):
    """The lambda mode against its plain version, and bitwise against
    its first design, which csrc/reference/pval_first.cuh keeps on the
    p-value code it was built with."""
    packed = _packed(4, m, 1).to(cuda)
    vals, pval = scan.coverage_pval_fused(packed, 2.5)
    torch.cuda.synchronize()
    zero = torch.zeros(4, dtype=torch.int32, device=cuda)
    ref_v, ref_p = scan.coverage_scan_plain(packed, 1, zero, 2.5)
    assert torch.equal(vals, ref_v[0])
    torch.testing.assert_close(pval, ref_p, rtol=1e-5, atol=1e-5)
    first_v, first_p = testing.coverage_scan_first_design(packed, 1, zero,
                                                          2.5)
    assert torch.equal(vals, first_v[0]) and torch.equal(pval, first_p)


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


def _counts(rng, m):
    """Integral coverage as K1 makes it: mostly small counts, a tail
    past the 8,192 values that K2's tables hold, a few half counts."""
    v = np.floor(rng.exponential(40.0, m))
    tail = rng.rand(m) < 0.03
    v[tail] = rng.randint(7000, 12000, int(tail.sum()))
    v[rng.rand(m) < 0.01] += 0.5
    return v.astype(np.float32)


def _stats_rows(seed, m, ctrl="mixed", ex_frac=0.05):
    """K2 inputs of ``m`` rows (numpy, then tensors): a fifth zero
    signal; control all zero (every row at lambda) or mixed (a third
    zero, the rest spread across lambda and 7, where the log-normal
    parameters change form); with ``ctrl`` "counts" or "counts_zero",
    integral signal (and control) from ``_counts`` instead;
    ``ex_frac`` of the rows excluded."""
    rng = np.random.RandomState(seed)
    if ctrl.startswith("counts"):
        ev = _counts(rng, m)
    else:
        ev = rng.uniform(0, 60, m).astype(np.float32)
        centre = rng.rand(m) < 0.05      # near lambda: pnorm's centre
        ev[centre] = rng.uniform(0.02, 0.3, int(centre.sum()))
    ev[rng.rand(m) < 0.2] = 0.0
    cr = np.zeros(m, np.float32)
    if ctrl == "mixed":
        cr = rng.uniform(0, 20, m).astype(np.float32)
    elif ctrl == "counts":
        cr = _counts(rng, m)
    cr[rng.rand(m) < 0.3] = 0.0
    ex = rng.rand(m) < ex_frac
    return [torch.from_numpy(a) for a in (ev, cr, ex)]


@pytest.mark.parametrize("m,ctrl,ex_frac,lam", [
    (1, "mixed", 0.05, 0.61), (3, "mixed", 0.05, 0.61),
    (127, "mixed", 0.0, 0.61), (129, "zero", 0.05, 0.61),
    (100_003, "mixed", 0.05, 0.61), (100_003, "zero", 0.05, 0.61),
    (100_003, "mixed", 0.05, 0.0), (1_000_001, "mixed", 0.02, 0.61),
    (4099, "mixed", 1.0, 0.61), (200_003, "counts", 0.05, 2.5),
    (200_003, "counts_zero", 0.05, 2.5), (200_003, "counts", 0.0, 9.5),
    (200_003, "counts", 0.05, 0.0)])
def test_tile_stats_kernel_matches_first_design(cuda, m, ctrl, ex_frac,
                                                lam):
    """K2 bitwise equal to its first design (csrc/reference/
    stats_first.cu): ragged sizes, every row at lambda (no control) or a
    control that varies from row to row, a zero lambda (zero control
    rows), every row excluded; integral coverage that K2 reads from its
    tables, up to and past their last entry, with lambda under and over
    7 (where the log-normal parameters change form)."""
    args = [t.to(cuda) for t in _stats_rows(m, m, ctrl, ex_frac)]
    kernels.reset_launches()
    got = pipeline.tile_stats(*args, 1.37, lam)
    want = testing.tile_stats_first_design(*args, 1.37, lam)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["tile_stats"] == 1
    assert torch.equal(got, want)
    if ex_frac == 1.0:
        assert bool((got == -1.0).all())


@pytest.mark.parametrize("offsets", [(1, 0, 0), (0, 1, 0), (0, 0, 1),
                                     (1, 2, 3), (3, 3, 3), (2, 0, 2)])
def test_tile_stats_kernel_unaligned_inputs(cuda, offsets):
    """Views that start off a 16-byte boundary, each input by its own
    number of rows (the control row of coverage_scan's [2, M] output
    for odd M is such a view): bitwise equal to the first design."""
    m = 300_007
    rows = _stats_rows(7, m + 3)
    args = [t.to(cuda)[o:o + m] for t, o in zip(rows, offsets)]
    assert any(a.data_ptr() % 16 for a in args)
    got = pipeline.tile_stats(*args, 1.37, 2.5)
    want = testing.tile_stats_first_design(*args, 1.37, 2.5)
    assert torch.equal(got, want)
    torch.testing.assert_close(got, pipeline.tile_stats_plain(
        *args, 1.37, 2.5), rtol=1e-5, atol=1e-5)


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


def _fisher_paths(seed, r, n):
    """``_fisher_rows`` with lanes forced down each path of pgamma:
    small x (a total under 1 / ln 10), the upper series (x <= live - 1),
    the lower series, each with and without bd0's series (x within 10%
    of live - 1), and exact boundaries x = 1 and x = live - 1."""
    pv = _fisher_rows(seed, r, n).numpy()
    rng = np.random.RandomState(seed + 1)
    ln10 = np.log(10.0)
    live = r
    targets = [rng.uniform(0.01, 0.99, 200),                  # small x
               rng.uniform(1.0, max(live - 1, 1.0), 200),      # upper
               np.full(20, 1.0), np.full(20, float(live - 1)),  # edges
               (live - 1) * rng.uniform(0.92, 1.08, 200),      # bd0 series
               rng.uniform(live, live + 40, 200)]              # lower
    x = np.concatenate(targets)
    k = len(x)
    # total = x / ln 10, split evenly over the r live replicates
    pv[:, 100:100 + k] = (x / ln10 / r).astype(np.float32)
    return torch.from_numpy(pv)


@pytest.mark.parametrize("r,n", [(1, 5000), (2, 5000), (3, 100_003),
                                 (5, 4099), (2, 1), (3, 1200)])
def test_fisher_combine_kernel_matches_first_design(cuda, r, n):
    """K3 bitwise equal to its first design (csrc/reference/
    fisher_first.cu) on lanes built to take each pgamma path."""
    pv = _fisher_paths(r + n, r, max(n, 1200))[:, :n].contiguous().to(cuda)
    kernels.reset_launches()
    got = chisq.fisher_combine(pv)
    want = testing.fisher_combine_first_design(pv)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["fisher_combine"] == 1
    assert torch.equal(got, want)
    if n >= 1200 and r >= 3:
        paths = testing.fisher_combine_opcount(pv)["paths"]
        assert paths["small_x"] and paths["upper"] and paths["lower"]
        assert paths["bd0_series"]
    plain = chisq.fisher_combine_plain(pv)
    assert torch.equal(got == -1.0, plain == -1.0)
    torch.testing.assert_close(got, plain, rtol=1e-6, atol=0.0)


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
    """testing.peak_row_columns as tensors."""
    return [torch.from_numpy(a) for a in testing.peak_row_columns(
        np.random.RandomState(seed), m, n_regions, **kw)]


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
    assert kernels.LAUNCHES["gap_join"] == 1
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
    args = [t.to(cuda) for t in rows] + [c.sig, c.first, c.last, 2.0]
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


@pytest.mark.parametrize("m,regions,region_rows,max_gap", [
    (300_007, 1000, (3, 200), 100),
    # around the short/long split (1024 rows) and far above it; m odd,
    # so the last peak can end in a row group that the array cuts
    (400_003, 60, (900, 1200), 100),
    (400_001, 40, (1000, 12_000), 10_000)])
def test_peak_reduce_kernel_matches_first_design(cuda, m, regions,
                                                 region_rows, max_gap):
    """All six outputs, for every candidate (empty ones included),
    bitwise equal to the first design (one warp per peak)."""
    rows = _peak_rows(m + 1, m, regions, region_rows=region_rows)
    rows[2][-300:] = 9.0      # a peak that runs to the last row
    rows = [t.to(cuda) for t in rows]
    c = peaks.peak_candidates(*rows[:3], torch.ones(m, dtype=torch.bool,
                                                    device=cuda),
                              2.0, max_gap, 4096)
    kernels.reset_launches()
    got = peaks.peak_reduce(*rows, c.sig, c.first, c.last, 2.0)
    want = testing.peak_reduce_first_design(*rows, c.sig, c.first,
                                            c.last, 2.0)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["peak_reduce"] == 1
    assert int(c.exists.sum()) >= regions // 2
    assert int(c.last[-1]) == m - 1
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_peak_reduce_kernel_unaligned_rows(cuda):
    """Row columns that start off a 16-byte boundary (views one row
    into a larger tensor) give the same outputs as aligned copies."""
    m = 50_001
    big = _peak_rows(3, m + 1, 30, region_rows=(500, 3000))
    rows = [t.to(cuda) for t in big]
    views = [t[1:] for t in rows]
    copies = [t.clone() for t in views]
    assert views[0].data_ptr() % 16 != 0
    live = torch.ones(m, dtype=torch.bool, device=cuda)
    a = peaks.call_peaks(*views, live, 2.0, 20.0, 0, 10_000, k_peaks=512)
    b = peaks.call_peaks(*copies, live, 2.0, 20.0, 0, 10_000, k_peaks=512)
    assert int(b.valid.sum()) > 5
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f


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


def _gap_join_both(cuda, rows, gap, k):
    """K5 on the card and its plain version on the CPU, same rows; every
    output bitwise.  Returns the plain version's."""
    args = [torch.from_numpy(a) for a in rows]
    want = peaks.peak_candidates(*args, 2.0, gap, k)
    kernels.reset_launches()
    got = peaks.peak_candidates(*(t.to(cuda) for t in args), 2.0, gap, k)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["gap_join"] == 1
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == w.dtype and torch.equal(g.cpu(), w), name
    return want


# (seed, rows, max_gap, peak regions, k_peaks, dead tail rows): sizes
# around the first design's 1,024-row tile and K5's 4,096-row tile (one
# tile, a ragged tail), more peaks than slots, a dead tail, and more
# tiles than the card runs blocks at once (5M rows: 1,221 tiles)
GAP_JOIN_CARD_CASES = [
    (1, 1, 10, 1, 4096, 0), (2, 1023, 10, 40, 4096, 0),
    (3, 1024, 100, 60, 17, 0), (4, 1025, 0, 60, 4096, 100),
    (5, 300_007, 100, 20_000, 4096, 0), (6, 2_000_001, 50, 120_000, 4096,
                                        3000),
    (7, 4095, 10, 200, 4096, 0), (8, 4096, 100, 200, 17, 0),
    (9, 4097, 0, 200, 4096, 100), (10, 5_000_000, 100, 300_000, 4096,
                                   2000)]


@pytest.mark.parametrize("case", GAP_JOIN_CARD_CASES)
def test_gap_join_kernel_matches_plain(cuda, case):
    seed, m, gap, regions, k, tail = case
    rows = testing.gap_join_rows(np.random.RandomState(seed), m, gap,
                                 regions, dead_tail=tail)
    want = _gap_join_both(cuda, rows, gap, k)
    if m > 1000:
        assert int(want.n) > min(k, 10)


@pytest.mark.parametrize("case", GAP_JOIN_CARD_CASES)
def test_gap_join_kernel_matches_first_design(cuda, case):
    """K5 against its first design (csrc/reference/gapjoin_first.cu),
    every output bitwise, on the same rows."""
    seed, m, gap, regions, k, tail = case
    rows = [torch.from_numpy(a).to(cuda) for a in testing.gap_join_rows(
        np.random.RandomState(seed), m, gap, regions, dead_tail=tail)]
    got = peaks.peak_candidates(*rows, 2.0, gap, k)
    old = testing.gap_join_first_design(*rows, 2.0, gap, k)
    torch.cuda.synchronize()
    for name, g, o in zip(got._fields, got, old):
        assert g.dtype == o.dtype and torch.equal(g, o), name


def _scratch_zeroed(cuda, stream):
    """K5's scratch for calls on ``stream`` has its counters and every
    tile's flag at zero, as every call leaves it (gapjoin.cu: the tile
    and done counters at [0] and [1], then 12 ints per tile, the flag
    first, the tile's states after it)."""
    key = (cuda.index or 0, stream.cuda_stream)
    return all(int(t[:2].abs().sum()) == 0 and int(t[4::12].abs().sum()) == 0
               for t in peaks.SCRATCH[key])


def test_gap_join_kernel_scratch_grows_and_shrinks(cuda):
    """Calls on one stream whose row count grows and shrinks share its
    scratch (grown when a call needs more), each bitwise to the plain
    version, and each leaves the scratch zeroed."""
    stream = torch.cuda.current_stream(cuda)
    for i, m in enumerate((5000, 2_000_000, 300, 1_000_003, 1, 70_000)):
        rows = testing.gap_join_rows(np.random.RandomState(20 + i), m, 100,
                                     max(1, m // 21))
        _gap_join_both(cuda, rows, 100, 4096)
        assert _scratch_zeroed(cuda, stream)


def test_gap_join_kernel_two_streams(cuda):
    """Calls queued on two streams at once, each on its own rows: each
    stream has its own scratch, and every output is bitwise to the plain
    version."""
    inputs = [testing.gap_join_rows(np.random.RandomState(30 + i), m, 100,
                                    m // 21)
              for i, m in enumerate((3_000_000, 1_500_007))]
    want = [peaks.peak_candidates(*(torch.from_numpy(a) for a in rows),
                                  2.0, 100, 4096) for rows in inputs]
    dev = [[torch.from_numpy(a).to(cuda) for a in rows] for rows in inputs]
    streams = [torch.cuda.Stream(cuda) for _ in inputs]
    torch.cuda.synchronize()
    got = [[], []]
    for _ in range(3):
        for i, s in enumerate(streams):
            with torch.cuda.stream(s):
                got[i].append(peaks.peak_candidates(*dev[i], 2.0, 100, 4096))
    torch.cuda.synchronize()
    for i, s in enumerate(streams):
        assert _scratch_zeroed(cuda, s)
        for out in got[i]:
            for name, g, w in zip(out._fields, out, want[i]):
                assert torch.equal(g.cpu(), w), (i, name)


def test_gap_join_kernel_graph_replay(cuda):
    """K5 captured into a CUDA graph (after a call on the capture stream)
    and replayed on new rows of the same size: every replay's outputs
    are bitwise to the plain version on its rows, and the scratch is
    zeroed after each."""
    m = 700_001
    inputs = [testing.gap_join_rows(np.random.RandomState(40 + i), m, 100,
                                    m // 21) for i in range(3)]
    static = [torch.from_numpy(a).to(cuda) for a in inputs[0]]
    side = torch.cuda.Stream(cuda)
    side.wait_stream(torch.cuda.current_stream(cuda))
    with torch.cuda.stream(side):
        peaks.peak_candidates(*static, 2.0, 100, 4096)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph, stream=side):
        out = peaks.peak_candidates(*static, 2.0, 100, 4096)
    for rows in inputs[1:] + inputs[:1]:
        for t, a in zip(static, rows):
            t.copy_(torch.from_numpy(a))
        graph.replay()
        torch.cuda.synchronize()
        want = peaks.peak_candidates(*(torch.from_numpy(a) for a in rows),
                                     2.0, 100, 4096)
        for name, g, w in zip(out._fields, out, want):
            assert torch.equal(g.cpu(), w), name
        assert _scratch_zeroed(cuda, side)


def test_gap_join_kernel_long_peak_and_empty_tiles(cuda):
    """A peak over ~150 tiles of 1,024 rows, a tile with SKIP rows and
    no significant one between two peaks, and tiles of dead rows only
    (a chromosome's end in the sharded layout)."""
    m = 400_000
    starts = np.arange(m, dtype=np.int32) * 10
    ends = starts + 10
    stat = np.full(m, 0.5, np.float32)
    stat[1000:155_000] = 5.0
    stat[200_000:201_024:97] = -1.0
    stat[[199_999, 201_100]] = 7.0
    live = np.ones(m, bool)
    live[300_000:] = False
    starts[300_000:] = ends[300_000:] = ends[299_999]
    want = _gap_join_both(cuda, (starts, ends, stat, live), 100, 64)
    ex = want.exists.numpy()
    assert int(want.n) == 3
    np.testing.assert_array_equal(want.first.numpy()[ex],
                                  [1000, 199_999, 201_100])
    np.testing.assert_array_equal(want.last.numpy()[ex],
                                  [154_999, 199_999, 201_100])


def test_gap_join_kernel_unaligned_rows(cuda):
    """Columns that start off a 16-byte boundary give the outputs of
    aligned copies."""
    rows = [torch.from_numpy(a).to(cuda) for a in testing.gap_join_rows(
        np.random.RandomState(9), 50_001, 100, 3000)]
    views = [t[1:] for t in rows]
    copies = [t.clone() for t in views]
    assert views[0].data_ptr() % 16 != 0
    a = peaks.peak_candidates(*views, 2.0, 100, 4096)
    b = peaks.peak_candidates(*copies, 2.0, 100, 4096)
    assert int(b.n) > 100
    for f in a._fields:
        assert torch.equal(getattr(a, f), getattr(b, f)), f
