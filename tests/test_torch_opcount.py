"""The operation counters and the bound of ``genrich_tpu_torch.testing``.

``fisher_combine_opcount`` tallies the trip counts of kernel K3's series
from the plain version's masked loops (``ops.chisq.pgamma(...,
trips=)``); here they are held to a scalar transcription of the loops
of ``csrc/fisher.cu`` (Python floats are IEEE doubles, and the loops use
only +, -, *, / and compares, so the trip counts are exact).
``calc_pval_opcount``'s branch tallies are held to a per-row float32
walk of ``csrc/pval.cuh``'s branches, and its operation count to a
count by hand for single rows; ``tile_stats_opcount``'s tally of the
rows that K2 reads from its tables to a walk of its row loop.  ``bound``
picks the larger of its byte
and operation terms.  ``sass_cost.count_sass`` is held to a SASS
fragment.  CPU only; no jax.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from genrich_tpu_torch import sass_cost, testing

F32 = np.float32
EPS = float(np.finfo(np.float64).eps)
TINY = float(np.finfo(np.float64).tiny)
LOG10E = 0.434294481903251827651128918916605082


# --- K3: a scalar transcription of fisher.cu's loops ----------------------

def _bd0_trips(x, np_):
    """Trips of bd0's series, None when the series is not taken."""
    if not abs(x - np_) < 0.1 * (x + np_):
        return None
    v = (x - np_) / (x + np_)
    s = (x - np_) * v
    if abs(s) < TINY:
        return None
    ej = 2 * x * v
    v2 = v * v
    for j in range(1, 1000):
        ej = ej * v2
        s1 = s + ej / (2 * j + 1)
        if s1 == s:
            return j
        s = s1
    return 999


def _upper_trips(x, a):
    term = x / a
    total = term
    n = 0
    while True:
        a = a + 1
        term = term * x / a
        total = total + term
        n += 1
        if not term > total * EPS:
            return n


def _lower_trips(lam, y):
    term, total, n = 1.0, 0.0, 0
    if y >= 1:
        while True:
            term = term * y / lam
            total = total + term
            y = y - 1
            n += 1
            if not (y >= 1 and term > total * EPS):
                break
    return n


def _smallx_trips(x, alph):
    n, c, total, k = 0.0, alph, 0.0, 0
    while True:
        n = n + 1
        c = c * -x / n
        term = c / (alph + n)
        total = total + term
        k += 1
        if not abs(term) > EPS * abs(total):
            return k


def _scalar_tally(pv):
    """Per-path lane counts and per-series trips of fisher.cu on f32
    [R, N] numpy rows."""
    paths = dict(skip=0, trivial=0, small_x=0, upper=0, lower=0,
                 bd0_series=0)
    trips = {k: [] for k in ("pgamma_smallx", "pd_upper_series",
                             "pd_lower_series", "bd0")}
    for lane in pv.T:
        total, live = 0.0, 0
        for v in lane:
            if v != F32(-1.0):
                total = total + float(v)
                live += 1
        if live == 0:
            paths["skip"] += 1
            continue
        if live == 1 or total == 0.0:
            paths["trivial"] += 1
            continue
        x = 2.0 * total / LOG10E
        xg, alph = x / 2.0, (2.0 * live) / 2.0
        if xg < 1:
            paths["small_x"] += 1
            trips["pgamma_smallx"].append(_smallx_trips(xg, alph))
            continue
        b = _bd0_trips(alph - 1, xg)
        if b is not None:
            paths["bd0_series"] += 1
            trips["bd0"].append(b)
        if xg <= alph - 1:
            paths["upper"] += 1
            trips["pd_upper_series"].append(_upper_trips(xg, alph))
        else:
            paths["lower"] += 1
            trips["pd_lower_series"].append(_lower_trips(xg, alph - 1))
    return paths, trips


def _fisher_lanes(seed, r, n):
    """f32 [r, n]: 10% SKIP values, and lanes aimed at every path: small
    x, the upper and lower series, near and far from bd0's series, and
    the exact edges x = 1 and x = live - 1."""
    rng = np.random.RandomState(seed)
    pv = rng.uniform(0, 8, (r, n)).astype(F32)
    pv[rng.rand(r, n) < 0.1] = -1.0
    pv[:, :5] = -1.0
    pv[:, 5:10] = 0.0
    x = np.concatenate([rng.uniform(0.01, 0.99, 40),
                        rng.uniform(1.0, max(r - 1.0, 1.0), 40),
                        [1.0, 1.0, float(r - 1), float(r - 1)],
                        (r - 1) * rng.uniform(0.92, 1.08, 40),
                        rng.uniform(r, r + 30, 40)])
    pv[:, 10:10 + len(x)] = (x / np.log(10.0) / r).astype(F32)
    return pv


@pytest.mark.parametrize("r,seed", [(2, 0), (2, 1), (3, 2), (5, 3), (1, 4)])
def test_fisher_opcount_trips_match_the_kernels_loops(r, seed):
    pv = _fisher_lanes(seed, r, 600)
    got = testing.fisher_combine_opcount(torch.from_numpy(pv))
    paths, trips = _scalar_tally(pv)
    for k, v in paths.items():
        assert got["paths"][k] == v, k
    for k, t in trips.items():
        assert got["trips"][k] == {"lanes": len(t), "sum": sum(t),
                                   "max": max(t, default=0)}, k
    if r >= 3:
        assert all(paths[k] for k in ("small_x", "upper", "lower",
                                      "bd0_series"))


def test_fisher_opcount_trivial_lanes_count_by_hand():
    """Lanes that need no chi-squared tail: a replicate compare each,
    two float64 operations per live value, total == 0 for two or more
    live values, one conversion for a result that is the total."""
    pv = np.array([[-1.0, 2.0, 0.0],
                   [-1.0, -1.0, 0.0]], F32)
    got = testing.fisher_combine_opcount(torch.from_numpy(pv))
    assert got["paths"]["skip"] == 1 and got["paths"]["trivial"] == 2
    assert got["fp32_ops"] == 2 * 3
    assert got["fp64_ops"] == 2 * 3 + 1 + 2


def test_fisher_opcount_lower_lane_count_by_hand():
    """One lane of two live values far into the lower series (one term,
    bd0 by its direct formula), counted by hand from fisher.cu."""
    pv = np.array([[3.0], [4.0]], F32)
    got = testing.fisher_combine_opcount(torch.from_numpy(pv))
    assert got["paths"]["lower"] == 1 and got["trips"]["pd_lower_series"] \
        == {"lanes": 1, "sum": 1, "max": 1}
    L = {k: v[1] for k, v in testing.LIBM_OPS.items()}
    want = (2 * 2 + 1                       # live values, total == 0
            + 9 + 2 * L["ddiv"]             # x, alph, result, x < 1
            + 5 + L["log"] + 5 + 2          # dpois, bd0's test, x <= a-1
            + 3 + L["ddiv"] + L["log"]      # bd0's direct formula
            + 2 + 1 + L["log1p"]            # pd_lower_series
            + 6 + L["ddiv"]                 # its one term
            + 1 + 3 + 1)                    # stirlerr(1) once
    assert got["fp64_ops"] == want


# --- K2 and K1: calc_pval -------------------------------------------------

def _branch_walk(expt, ctrl):
    """Per-row float32 walk of pval.cuh's branches; returns counts."""
    n = dict(skip=0, ctrl_zero=0, expt_zero=0, A=0, B=0, C=0,
             do_del_ret=0)
    for e, c in zip(expt, ctrl):
        if c == F32(-1):
            n["skip"] += 1
            continue
        if c == F32(0):
            n["ctrl_zero"] += 1
            continue
        if e == F32(0):
            n["expt_zero"] += 1
            continue
        mu = max(c, F32(1e-30))
        if c > F32(7):
            sd = F32(10) * np.log10(mu)
            mu2, sd2 = mu * mu, sd * sd
            meanlog = np.log(mu2 / np.sqrt(sd2 + mu2))
            sdlog = np.sqrt(np.log1p(sd2 / mu2))
        else:
            meanlog = np.log(mu) - F32(0.445999019652555)
            sdlog = F32(0.944456478248262)
        x = (np.log(max(e, F32(1e-30))) - meanlog) / sdlog
        y = abs(x)
        if y <= F32(0.67448975):
            n["A"] += 1
        elif y <= F32(5.656854249492381):
            n["B"] += 1
            n["do_del_ret"] += bool(x <= 0)
        else:
            n["C"] += 1
            n["do_del_ret"] += bool(x <= 0)
    return n


@pytest.mark.parametrize("seed,lam", [(0, 0.61), (1, 2.5), (2, 0.0),
                                      (3, 9.0)])
def test_calc_pval_opcount_branches_match_a_row_walk(seed, lam):
    rng = np.random.RandomState(seed)
    m = 3000
    ev = rng.uniform(0, 60, m).astype(F32)
    ev[rng.rand(m) < 0.2] = 0.0
    ev[rng.rand(m) < 0.1] = F32(0.2)
    cr = rng.uniform(0, 20, m).astype(F32)
    cr[rng.rand(m) < 0.4] = 0.0
    ex = rng.rand(m) < 0.05
    got = testing.tile_stats_opcount(torch.from_numpy(ev),
                                     torch.from_numpy(cr),
                                     torch.from_numpy(ex), 1.37, lam)
    ctrl = np.maximum(F32(1.37) * cr, F32(lam)).astype(F32)
    ctrl[ex] = -1.0
    want = _branch_walk(np.where(ex, F32(0), ev), ctrl)
    b = got["branches"]
    assert sum(b[k] for k in ("A", "A_tiny")) == want["A"]
    for k in ("skip", "ctrl_zero", "expt_zero", "B", "C", "do_del_ret"):
        assert b[k] == want[k], k
    assert b["at_lambda"] + b["own_big"] + b["own_small"] == b["main"]


def test_tile_stats_opcount_by_hand():
    """Single rows, counted by hand from stats.cu and pval.cuh."""
    L = {k: v[0] for k, v in testing.LIBM_OPS.items()}

    def count(e, c, ex, lam):
        return testing.tile_stats_opcount(
            torch.tensor([e], dtype=torch.float32),
            torch.tensor([c], dtype=torch.float32),
            torch.tensor([ex]), 1.0, lam)["fp32_ops"]
    assert count(5.0, 3.0, True, 0.5) == 1                # excluded
    assert count(0.0, 3.0, False, 0.5) == 2 + 3           # zero signal
    # signal 2 against lambda 0.5 (ctrl <= 7): pnorm's middle branch,
    # do_del's log form; lambda's parameters once
    lam_part = 5 + L["log10f"] + 1 + L["logf"]
    row = 2 + 3 + 6 + L["logf"] + 2 * L["fdiv"] + 33 + L["fdiv"] \
        + 6 + 5 + L["logf"]
    assert count(2.0, 0.0, False, 0.5) == lam_part + row
    # signal 20 against its own control 3.0 (the same branches): its own
    # parameters, and none of lambda's
    assert count(20.0, 3.0, False, 0.5) == lam_part + row


@pytest.mark.parametrize("lam", [2.5, 9.5, 0.0])
def test_tile_stats_opcount_table_rows_match_a_row_walk(lam):
    """The rows that K2 reads from its tables, against a walk of
    stats.cu's row loop: a signal against lambda or a control of its
    own, integral and in [1, STATS_TABLE); half counts, the table's last
    value and the first beyond it included."""
    rng = np.random.RandomState(5)
    m = 4000
    top = testing.STATS_TABLE
    ev = np.floor(rng.exponential(30.0, m)).astype(F32)
    cr = np.floor(rng.exponential(5.0, m)).astype(F32)
    for a in (ev, cr):
        a[rng.rand(m) < 0.05] += F32(0.5)
        a[:3] = [top - 1, top, top + 7]
    ex = rng.rand(m) < 0.05
    got = testing.tile_stats_opcount(torch.from_numpy(ev),
                                     torch.from_numpy(cr),
                                     torch.from_numpy(ex), 1.37, lam)["branches"]
    lam32 = F32(lam)
    want = {"table_p": 0, "table_params": 0}
    for e, c, x in zip(ev, cr, ex):
        ctrl = max(F32(1.37) * c, lam32)
        if x or ctrl == 0 or e == 0:
            continue
        v, key = (e, "table_p") if ctrl == lam32 else (c, "table_params")
        want[key] += bool(1 <= v < top and v == np.trunc(v))
    assert {k: got[k] for k in want} == want
    assert want["table_params"] and (lam == 0.0 or want["table_p"])


def test_coverage_scan_opcount():
    cov = torch.tensor([0.0, 1.0, 2.5, 40.0])
    assert testing.coverage_scan_opcount(10, 2)["fp32_ops"] == 6 * 2 * 10
    lam = testing.coverage_scan_opcount(4, 1, cov, 2.5)
    pv = testing.calc_pval_opcount(cov, torch.full_like(cov, 2.5), 2.5)
    assert lam["fp32_ops"] == 6 * 4 + pv["fp32_ops"]
    assert lam["branches"]["expt_zero"] == 1


# --- the bound -------------------------------------------------------------

def test_bound_takes_the_larger_term():
    ms, by = testing.bound(3.35e9)                       # 1 ms of bytes
    assert by == "bytes" and ms == pytest.approx(1.0)
    ms, by = testing.bound(3.35e9, fp32_ops=2 * 67e9)    # 2 ms of fp32
    assert by == "operations" and ms == pytest.approx(2.0)
    ms, by = testing.bound(3.35e6, fp32_ops=67e9, fp64_ops=3 * 34e9)
    assert by == "operations" and ms == pytest.approx(3.0)
    ms, by = testing.bound(3.35e10, fp32_ops=67e9, fp64_ops=34e9)
    assert by == "bytes" and ms == pytest.approx(10.0)


# --- the SASS counter -------------------------------------------------------

_SASS = """
	code for sm_90a
		Function : probe_a
	.headerflags	@"EF_CUDA_SM90"
        /*0000*/                   LDC R1, c[0x0][0x28] ;   /* 0x0000 */
        /*0010*/                   FFMA R2, R3, R4, R5 ;    /* 0x0000 */
        /*0020*/              @!P0 FADD R2, R2, 1 ;         /* 0x0000 */
        /*0030*/                   MUFU.RCP64H R7, R9 ;     /* 0x0000 */
        /*0040*/                   DFMA R6, R8, R10, R6 ;   /* 0x0000 */
        /*0050*/                   F2F.F32.F64 R2, R6 ;     /* 0x0000 */
        /*0060*/                   IADD3 R1, R1, 1, RZ ;    /* 0x0000 */
        /*0070*/                   EXIT ;                   /* 0x0000 */
        /*0080*/                   DADD R6, R6, R8 ;        /* 0x0000 */
		Function : probe_b
        /*0000*/                   MUFU.LG2 R0, R0 ;        /* 0x0000 */
        /*0010*/                   EXIT ;                   /* 0x0000 */
"""


def test_count_sass_stops_at_exit_and_counts_fma_twice():
    got = sass_cost.count_sass(_SASS)
    assert got == {"probe_a": {"fp32": 3, "fp64": 4},
                   "probe_b": {"fp32": 1, "fp64": 0}}


def test_probe_source_has_one_kernel_per_function():
    src = sass_cost.probe_source()
    for name, _, _ in sass_cost.PROBES:
        assert f"probe_{name}(" in src
    assert set(testing.LIBM_OPS) == {
        n for n, _, _ in sass_cost.PROBES} - set(sass_cost.BASELINE.values())
