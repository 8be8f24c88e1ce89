"""The port's bench (``genrich_tpu_torch/bench.py``) against the repo's.

At a small size on the CPU: the port's ``_tile_events`` draws the events
of ``bench.py``; the light and production kernel legs give the
per-dispatch fragment sums of the JAX package's ``analyze_tile_core`` /
``analyze_tile_ctrl`` vmapped as ``bench.py``'s ``step_batch`` /
``step_batch_prod`` do (rtol 1e-5), and each tile the same peaks (starts
and ends equal, AUC within the 3e-4 relative of the JAX AUC's float32
prefix sums); ``compact_headline`` keeps ``bench.py``'s contract;
``_verify_rows`` is ``scripts/bench_e2e.py``'s; and the end-to-end
legs run on a small BAM with ``--device cpu``: every serve line OK,
every output verified against the exact engine, cold equal to warm.
"""

from __future__ import annotations

import json
import os
import sys

import numpy as np
import pytest

import conftest  # noqa: F401  (JAX on the CPU)

import bench
import jax
import jax.numpy as jnp
from genrich_tpu.ops.pipeline_jax import analyze_tile_core, analyze_tile_ctrl
from genrich_tpu_torch import bench as tbench

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.join(os.path.dirname(HERE), "scripts"))
import bench_e2e  # noqa: E402
import perf_synth  # noqa: E402

# bench.py's event density over a tile of 2^16 bp leaves the hotspots
# (about 45 events each) under the background rate (12.5): no peaks.  A
# tile of 2^20 bp, the same 2^12 events, gives lambda 0.78 and peaks.
TILE_LEN = 1 << 20
EVENTS = 1 << 12
BATCH = 4
N_DISPATCH = 2
SMALL = (("chr1", 40_000_000), ("chr2", 25_000_000))


@pytest.fixture(scope="module")
def variants():
    return tbench._tile_events(np.random.RandomState(0), tile_len=TILE_LEN,
                               events=EVENTS)


def test_tile_events_are_bench_py_s(monkeypatch, variants):
    monkeypatch.setattr(bench, "TILE_LEN", TILE_LEN)
    monkeypatch.setattr(bench, "EVENTS_PER_TILE", EVENTS)
    want = bench._tile_events(np.random.RandomState(0))
    assert len(want) == len(variants) == 4
    for w, g in zip(want, variants):
        for a, b in zip(w, g):
            assert a.dtype == b.dtype and np.array_equal(a, b)


def _jax_batches(variants, lam):
    """bench.py's step_batch / step_batch_prod on the [BATCH, E] batch of
    the variants, returning every tile's result besides the sum."""
    s, e, c = (jnp.tile(jnp.asarray(np.stack([v[j] for v in variants])),
                        (BATCH // 4, 1)) for j in range(3))
    zero4 = jnp.zeros((4,), jnp.int32)
    excl = jnp.full((tbench.K_EXCL, 2), TILE_LEN, jnp.int32)

    @jax.jit
    def light(s, e, c):
        res = jax.vmap(lambda a, b, d: analyze_tile_core(
            a, b, d, jnp.int32(TILE_LEN), zero4, jnp.float32(lam),
            jnp.float32(2.0), jnp.float32(20.0), 0, 100))(s, e, c)
        return jnp.sum(res.frag_len), res.peaks

    @jax.jit
    def prod(s, e, c):
        def one(a, b, d):
            res, ctrl_frag, *_ = analyze_tile_ctrl(
                a, b, d, a, b, d, excl, jnp.int32(TILE_LEN), zero4, zero4,
                jnp.float32(lam), jnp.float32(1.0), jnp.float32(2.0),
                jnp.float32(20.0), 0, 100)
            return res.frag_len + ctrl_frag, res.peaks
        frag, peaks = jax.vmap(one)(s, e, c)
        return jnp.sum(frag), peaks
    return light(s, e, c), prod(s, e, c)


def _same_peaks(jax_peaks, i, port_peaks, some=True):
    """Tile i's valid peaks: starts and ends equal, AUC within 3e-4;
    with ``some``, at least one."""
    jv = np.asarray(jax_peaks.valid[i])
    pv = port_peaks.valid.numpy()
    assert jv.sum() == pv.sum() >= some
    for name in ("start", "end"):
        assert np.array_equal(np.asarray(getattr(jax_peaks, name)[i])[jv],
                              getattr(port_peaks, name).numpy()[pv])
    ja = np.asarray(jax_peaks.auc[i])[jv]
    pa = port_peaks.auc.numpy()[pv]
    assert np.all(np.abs(ja - pa) <= 3e-4 * np.abs(pa))


def test_kernel_legs_match_bench_py_s_steps(variants):
    import torch
    lam = tbench.tile_lambda(TILE_LEN, EVENTS)
    assert lam == np.float32(EVENTS * 200.0 / TILE_LEN)
    (light_sum, light_peaks), (prod_sum, prod_peaks) = _jax_batches(
        variants, lam)
    cpu = torch.device("cpu")
    out = tbench.kernel_legs(cpu, reps=2, prod_reps=1, tile_len=TILE_LEN,
                             events=EVENTS, batch=BATCH, batch_prod=BATCH,
                             genome_len=N_DISPATCH * TILE_LEN * BATCH,
                             n_single=2)
    k, kp = out["kernel"], out["kernel_production"]
    assert k["dispatches"] == N_DISPATCH and k["tiles"] == 8
    assert len(k["rep_s"]) == 2 and len(kp["rep_s"]) == 1
    np.testing.assert_allclose(k["dispatch_sum"], float(light_sum),
                               rtol=1e-5)
    np.testing.assert_allclose(kp["dispatch_sum"], float(prod_sum),
                               rtol=1e-5)
    # one tile's hand-kernel calls: K1 (lambda mode), K5, K4; and K1
    # (coverage mode), K2, K5, K4
    assert k["kernel_calls_per_tile"] == {
        "coverage_scan": 1, "gap_join": 1, "peak_reduce": 1}
    assert kp["kernel_calls_per_tile"] == {
        "coverage_scan": 1, "tile_stats": 1, "gap_join": 1,
        "peak_reduce": 1}
    assert k["kernel_bounds_per_tile"]["coverage_scan"]["bytes"] \
        == 4 * (2 * EVENTS + 1) * 3
    assert k["roofline"]["frac_vs_ideal_sort"] is None   # no card
    batch = tbench.upload_batch(variants, BATCH, cpu)
    excl = tbench.prod_excl(TILE_LEN, cpu)
    zero4 = torch.zeros(4, dtype=torch.int32)
    for i in range(BATCH):
        args = (batch[0][i], batch[1][i], batch[2][i])
        _same_peaks(light_peaks, i, tbench.light_tile(
            *args, TILE_LEN, lam, zero4).peaks)
        # the control is the treatment itself: no interval is significant
        _same_peaks(prod_peaks, i, tbench.prod_tile(
            *args, excl, TILE_LEN, lam, zero4)[0].peaks, some=False)


def test_compact_headline_contract():
    """The last stdout line stays under 1,500 characters whatever the
    detail holds, carries the headline metric and the card, and still
    prints when the end-to-end legs failed."""
    out = {
        "metric": "genome_positions_per_sec", "value": 2.9e9,
        "unit": "positions/s", "vs_baseline": 644.4,
        "kernel": {"roofline": {"frac_vs_ideal_sort": 0.51}},
        "kernel_production": {"positions_per_sec": 6.1e9,
                              "vs_baseline": 1355.6,
                              "roofline": {"frac_vs_ideal_sort": 0.4}},
        "e2e": {"paired": {"ratio_median": 4.3, "ratio_spread_pct": 3.5},
                "jax_s": 2.1, "sharded_s": 2.2,
                "anything_huge": "x" * 100000},
        "detail": ".bench_cache/bench_torch_detail.json",
        "device": "NVIDIA H100 80GB HBM3, 700.00 W",
    }
    line = json.dumps(tbench.compact_headline(out))
    assert len(line) < 1500, len(line)
    parsed = json.loads(line)
    assert set(bench.compact_headline(out)) - {"detail"} \
        <= set(parsed)
    assert parsed["value"] == 2.9e9 and parsed["e2e_exact_ratio"] == 4.3
    assert parsed["device"] == out["device"]
    out["e2e"] = {"error": "boom"}
    line2 = json.dumps(tbench.compact_headline(out))
    assert json.loads(line2)["e2e_exact_ratio"] is None


def _peak_rows(rng, n, shift=0):
    rows = []
    for i in range(n):
        s = 1000 * i + shift * rng.randint(0, 3)
        q = rng.uniform(1.0, 5.0)
        rows.append(f"chr{1 + i % 2}\t{s}\t{s + rng.randint(50, 400)}\t"
                    f"peak_{i}\t0\t.\t{rng.uniform(20, 900):.6f}\t"
                    f"{q + 1:.6f}\t{q:.6f}\t{rng.randint(0, 50)}")
    return rows


def test_verify_rows_is_bench_e2e_s(tmp_path):
    rng = np.random.RandomState(4)
    ref = _peak_rows(rng, 300)
    out = _peak_rows(np.random.RandomState(4), 300, shift=1)[:280]
    out += [f"chr3\t{10 * i}\t{10 * i + 5}\tx\t0\t.\t1\t2\t"
            f"{1.30103 + 0.001 * i:.6f}\t0" for i in range(5)]
    a, b = tmp_path / "ref.np", tmp_path / "out.np"
    a.write_text("\n".join(ref) + "\n")
    b.write_text("\n".join(out) + "\n")
    for thresh in (1.3010299956639813, 2.0):
        want = bench_e2e._verify_rows(str(a), str(b), thresh)
        assert 0 < want["match_frac"] < 1 and want["worst_unmatched_margin"]
        assert tbench._verify_rows(str(a), str(b), thresh) == want
        assert tbench._verify_rows(str(a), str(a), thresh) \
            == bench_e2e._verify_rows(str(a), str(a), thresh)


def test_e2e_legs_on_the_cpu(tmp_path):
    """``atac`` (with its two-worker parser leg) and ``chip_fisher`` (the
    blacklist from the ATAC exact peaks, two replicates with their
    controls) on 20,000-pair BAMs, one rep, both device engines through
    their serve children (the sharded one in a one-rank gloo group)."""
    bams = {}
    for key, n, seed in (("A", 20_000, 7), ("B", 20_000, 8),
                         ("C", 10_000, 9)):
        bams[key] = str(tmp_path / f"{key}.bam")
        perf_synth.synth_bam(bams[key], n, seed=seed, chroms=SMALL)
    out = tbench.bench_e2e(bams, ["atac", "chip_fisher"], 1, device="cpu",
                           work=str(tmp_path), chroms=SMALL, timeout=300)
    assert out["ok"], {n: c["checks"] for n, c in out["configs"].items()}
    assert len(out["blacklist_cut"]) == 2
    for name, cfg in out["configs"].items():
        assert cfg["peaks"] > 0 and cfg["records"] > 40_000
        for eng in tbench.ENGINES:
            assert cfg[eng]["rows"]["match_frac"] >= 0.99
            assert len(cfg[eng]["rep_s"]) == 1 and cfg[eng]["cold_s"] > 0
            assert set(cfg[eng]["stages"]) == {"ingest_s", "device_rep_s",
                                               "findpeaks_s"}
            assert cfg[eng]["max_memory_allocated"] is None   # no card
            assert cfg["paired"][eng]["ratio_median"] > 0
        assert ("exact_par2" in cfg) == (name == "atac")
    assert out["paired"] == out["configs"]["atac"]["paired"]["jax"]
    assert out["jax_s"] > 0 and out["sharded_s"] > 0
