"""``python -m genrich_tpu_torch --device cpu`` against the exact engine.

Cloned from test_engine_jax_cli.py: the same fixtures and the same
comparison rules (narrowPeak columns 1-6 identical, float columns
within 1e-4 relative; the ctrl + -E case threshold-aware), plus the
>2^31-bp host-fallback chromosome and a run against ``--engine jax``.
Column 10 (summit offset) is held to the exact engine's on every
matched row (``testing.check_summits``): equal on the single-replicate
device paths, whose interval rows are the exact engine's intervals
(``compact.pileup_runs``); on the others equal, or a near tie that the
exact engine's ``-f`` log shows (its run writes one: ``summit.log``
unless the case asks for a log of its own).
"""

from __future__ import annotations

import os
import subprocess
import sys

import numpy as np
import pytest

from genrich_tpu_torch.testing import check_log, check_summits

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402


def _env():
    return {**os.environ, "PYTHONPATH": oracle.REPO,
            "JAX_PLATFORMS": "cpu"}


def _run_torch(args, cwd):
    return subprocess.run(
        [sys.executable, "-m", "genrich_tpu_torch"] + args
        + ["--device", "cpu"], cwd=cwd, capture_output=True, text=True,
        env=_env())


SUMMIT_LOG = "summit.log"


def _with_log(args):
    """The exact engine's args with an -f log (its peaks do not change)
    for the summit check, unless the case has one."""
    return args if "-f" in args or "--engine" in args \
        else args + ["-f", SUMMIT_LOG]


def _run(tmp_path, name, extra, infile="in.sam", torch_port=False):
    d = tmp_path / name
    d.mkdir()
    args = ["-t", str(tmp_path / infile), "-o", "out.np", "-y",
            "-p", "0.01", "-a", "20"] + extra
    r = _run_torch(args, str(d)) if torch_port \
        else oracle.run_ours(_with_log(args), cwd=str(d))
    assert r.returncode == 0, r.stderr[-1500:]
    return (d / "out.np").read_text().splitlines()


def _close_rows(exact, fast, cols=(6, 7), tol=1e-4, log=None):
    """Columns 1-6 identical, ``cols`` within ``tol``; with the exact
    engine's -f ``log``, column 10 equal on every row (``check_summits``
    finds no tie)."""
    assert len(exact) == len(fast)
    for a, b in zip(exact, fast):
        fa, fb = a.split("\t"), b.split("\t")
        assert fa[:6] == fb[:6], (a, b)
        for i in cols:
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= tol * max(1.0, abs(x)), (a, b)
    if log is not None:
        assert check_summits(exact, fast, log, tol) == (len(exact), 0)


def test_torch_port_matches_exact_boundaries(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=71)
    exact = _run(tmp_path, "exact", [])
    fast = _run(tmp_path, "torch", [], torch_port=True)
    assert exact
    _close_rows(exact, fast, log=tmp_path / "exact" / SUMMIT_LOG)


def test_torch_port_bam_input(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=77)
    oracle.sam_to_bam(str(tmp_path / "in.sam"), str(tmp_path / "in.bam"))
    exact = _run(tmp_path, "exact", [], infile="in.bam")
    fast = _run(tmp_path, "torch", [], infile="in.bam", torch_port=True)
    assert exact and len(exact) == len(fast)
    for a, b in zip(exact, fast):
        assert a.split("\t")[:6] == b.split("\t")[:6], (a, b)
    assert check_summits(exact, fast, tmp_path / "exact" / SUMMIT_LOG,
                         1e-4) == (len(exact), 0)


def test_torch_port_with_ctrl_and_exclusions(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=72)
    oracle.random_sam(str(tmp_path / "c.sam"), seed=73, cluster=False,
                      n_pairs=150)
    (tmp_path / "x.bed").write_text("chr1\t2000\t9000\n")
    extra = ["-c", str(tmp_path / "c.sam"), "-E", str(tmp_path / "x.bed"),
             "-q", "0.5"]
    exact = _run(tmp_path, "exact", extra)
    fast = _run(tmp_path, "torch", extra, torch_port=True)
    # threshold-aware, as test_engine_jax_cli.py: float32 stats may flip
    # significance only for intervals within eps of -log10(0.5)
    key = lambda ln: tuple(ln.split("\t")[:3])     # noqa: E731
    ek = {key(ln): ln for ln in exact}
    fk = {key(ln): ln for ln in fast}
    eps = 0.02
    thresh = 0.30103

    def spans(lines):
        return [(f[0], int(f[1]), int(f[2]))
                for f in (ln.split("\t") for ln in lines)]

    def check_only(only_keys, src, other_spans):
        for k in only_keys:
            f = src[k].split("\t")
            chrom, s, e, q = f[0], int(f[1]), int(f[2]), float(f[8])
            if any(c == chrom and s < oe and os_ < e
                   for c, os_, oe in other_spans):
                continue
            assert abs(q - thresh) <= eps, (k, src[k])

    check_only(ek.keys() - fk.keys(), ek, spans(fast))
    check_only(fk.keys() - ek.keys(), fk, spans(exact))
    assert exact and len(ek.keys() & fk.keys()) >= len(exact) * 0.95
    assert check_summits(exact, fast, tmp_path / "exact" / SUMMIT_LOG,
                         1e-4) == (len(ek.keys() & fk.keys()), 0)


def test_torch_port_big_chrom_host_fallback(tmp_path):
    """A >2^31-bp chromosome runs on the host (exact-engine float32
    operations) while the other stays on the device; all agree,
    including positions above 2^31 and the merged genome-wide BH."""
    big = 3_000_000_000
    oracle.random_sam(str(tmp_path / "in.sam"),
                      chroms=(("chrBig", big), ("chr2", 50000)),
                      seed=101, n_pairs=400)
    extra = ["-q", "0.5"]
    exact = _run(tmp_path, "exact", extra)
    fast = _run(tmp_path, "torch", extra, torch_port=True)
    assert any(ln.startswith("chrBig\t") for ln in exact)
    assert any(ln.startswith("chr2\t") for ln in exact)
    _close_rows(exact, fast, cols=(6, 7, 8),
                log=tmp_path / "exact" / SUMMIT_LOG)
    assert any(int(ln.split("\t")[1]) > 0x7FFFFFFF for ln in exact
               if ln.startswith("chrBig\t"))


@pytest.mark.parametrize("extra", [["-p", "0.01"], ["-q", "0.5"]])
def test_torch_port_matches_jax_engine(tmp_path, extra):
    """The port against its reference, ``--engine jax``: peak rows
    identical in columns 1-6, float columns within 1e-5 relative."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=75, n_pairs=600)
    jx = _run(tmp_path, "jax", extra + ["--engine", "jax"])
    fast = _run(tmp_path, "torch", extra, torch_port=True)
    assert jx
    _close_rows(jx, fast, cols=(6, 7, 8), tol=1e-5)


def test_torch_port_cap_exceeded_uses_host_peak_caller(tmp_path,
                                                       monkeypatch):
    """More candidate peaks than the device cap: the chromosome's peaks
    are called again on the device with enough slots
    (``perf["peak_redispatch"]``), not by the host peak caller
    (``host_peak_chroms`` 0) -- same rows as the exact engine."""
    from genrich_tpu_torch import cli
    from genrich_tpu_torch.engine import torch_bridge
    oracle.random_sam(str(tmp_path / "in.sam"), seed=71)
    exact = _run(tmp_path, "exact", [])
    assert len(exact) > 2
    monkeypatch.setattr(torch_bridge, "PEAK_CAP", 1)
    out = tmp_path / "capped.np"
    perf = {}
    rc = cli.main(["-t", str(tmp_path / "in.sam"), "-o", str(out), "-y",
                   "-p", "0.01", "-a", "20", "--device", "cpu"], perf=perf)
    assert rc == 0
    fast = out.read_text().splitlines()
    _close_rows(exact, fast, log=tmp_path / "exact" / SUMMIT_LOG)
    assert perf["fetch_n"] > 0 and perf["device_rep_s"] > 0
    assert perf["peak_redispatch"] > 0 and perf["host_peak_chroms"] == 0


def _run_reps(tmp_path, name, reps, extra, torch_port=False):
    d = tmp_path / name
    d.mkdir()
    args = ["-t", ",".join(str(tmp_path / r) for r in reps), "-o",
            "out.np", "-y", "-p", "0.01", "-a", "20"] + extra
    r = _run_torch(args, str(d)) if torch_port \
        else oracle.run_ours(_with_log(args), cwd=str(d))
    assert r.returncode == 0, r.stderr[-1500:]
    return (d / "out.np").read_text().splitlines()


def _fisher_rows(exact, fast, tol=1e-3, log=None):
    """test_engine_jax_cli.py:84-92's rule for several replicates; with
    the exact engine's -f ``log``, column 10 by ``check_summits``."""
    assert exact and len(exact) == len(fast)
    same = sum(a.split("\t")[:6] == b.split("\t")[:6]
               for a, b in zip(exact, fast))
    assert same >= len(exact) * 0.9
    for a, b in zip(exact, fast):
        fa, fb = a.split("\t"), b.split("\t")
        for i in (6, 7):
            x, y = float(fa[i]), float(fb[i])
            assert abs(x - y) <= tol * max(1.0, abs(x)), (a, b)
    if log is not None:
        assert check_summits(exact, fast, log, tol)[0] >= same


@pytest.fixture
def two_reps(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=81)
    oracle.random_sam(str(tmp_path / "b.sam"), seed=82, n_pairs=250)
    return ["in.sam", "b.sam"]


@pytest.mark.parametrize("ref", ["exact", "jax"])
def test_torch_port_fisher_replicates(tmp_path, two_reps, ref):
    """Two replicates combined on the device (archive_replicate,
    finalize_fisher, kernel K3's plain version) against the exact
    engine and ``--engine jax``."""
    extra = [] if ref == "exact" else ["--engine", "jax"]
    want = _run_reps(tmp_path, ref, two_reps, extra)
    got = _run_reps(tmp_path, "torch", two_reps, [], torch_port=True)
    _fisher_rows(want, got, log=tmp_path / "exact" / SUMMIT_LOG
                 if ref == "exact" else None)


def test_torch_port_three_replicates_with_q(tmp_path, two_reps):
    oracle.random_sam(str(tmp_path / "c.sam"), seed=83, n_pairs=300)
    reps = two_reps + ["c.sam"]
    want = _run_reps(tmp_path, "exact", reps, ["-q", "0.5"])
    got = _run_reps(tmp_path, "torch", reps, ["-q", "0.5"],
                    torch_port=True)
    _fisher_rows(want, got, log=tmp_path / "exact" / SUMMIT_LOG)


def test_torch_port_fisher_big_chrom_host_fallback(tmp_path):
    """Replicates of a >2^31-bp chromosome archive and combine on the
    host (host_archive, host_fisher) beside a device chromosome."""
    for name, seed in (("in.sam", 101), ("b.sam", 102)):
        oracle.random_sam(str(tmp_path / name),
                          chroms=(("chrBig", 3_000_000_000),
                                  ("chr2", 50000)), seed=seed, n_pairs=400)
    reps = ["in.sam", "b.sam"]
    want = _run_reps(tmp_path, "exact", reps, ["-q", "0.5"])
    got = _run_reps(tmp_path, "torch", reps, ["-q", "0.5"],
                    torch_port=True)
    assert any(ln.startswith("chrBig\t") for ln in want)
    _fisher_rows(want, got, log=tmp_path / "exact" / SUMMIT_LOG)


@pytest.mark.parametrize("ref", ["exact", "jax"])
@pytest.mark.parametrize("extra", [[], ["-c", "c.sam", "-E", "x.bed"]])
def test_torch_port_logs(tmp_path, ref, extra):
    """-f/-k logs through the device RLE pull-back (pvalue_pileups,
    compact.rle_runs)."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=91)
    oracle.random_sam(str(tmp_path / "c.sam"), seed=92, cluster=False,
                      n_pairs=150)
    (tmp_path / "x.bed").write_text("chr1\t2000\t9000\n")
    extra = [str(tmp_path / a) if a.endswith((".sam", ".bed")) else a
             for a in extra]
    logs = ["-f", "f.log", "-k", "k.log"]
    want = _run(tmp_path, ref, logs + extra
                + ([] if ref == "exact" else ["--engine", ref]))
    got = _run(tmp_path, "torch", logs + extra, torch_port=True)
    assert [a.split("\t")[:6] for a in want] \
        == [b.split("\t")[:6] for b in got]
    if ref == "exact":
        assert check_summits(want, got, tmp_path / "exact" / "f.log",
                             1e-3)[0] == len(want)
    for name in ("f.log", "k.log"):
        check_log(tmp_path / ref / name, tmp_path / "torch" / name)


def test_torch_port_fisher_with_log_takes_host_path(tmp_path, two_reps):
    """Two replicates with -f: each replicate's RLE comes back
    (pvalue_pileups) and the exact engine combines on the host."""
    want = _run_reps(tmp_path, "exact", two_reps, ["-f", "f.log"])
    got = _run_reps(tmp_path, "torch", two_reps, ["-f", "f.log"],
                    torch_port=True)
    _fisher_rows(want, got, log=tmp_path / "exact" / "f.log")
    check_log(tmp_path / "exact" / "f.log", tmp_path / "torch" / "f.log")


def test_torch_port_skip_peaks_then_peaks_only(tmp_path):
    """-X -f x.log writes the log with no peaks; -P -f x.log then calls
    peaks from it; both equal the exact engine's rows."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=93)
    for name, run in (("exact", oracle.run_ours), ("torch", _run_torch)):
        d = tmp_path / name
        d.mkdir()
        r = run(["-t", str(tmp_path / "in.sam"), "-X", "-f", "x.log",
                 "-y"], cwd=str(d))
        assert r.returncode == 0, r.stderr[-1500:]
        assert not (d / "out.np").exists()
        r = run(["-P", "-f", "x.log", "-o", "out.np", "-p", "0.01", "-a",
                 "20"], cwd=str(d))
        assert r.returncode == 0, r.stderr[-1500:]
    check_log(tmp_path / "exact" / "x.log", tmp_path / "torch" / "x.log")
    want = (tmp_path / "exact" / "out.np").read_text().splitlines()
    got = (tmp_path / "torch" / "out.np").read_text().splitlines()
    _close_rows(want, got, cols=(6, 7), tol=1e-3,
                log=tmp_path / "exact" / "x.log")


def test_torch_port_main_path_flags_summit_ties(tmp_path, monkeypatch):
    """The main path's flags (``-r -j -q 0.05 -a 20``) on a dense ATAC
    BAM from scripts/perf_synth.py, against the port's ``--engine exact``
    (byte-identical to the JAX package's, test_torch_exact.py): columns
    1-6 identical and column 10 equal on every row, with no tie, on the
    device path and on the ``-f`` path.  The fixture has the teeth: its
    peaks' maximum -log(q) is shared by several of the exact engine's
    intervals (plateaus of BH), so the longest-interval rule of the
    summit picks another row wherever the device's rows are pieces of
    those intervals (``compact.pileup_runs`` merges them)."""
    sys.path.insert(0, os.path.join(oracle.REPO, "scripts"))
    import perf_synth
    from genrich_tpu_torch import cli
    monkeypatch.chdir(tmp_path)
    perf_synth.synth_bam("in.bam", 60_000, seed=7,
                         chroms=(("chr1", 150_000), ("chr2", 100_000)))
    flags = ["-t", "in.bam", "-r", "-j", "-q", "0.05", "-a", "20"]
    for argv in (["-o", "exact.np", "-f", "exact.log", "--engine", "exact"],
                 ["-o", "device.np", "--device", "cpu"],
                 ["-o", "host.np", "-f", "host.log", "--device", "cpu"]):
        assert cli.main(flags + argv) == 0
    exact, device, host = ((tmp_path / f"{n}.np").read_text().splitlines()
                           for n in ("exact", "device", "host"))
    _close_rows(exact, device)
    _close_rows(exact, host)
    assert len(exact) > 20
    assert check_summits(exact, device, tmp_path / "exact.log", 0.0) \
        == (len(exact), 0)
    assert check_summits(exact, host, tmp_path / "exact.log", 0.0) \
        == (len(exact), 0)


def test_torch_engine_long_fragment():
    """Fragments >= 2^16 bp upload as int32 like any other."""
    from genrich_tpu_torch.engine.torch_bridge import TorchEngine
    eng = TorchEngine("cpu")
    ev = (np.array([100, 5000], np.int64), np.array([200000, 5100],
                                                    np.int64),
          np.array([1, 1], np.int64))
    h = eng.coverage_chrom(0, ev, None, [], 1 << 20)
    frag, cfrag = eng.coverage_finish([h])
    assert abs(frag - ((200000 - 100) + 100)) < 1e-3
    assert cfrag == 0.0
    eng.release()
