"""The port's native library against the JAX package's.

``genrich_tpu_torch/native/ingest.cpp`` is the port's own copy of
``native/ingest.cpp``; the port builds it into
``genrich_tpu_torch/_build/`` and never loads the repo's committed
``native/libgenrich_ingest.so``, which ``genrich_tpu.ingest.native``
loads.  Each test below feeds both libraries the same seeded input and
requires the same bytes: ingest events, counters, chromosome registry
and the ``-R``/``-b`` files over SAM, BAM and gzipped SAM with the
record-parse workers at 0, 2 and 6; the exact engine's peak callers,
row writers and numeric helpers.  Then the build: cached the second
time, built once by two processes that start together, and the only
library a CLI run of the port maps.
"""

from __future__ import annotations

import gzip
import json
import os
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu import params as jparams  # noqa: E402
from genrich_tpu.ingest import native as jnative  # noqa: E402
from genrich_tpu_torch import cli as tcli  # noqa: E402
from genrich_tpu_torch import kernels, testing  # noqa: E402
from genrich_tpu_torch import logreader as tlogreader  # noqa: E402
from genrich_tpu_torch import params as tparams  # noqa: E402
from genrich_tpu_torch.ingest import native as tnative  # noqa: E402
from genrich_tpu_torch.io.bed import load_bed  # noqa: E402

JAX_NATIVE = os.path.join(oracle.REPO, "native")
CHROMS = (("chr1", 2_000_000), ("chr2", 1_000_000), ("chr3", 500_000))


def test_the_two_libraries_are_different_files():
    port = tnative.ensure_native()["path"]
    jnative._load()
    assert os.path.dirname(port) == str(kernels.BUILD_DIR)
    assert jnative._lib._name == os.path.join(JAX_NATIVE,
                                              "libgenrich_ingest.so")
    assert tnative._lib._name == port != jnative._lib._name
    with open(os.path.join(tnative.NATIVE_DIR, "ingest.cpp"), "rb") as a, \
            open(os.path.join(JAX_NATIVE, "ingest.cpp"), "rb") as b:
        assert a.read() == b.read()


def _sam(path, seed):
    """About 30,000 templates on three chromosomes (a SAM of about 10 MB,
    so that the record-parse workers take several 4 MiB spans):
    clustered pairs with varied MAPQ and AS, exact duplicates,
    equal-score multimappers (a primary and secondaries of one name),
    orphans (one mate of a pair whose other line is missing) and
    unpaired alignments."""
    b = oracle.SamBuilder(list(CHROMS), seed=seed)
    rng = b.rng
    hot = [(n, rng.randrange(5_000, size - 5_000))
           for n, size in CHROMS for _ in range(6)]
    for i in range(25_000):
        name, hs = rng.choice(hot)
        size = dict(CHROMS)[name]
        p1 = max(0, hs + rng.randrange(-400, 400)) if rng.random() < 0.6 \
            else rng.randrange(0, size - 1_000)
        p2 = min(p1 + rng.randrange(20, 450), size - 60)
        mapq = rng.choice((0, 5, 20, 60, 60))
        multi = i % 13 == 0                  # equal-score multimapper
        q = b.add_pair(name, p1, p2, mapq=mapq,
                       score=-3 if multi else rng.randrange(-12, 1))
        if multi:
            for _ in range(rng.choice((1, 2))):
                other, osize = rng.choice(CHROMS)
                o1 = rng.randrange(0, osize - 1_000)
                b.add_pair(other, o1, o1 + p2 - p1, score=-3, mapq=mapq,
                           secondary=True, qname=q)
        elif i % 17 == 0:                    # an orphan
            b.records[-1].pop(rng.randrange(2))
        if i % 9 == 0:                       # a PCR duplicate
            b.add_pair(name, p1, p2, score=rng.randrange(-12, 1))
    for _ in range(3_000):                   # unpaired alignments
        name, size = rng.choice(CHROMS)
        b.add_single(name, rng.randrange(0, size - 100),
                     reverse=rng.random() < 0.5,
                     score=rng.randrange(-12, 1),
                     paired_flags=rng.random() < 0.5,
                     first=rng.random() < 0.5)
    return b.write(path)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("native_inputs")
    _sam(str(d / "in.sam"), seed=171)
    oracle.sam_to_bam(str(d / "in.sam"), str(d / "in.bam"), framing="bgzf")
    with open(d / "in.sam", "rb") as f, gzip.open(d / "in.sam.gz", "wb") as g:
        g.write(f.read())
    (d / "excl.bed").write_text("chr1\t10000\t60000\nchr1\t900000\t901000\n"
                                "chr2\t0\t25000\n")
    return d


def _ingest(params, native, path, flags, out):
    """Chromosomes, events, counters and the -R/-b bytes of one parse."""
    out.mkdir()
    flags = [{"DUPS": str(out / "dups.log"), "BED": str(out / "frags.bed")}
             .get(f, f) for f in flags]
    p = params.parse_args(["-t", path, "-o", str(out / "out.np")] + flags)
    nat = native.NativeIngest(p, load_bed(p.x_file) if p.x_file else [])
    nat.parse(path, False, 0, p.bed_file, p.dups_file if p.dups_opt
              else None, p.gz_out)
    chroms = nat.chroms()
    events = [nat.events(i) for i in range(len(chroms))]
    files = {f: (out / f).read_bytes() for f in ("dups.log", "frags.bed")
             if (out / f).exists()}
    return chroms, events, nat.counters(), files


INGEST_FLAGS = {
    "y": ["-y"],
    "y-w100": ["-y", "-w", "100"],
    "j-d50": ["-j", "-d", "50"],
    "j-D": ["-j", "-D"],
    "r-R-b": ["-r", "-y", "-R", "DUPS", "-b", "BED"],
    "m10": ["-m", "10", "-y"],
    "e-E": ["-e", "chr3", "-E", "EXCL", "-y"],
}


@pytest.mark.parametrize("threads", ["0", "2", "6"])
@pytest.mark.parametrize("kind", ["sam", "bam", "sam.gz"])
@pytest.mark.parametrize("flags", list(INGEST_FLAGS.values()),
                         ids=list(INGEST_FLAGS))
def test_ingest_equals_the_jax_library(inputs, tmp_path, monkeypatch,
                                       kind, flags, threads):
    monkeypatch.setenv("GENRICH_INGEST_THREADS", threads)
    path = str(inputs / f"in.{kind}")
    flags = [str(inputs / "excl.bed") if f == "EXCL" else f for f in flags]
    j_ch, j_ev, j_ct, j_files = _ingest(jparams, jnative, path, flags,
                                        tmp_path / "jax")
    t_ch, t_ev, t_ct, t_files = _ingest(tparams, tnative, path, flags,
                                        tmp_path / "port")
    assert t_ch == j_ch and t_ct == j_ct and t_files == j_files
    assert j_ct["count"] > 50_000 and sum(e is not None for e in j_ev) >= 2
    assert j_ct["orphan"] > 0 and j_ct["sec_pair"] > 0
    if "-r" in flags:
        assert j_ct["dups_pr"] > 0 and len(j_files) == 2
    for t, j in zip(t_ev, j_ev):
        assert (t is None) == (j is None)
        for a, b in zip(t or (), j or ()):
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


# --- the exact engine's helpers ---------------------------------------------

def _same(got, want):
    """Equal bytes, dtypes and shapes, tuple by tuple."""
    assert (got is None) == (want is None) and got is not None
    if not isinstance(want, tuple):
        got, want = (got,), (want,)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g, w = np.asarray(g), np.asarray(w)
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


def _stat_rows(rng, n=20_000):
    """Coverage rows: -log p / -log q with runs over the threshold,
    interval ends and a few skipped (-1) rows."""
    runs = rng.random(n) < 0.08
    stat = np.where(np.cumsum(runs) % 3 == 0, rng.random(n) * 1.9,
                    2.0 + rng.random(n) * 8).astype(np.float32)
    stat[rng.random(n) < 0.01] = -1.0
    qval = (stat * np.float32(0.7)).astype(np.float32)
    ends = np.cumsum(rng.integers(1, 90, n)).astype(np.int64)
    return stat, qval, ends


@pytest.mark.parametrize("with_q,min_len,max_gap", [
    (False, 0, 100), (True, 0, 100), (True, 50, 0), (False, 200, 2_000)])
def test_call_peaks_native_equal(with_q, min_len, max_gap):
    rng = np.random.default_rng(17 + min_len)
    stat, qval, ends = _stat_rows(rng)
    args = (stat, stat, qval if with_q else None, ends, 2.0, 20.0,
            min_len, max_gap)
    want = jnative.call_peaks_native(*args)
    got = tnative.call_peaks_native(*args)
    _same(got, want)
    assert len(want[0]) > 10


@pytest.fixture(scope="module")
def f_logs(tmp_path_factory):
    """Two -f logs: the port's exact engine's on a small SAM (every
    q-value 1), and rows with q-values under 1 written by the port's row
    writer on two chromosomes, each row starting where the last ended."""
    d = tmp_path_factory.mktemp("native_log")
    oracle.random_sam(str(d / "in.sam"), seed=172, n_pairs=1_500)
    assert tcli.main(["-t", str(d / "in.sam"), "-o", str(d / "out.np"),
                      "-f", str(d / "engine.log"), "-y", "-q", "0.5",
                      "--engine", "exact"]) == 0
    path = str(d / "rows.log")
    open(path, "wb").close()
    with open(d / "engine.log") as f:
        assert tnative.append_text(path, False, f.readline())
    rng = np.random.default_rng(173)
    for chrom in ("chr1", "chr2"):
        stat, qval, ends = _stat_rows(rng)
        starts = np.concatenate([[0], ends[:-1]])
        expt = (stat * 3).astype(np.float32)
        assert tnative.write_log_rows(
            path, False, chrom, starts, ends, expt,
            np.ones_like(expt), stat, qval, (qval > 1).astype(np.uint8))
    return {"engine": str(d / "engine.log"), "rows": path}


@pytest.mark.parametrize("log,use_q,genome_opt", [
    ("engine", False, True), ("rows", False, False), ("rows", True, True)])
def test_call_peaks_log_native_equal(f_logs, log, use_q, genome_opt):
    with open(f_logs[log]) as f:
        idx_p, idx_q = tlogreader._get_idx(f.readline(), use_q)
    args = (f_logs[log], idx_p, idx_q, use_q, 1.0, 5.0, 0, 100, genome_opt)
    want = jnative.call_peaks_log_native(*args)
    got = tnative.call_peaks_log_native(*args)
    assert got[0] == want[0] and got[8:] == want[8:]
    _same(tuple(got[1:8]), tuple(want[1:8]))
    assert len(want[1]) >= 6


def _log_columns(rng, n=5_000):
    starts = np.cumsum(rng.integers(1, 500, n)).astype(np.int64)
    ends = starts + rng.integers(1, 400, n)
    expt = (rng.integers(0, 4_000, n) / 7).astype(np.float32)
    ctrl = (rng.integers(0, 800, n) / 3).astype(np.float32)
    ctrl[rng.random(n) < 0.03] = -1.0              # skipped rows
    pval = (rng.random(n) * 40).astype(np.float32)
    pval[:3] = (0.0, 1e-30, np.float32(3.4e38))
    qval = (pval * np.float32(0.5)).astype(np.float32)
    sig = (pval > 2).astype(np.uint8)
    return starts, ends, expt, ctrl, pval, qval, sig


def _read(path, gz):
    with (gzip.open if gz else open)(path, "rb") as f:
        return f.read()


@pytest.mark.parametrize("gz", [False, True], ids=["plain", "gzip"])
@pytest.mark.parametrize("rows", ["log_q", "log_p", "pile"])
def test_row_writers_equal(tmp_path, rows, gz):
    rng = np.random.default_rng(19)
    starts, ends, expt, ctrl, pval, qval, sig = _log_columns(rng)
    out = {}
    for name, mod in (("jax", jnative), ("port", tnative)):
        path = str(tmp_path / f"{name}.log")
        open(path, "wb").close()
        assert mod.append_text(path, gz, "chr\tstart\tend\t...\n")
        for chrom, sl in (("chr1", slice(0, 3_000)),
                          ("chrUn_x", slice(3_000, None))):
            cols = [a[sl] for a in (starts, ends, expt, ctrl, pval)]
            if rows == "pile":
                assert mod.write_pile_rows(path, gz, chrom, *cols)
            else:
                assert mod.write_log_rows(
                    path, gz, chrom, *cols,
                    qval[sl] if rows == "log_q" else None,
                    sig[sl] if rows == "log_q" else None)
        out[name] = _read(path, gz)
    assert out["port"] == out["jax"] and out["jax"].count(b"\n") == 5_001


def test_breakpoints_equal(inputs, tmp_path):
    path = str(inputs / "in.bam")
    _, events, _, _ = _ingest(tparams, tnative, path, ["-y", "-r"],
                              tmp_path / "events")
    done = 0
    for ev in events:
        if ev is not None:
            _same(tnative.breakpoints(*ev), jnative.breakpoints(*ev))
            done += 1
    assert done >= 2


def test_exact_sum_f32_equal():
    rng = np.random.default_rng(23)
    terms = (rng.standard_normal(100_003) * 10.0 ** rng.integers(
        -6, 7, 100_003)).astype(np.float32)
    for t in (terms, terms[:1], terms[:0]):
        want = jnative.exact_sum_f32(t)
        got = tnative.exact_sum_f32(t)
        assert np.float64(got).tobytes() == np.float64(want).tobytes()


def test_pair_index_tab_equal():
    rng = np.random.default_rng(29)
    expt = rng.integers(0, 40, 50_000).astype(np.float32) / 4
    ctrl = rng.integers(1, 9, 50_000).astype(np.float32) / 2
    ctrl[rng.random(50_000) < 0.05] = -1.0
    ends = np.cumsum(rng.integers(1, 300, 50_000)).astype(np.int64)
    key = (expt.view(np.uint32).astype(np.uint64) << np.uint64(32)) \
        | ctrl.view(np.uint32).astype(np.uint64)
    uk = np.unique(key)
    _same(tnative.pair_index_tab(key, uk, ends),
          jnative.pair_index_tab(key, uk, ends))
    assert tnative.pair_index_tab(key, uk[1:], ends) is None \
        and jnative.pair_index_tab(key, uk[1:], ends) is None


def test_log10f_arr_native_equal():
    rng = np.random.default_rng(31)
    x = np.concatenate([
        (rng.random(100_000) * 10.0 ** rng.integers(-38, 38, 100_000)),
        [0.0, 1.0, 10.0, 1e-45, 1e-40, np.inf, -1.0, np.nan]]
    ).astype(np.float32)
    _same(tnative.log10f_arr_native(x), jnative.log10f_arr_native(x))


# the port's helpers that load the library themselves, with an argument
# for each
_HELPERS = {
    "call_peaks_native": lambda: tnative.call_peaks_native(
        np.array([1, 3, 3, 1], np.float32), np.ones(4, np.float32), None,
        np.array([5, 9, 12, 20]), 2.0, 1.0, 0, 10),
    "breakpoints": lambda: tnative.breakpoints(
        np.array([0, 5]), np.array([9, 12]), np.array([1, 1])),
    "exact_sum_f32": lambda: tnative.exact_sum_f32(np.ones(3, np.float32)),
    "pair_index_tab": lambda: tnative.pair_index_tab(
        np.array([2, 1], np.uint64), np.array([1, 2], np.uint64),
        np.array([3, 7])),
    "log10f_arr_native": lambda: tnative.log10f_arr_native(
        np.ones(4, np.float32)),
}


@pytest.mark.parametrize("helper", list(_HELPERS))
def test_helper_loads_the_port_library_first(helper, monkeypatch):
    """A helper called before anything else loaded the library loads the
    port's own (building it at first use) and does not fall back."""
    monkeypatch.setattr(tnative, "_lib", None)
    monkeypatch.setattr(tnative, "INFO", {})
    assert _HELPERS[helper]() is not None
    assert tnative._lib is not None
    assert os.path.dirname(tnative._lib._name) == str(kernels.BUILD_DIR)


# --- the build ---------------------------------------------------------------

_BUILD_CHILD = """
import json, sys, time
from pathlib import Path
from genrich_tpu_torch.ingest import native
native.BUILD_DIR = Path(sys.argv[1])
t0 = time.perf_counter()
info = dict(native.ensure_native())
print(json.dumps({**info, "loaded": native._lib._name,
                  "wall": time.perf_counter() - t0}))
"""


def test_build_is_cached_and_two_processes_build_once(tmp_path):
    env = {**os.environ, "PYTHONPATH": oracle.REPO}
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_CHILD,
                               str(tmp_path)], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, env=env)
             for _ in range(2)]
    outs = [p.communicate(timeout=600) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], [e for _, e in outs]
    infos = [json.loads(o.splitlines()[-1]) for o, _ in outs]
    assert sorted(i["cached"] for i in infos) == [False, True]
    assert infos[0]["path"] == infos[1]["path"] == infos[0]["loaded"] \
        == infos[1]["loaded"]
    assert os.path.dirname(infos[0]["path"]) == str(tmp_path)
    assert sorted(p.name for p in tmp_path.glob("*.so")) == [
        f"libgenrich_ingest_{tnative.source_hash()}.so"]
    again = tnative.build_native(tmp_path)
    assert again["cached"] and again["path"] == infos[0]["path"]
    assert again["libdeflate"] == infos[0]["libdeflate"]


_CLI_CHILD = """
import json, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
from genrich_tpu_torch import testing
from genrich_tpu_torch.cli import main
assert main(sys.argv[3:]) == 0
print(json.dumps({"jax": testing.mapped_files(sys.argv[1]),
                  "port": testing.mapped_files(sys.argv[2])}))
"""


@pytest.mark.parametrize("flags", [
    ["-r", "-j", "-f", "f.log", "-k", "k.log", "--device", "cpu"],
    ["--engine", "exact", "-y", "-f", "f.log", "-k", "k.log"]],
    ids=["jax", "exact"])
def test_cli_run_maps_no_file_of_the_jax_package(tmp_path, flags):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=173, n_pairs=400)
    env = {**os.environ, "PYTHONPATH": oracle.REPO}
    env.pop("JAX_PLATFORMS", None)
    r = subprocess.run(
        [sys.executable, "-c", _CLI_CHILD, JAX_NATIVE,
         str(kernels.BUILD_DIR), "-t", "in.sam", "-o", "out.np", "-a", "5",
         *flags], cwd=str(tmp_path), capture_output=True, text=True,
        env=env)
    assert r.returncode == 0, r.stderr[-1500:]
    maps = json.loads(r.stdout.splitlines()[-1])
    assert maps["jax"] == []
    assert [os.path.basename(p) for p in maps["port"]] == [
        f"libgenrich_ingest_{tnative.source_hash()}.so"]
    assert (tmp_path / "f.log").exists() and (tmp_path / "k.log").exists()
