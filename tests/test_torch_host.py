"""The port's copy of the host half against the JAX package's original.

``genrich_tpu_torch`` keeps its own copy of the modules it runs on the
host (params, ingest, the exact engine's host numerics, writers,
logreader, a pipeline cut to the device engine).  Each test feeds the
copy and its original the same input and requires the same result:
equal ``Params``; identical ingest events and counters (native and
Python readers, SAM and BAM); byte-identical ``-P`` output and stderr;
and, for whole CLI runs, byte-identical ``-v`` stderr and narrowPeak
columns 1-6 against ``--engine exact`` (the float columns come from the
float32 device path, held to 1e-4 by test_torch_cli.py).
"""

from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

from genrich_tpu import cli as jcli  # noqa: E402
from genrich_tpu import logreader as jlogreader  # noqa: E402
from genrich_tpu import params as jparams  # noqa: E402
from genrich_tpu import pipeline as jpipeline  # noqa: E402
from genrich_tpu.errors import GenrichError as JGenrichError  # noqa: E402
from genrich_tpu.ingest import chroms as jchroms  # noqa: E402
from genrich_tpu.ingest import intervals as jintervals  # noqa: E402
from genrich_tpu.ingest import native as jnative  # noqa: E402
from genrich_tpu_torch import cli as tcli  # noqa: E402
from genrich_tpu_torch import logreader as tlogreader  # noqa: E402
from genrich_tpu_torch import params as tparams  # noqa: E402
from genrich_tpu_torch import pipeline as tpipeline  # noqa: E402
from genrich_tpu_torch.errors import GenrichError as TGenrichError  # noqa
from genrich_tpu_torch.ingest import chroms as tchroms  # noqa: E402
from genrich_tpu_torch.ingest import intervals as tintervals  # noqa: E402
from genrich_tpu_torch.ingest import native as tnative  # noqa: E402

JAX = (jparams, jpipeline, jchroms, jintervals, jnative)
PORT = (tparams, tpipeline, tchroms, tintervals, tnative)

# the flag sets that the repo's end-to-end verification recipe exercises
FLAG_SETS = [
    [],
    ["-q", "0.05"],
    ["-j", "-d", "50", "-D"],
    ["-r", "-R", "dups.log"],
    ["-c", "ctrl.sam"],
    ["-t", "a.sam,b.sam"],
    ["-E", "excl.bed", "-e", "chr2"],
    ["-f", "log", "-k", "pile", "-b", "bed"],
    ["-X", "-f", "log"],
    ["-P", "-f", "log"],
    ["-z"],
    ["-m", "10", "-s", "2.5", "-w", "150", "-l", "30", "-g", "50",
     "-L", "1000000"],
]
BASE = ["-t", "in.sam", "-o", "out.np", "-p", "0.01", "-a", "20", "-y",
        "-v"]


def _argv(flags):
    argv = list(BASE)
    if "-t" in flags:
        argv[1] = flags[flags.index("-t") + 1]
        flags = [f for i, f in enumerate(flags)
                 if f != "-t" and (i == 0 or flags[i - 1] != "-t")]
    return argv + flags


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f)
                         or "base")
def test_parse_args_equal_params(flags):
    want = jparams.parse_args(_argv(flags))
    got = tparams.parse_args(_argv(flags))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", [
    ["-t", "in.sam"], ["-t", "in.sam", "-o", "out", "-p", "x"],
    ["-t", "in.sam", "-o", "o", "-d", "x"],
    ["-t", "in.sam", "-o", "o", "-Q"]])
def test_parse_args_equal_errors(argv):
    with pytest.raises(JGenrichError) as want:
        jparams.parse_args(argv)
    with pytest.raises(TGenrichError) as got:
        tparams.parse_args(argv)
    assert got.value.render() == want.value.render()


def test_usage_is_the_jax_packages():
    assert tcli.USAGE == jcli.USAGE


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("host_inputs")
    oracle.random_sam(str(d / "in.sam"), seed=81, n_pairs=800)
    oracle.sam_to_bam(str(d / "in.sam"), str(d / "in.bam"))
    return d


def _ingest(pkg, path, flags, use_native):
    """Events per chromosome name and the counters of one file."""
    params, pipeline, chroms, intervals, native = pkg
    p = params.parse_args(["-t", path, "-o", "out.np"] + flags)
    registry = chroms.ChromRegistry(p.xchr_list, [], p.verbose)
    sink = intervals.EventSink()
    if use_native:
        nat = native.NativeIngest(p, [])
        counters = pipeline._parse_file_native(nat, path, registry, p,
                                               sink, False, 0)
    else:
        counters, writer, _ = pipeline._parse_file(
            path, registry, p, sink, None, None, False, 0)
        counters.err_count = writer.err_count
    events = {c.name: [np.asarray(a, np.int64)
                       for a in sink.by_chrom[c.index]]
              for c in registry if c.index in sink.by_chrom}
    return events, dataclasses.asdict(counters)


@pytest.mark.parametrize("use_native", [True, False],
                         ids=["native", "python"])
@pytest.mark.parametrize("kind", ["sam", "bam"])
@pytest.mark.parametrize("flags", [["-y"], ["-r", "-j", "-y"]],
                         ids=["y", "r-j-y"])
def test_ingest_events_and_counters_equal(inputs, kind, use_native,
                                          flags):
    if use_native and not jnative.available(build=False):
        pytest.fail("the committed native ingest library does not load")
    path = str(inputs / f"in.{kind}")
    want_ev, want_ct = _ingest(JAX, path, flags, use_native)
    got_ev, got_ct = _ingest(PORT, path, flags, use_native)
    assert got_ct == want_ct
    assert got_ev.keys() == want_ev.keys() and want_ev
    for name in want_ev:
        for g, w in zip(got_ev[name], want_ev[name]):
            np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def x_log(inputs):
    """An -f log with -log(q) columns, written by the port with -X."""
    d = inputs / "xlog"
    d.mkdir()
    rc = tcli.main(["-t", str(inputs / "in.sam"), "-X", "-f",
                    str(d / "x.log"), "-y", "-q", "0.2",
                    "--device", "cpu"])
    assert rc == 0
    return d / "x.log"


@pytest.mark.parametrize("flags", [
    ["-p", "0.01", "-a", "20"], ["-q", "0.2", "-a", "10"],
    ["-p", "0.01", "-a", "5", "-e", "chr2", "-l", "40", "-g", "20"]],
    ids=["p", "q", "posthoc-e"])
def test_logreader_output_and_stderr_identical(x_log, tmp_path, flags,
                                               capsys):
    out = {}
    for name, params, logreader in (("jax", jparams, jlogreader),
                                    ("port", tparams, tlogreader)):
        path = tmp_path / f"{name}.np"
        p = params.parse_args(["-P", "-f", str(x_log), "-o", str(path),
                               "-v"] + flags)
        capsys.readouterr()
        logreader.find_peaks_only(p)
        out[name] = (path.read_bytes(), capsys.readouterr().err)
    assert out["port"] == out["jax"]
    assert "Peaks identified" in out["jax"][1]
    # every q-value of this small input is 1: the q case calls no peak
    assert bool(out["jax"][0]) == ("-p" in flags)


@pytest.fixture(scope="module")
def cli_inputs(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli_inputs")
    oracle.random_sam(str(d / "a.sam"), seed=71)
    oracle.random_sam(str(d / "b.sam"), seed=72)
    oracle.random_sam(str(d / "c.sam"), seed=73, n_pairs=300)
    oracle.sam_to_bam(str(d / "a.sam"), str(d / "a.bam"))
    (d / "excl.bed").write_text("chr1\t1000\t5000\nchr2\t100\t900\n")
    return d


@pytest.mark.parametrize("flags", [
    ["-t", "a.sam", "-y", "-p", "0.01"],
    ["-t", "a.bam", "-r", "-j", "-q", "0.05"],
    ["-t", "a.sam,b.sam", "-y", "-p", "0.01"],
    ["-t", "a.sam", "-c", "c.sam", "-y", "-p", "0.01"],
    ["-t", "a.sam", "-E", "excl.bed", "-e", "chr3", "-y", "-p", "0.05"]],
    ids=["main", "bam-r-j-q", "two-reps", "ctrl", "excl"])
def test_cli_stderr_identical_to_exact_engine(cli_inputs, tmp_path,
                                              flags, capsys,
                                              monkeypatch):
    args = [str(cli_inputs / f) if f.endswith((".sam", ".bam", ".bed"))
            else f for f in flags]
    args = [",".join(str(cli_inputs / x) for x in a.split(","))
            if "," in a else a for a in args]
    got = {}
    for name, main, extra in (("exact", jcli.main, ["--engine", "exact"]),
                              ("port", tcli.main, ["--device", "cpu"])):
        d = tmp_path / name
        d.mkdir()
        monkeypatch.chdir(d)
        capsys.readouterr()
        assert main(args + ["-o", "out.np", "-a", "20", "-v"] + extra) == 0
        got[name] = ((d / "out.np").read_text().splitlines(),
                     capsys.readouterr().err)
    (want_rows, want_err), (rows, err) = got["exact"], got["port"]
    assert err == want_err and "Peaks identified" in err
    assert [r.split("\t")[:6] for r in rows] \
        == [r.split("\t")[:6] for r in want_rows]


# --- the numpy copies of genrich_tpu/parallel ------------------------------

def _tile_peaks(rng, n_tiles=24, cap=8, tile_len=4096):
    """Random per-tile peak arrays (numpy) for the boundary merge."""
    from genrich_tpu.ops.peaks_jax import TilePeaks
    from genrich_tpu.ops.pipeline_jax import TileResult
    shape = (n_tiles, cap)
    starts = rng.randint(0, tile_len - 2, shape).astype(np.int32)
    f32 = lambda hi: (rng.rand(*shape) * hi).astype(np.float32)  # noqa
    cand = rng.rand(*shape) < 0.4
    pk = TilePeaks(starts, np.minimum(starts + rng.randint(1, 2000, shape),
                                      tile_len).astype(np.int32), f32(50),
                   f32(10), f32(10), rng.randint(0, 99, shape).astype(
                       np.int32), cand, cand,
                   rng.choice(np.float32([1, 2, 3]), shape),
                   rng.randint(1, 4, shape).astype(np.int32),
                   rng.rand(n_tiles) < 0.2, rng.rand(n_tiles) < 0.2,
                   np.int32(0))
    return TileResult(pk, None, None)


@pytest.mark.parametrize("name", [
    "split_events_to_tiles", "split_excl_to_tiles", "merge_tile_peaks",
    "_merge_tile_peaks_loop", "exact_q_table", "local_tile_range"])
def test_parallel_numpy_copies_equal(name):
    """Each numpy helper of genrich_tpu_torch.parallel against its
    original in genrich_tpu.parallel, on one input: equal results."""
    from genrich_tpu.parallel import distributed as jd, mesh as jm
    from genrich_tpu_torch.parallel import distributed as td, mesh as tm
    rng = np.random.RandomState(9)
    start = rng.randint(0, 60_000, 500).astype(np.int64)
    end = np.minimum(start + rng.randint(1, 9000, 500), 65_536)
    count = rng.randint(1, 11, 500).astype(np.int32)
    args = {
        "split_events_to_tiles": (start, end, count, 16, 4096),
        "split_excl_to_tiles": ([100, 5000, 9000, 9001, 20_000, 41_000], 16,
                                4096),
        "merge_tile_peaks": (_tile_peaks(rng), 4096, 12.0, 10, 80),
        "exact_q_table": (np.float32([0.5, 1.5, np.inf, 2.5, 0.5, np.inf]),
                          np.int64([10, 20, 0, 5, 7, 0]),
                          np.int32([2, 2, 0]), 2, 1000),
        "local_tile_range": (8,),
    }
    args["_merge_tile_peaks_loop"] = args["merge_tile_peaks"]
    src = jd if name == "local_tile_range" else jm
    dst = td if src is jd else tm
    want = getattr(src, name)(*args[name])
    got = getattr(dst, name)(*args[name])
    if isinstance(want, np.ndarray):
        got, want = (got,), (want,)
    assert len(want) and len(got) == len(want)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
