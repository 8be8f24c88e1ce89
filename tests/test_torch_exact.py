"""``--engine exact`` of the port against the JAX package's, byte for byte.

The port's ``cli.main`` runs in this process; ``genrich_tpu``'s
``--engine exact`` runs in a fresh child process per case, because one
of its runs with ``-q`` leaves the JAX package's native binding unable
to serve a later ``-P`` in the same process (``_log_ready``, ROADMAP
Queue 3), and a test worker runs other files' in-process ``-P`` runs
after this file.  Cases: every flag set of
``test_torch_host.FLAG_SETS`` (``-X`` then ``-P`` in one process on each
side), the six fixtures of ``test_engine_jax_cli.py`` (the 3 Gbp
``chrBig`` one among them), three replicates with ``-q`` and two
replicates with their controls under Genrich's ChIP flags (``-t a,b -c
c,c -r -E x.bed -e chr2 -p 0.01 -a 20``).  Every file
a run writes (narrowPeak, ``-f``, ``-k``, ``-b``, ``-R``; ``-z`` outputs
decompressed) must be byte-identical, and so must the ``-v`` stderr.

Then ``tools/find_ns`` against ``genrich_tpu.tools.find_ns`` on a FASTA
made from a seed, with leading, trailing and all-N sequences: the same
BED bytes and stderr, with the default ``minLen`` and with 20.
"""

from __future__ import annotations

import gzip
import os
import random
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402
from test_torch_host import FLAG_SETS, _argv  # noqa: E402

from genrich_tpu_torch import cli as tcli  # noqa: E402

# argv lists as JSON-free Python literals: the child runs each in turn
# and stops at the first failure
_JAX_CHILD = """
import sys
from genrich_tpu.cli import main
rc = 0
for argv in {runs!r}:
    rc = rc or main(argv)
sys.exit(rc)
"""


def _env():
    return {**os.environ, "PYTHONPATH": oracle.REPO, "JAX_PLATFORMS": "cpu"}


def _outputs(d):
    """{name: bytes} of every file in ``d``, gzip members decompressed."""
    out = {}
    for name in sorted(os.listdir(d)):
        data = (d / name).read_bytes()
        out[name] = gzip.decompress(data) if data[:2] == b"\x1f\x8b" \
            else data
    return out


def _both(tmp_path, runs, capsys, monkeypatch):
    """The runs (argv lists, outputs relative to the cwd) through the
    JAX package's exact engine in a child process and the port's in this
    one; returns ((outputs, stderr) JAX, (outputs, stderr) port)."""
    jd, td = tmp_path / "jax", tmp_path / "port"
    jd.mkdir()
    td.mkdir()
    r = subprocess.run([sys.executable, "-c", _JAX_CHILD.format(
        runs=[a + ["--engine", "exact"] for a in runs])], cwd=str(jd),
        capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    monkeypatch.chdir(td)
    capsys.readouterr()
    for argv in runs:
        assert tcli.main(argv + ["--engine", "exact"]) == 0
    err = capsys.readouterr().err
    return (_outputs(jd), r.stderr), (_outputs(td), err)


def _assert_same(want, got):
    (w_files, w_err), (g_files, g_err) = want, got
    assert sorted(g_files) == sorted(w_files)
    for name in w_files:
        assert g_files[name] == w_files[name], name
    assert g_err == w_err


@pytest.fixture(scope="module")
def flag_inputs(tmp_path_factory):
    """The inputs that FLAG_SETS name: in.sam, ctrl.sam, a.sam, b.sam,
    excl.bed."""
    d = tmp_path_factory.mktemp("exact_inputs")
    oracle.random_sam(str(d / "in.sam"), seed=81, n_pairs=800)
    oracle.random_sam(str(d / "ctrl.sam"), seed=82, cluster=False,
                      n_pairs=300)
    oracle.random_sam(str(d / "a.sam"), seed=71)
    oracle.random_sam(str(d / "b.sam"), seed=72)
    (d / "excl.bed").write_text("chr1\t1000\t5000\nchr2\t100\t900\n")
    return d


def _abs_inputs(argv, d):
    """Input names of ``argv`` as paths under ``d`` (outputs stay
    relative); the -v stderr then names the same files on both sides."""
    return [",".join(str(d / x) for x in a.split(","))
            if a.endswith((".sam", ".bed")) else a for a in argv]


@pytest.mark.parametrize("flags", FLAG_SETS, ids=lambda f: " ".join(f)
                         or "base")
def test_flag_set_identical(flag_inputs, tmp_path, flags, capsys,
                            monkeypatch):
    runs = [_argv(flags)]
    if "-P" in flags:
        # -P reads the -f log that -X wrote, in the same process
        runs.insert(0, _argv(["-X", "-f", "log"]))
    runs = [_abs_inputs(a, flag_inputs) for a in runs]
    want, got = _both(tmp_path, runs, capsys, monkeypatch)
    _assert_same(want, got)
    if "-X" not in flags:
        assert "Peaks identified" in want[1]
        # every q-value of this input is 1: -q 0.05 calls no peak
        name = "out.np.gz" if "-z" in flags else "out.np"
        assert bool(want[0][name]) == ("-q" not in flags), name


def _fixture(d, case):
    """argv (outputs relative) of one case: test_engine_jax_cli.py's six
    fixtures, three replicates with -q, and two with controls and the
    ChIP flags."""
    base = ["-o", "out.np", "-y", "-p", "0.01", "-a", "20", "-v"]
    sam = str(d / "in.sam")
    if case == "boundaries":
        oracle.random_sam(sam, seed=71)
        return ["-t", sam] + base
    if case == "bam":
        oracle.random_sam(sam, seed=77)
        oracle.sam_to_bam(sam, str(d / "in.bam"))
        return ["-t", str(d / "in.bam")] + base
    if case in ("fisher", "three_reps_q"):
        oracle.random_sam(sam, seed=81)
        oracle.random_sam(str(d / "b.sam"), seed=82, n_pairs=250)
        reps = [sam, str(d / "b.sam")]
        if case == "fisher":
            return ["-t", ",".join(reps)] + base
        oracle.random_sam(str(d / "c.sam"), seed=83, n_pairs=300)
        return ["-t", ",".join(reps + [str(d / "c.sam")])] + base \
            + ["-q", "0.5"]
    if case == "ctrl_excl":
        oracle.random_sam(sam, seed=72)
        oracle.random_sam(str(d / "c.sam"), seed=73, cluster=False,
                          n_pairs=150)
        (d / "x.bed").write_text("chr1\t2000\t9000\n")
        return ["-t", sam] + base + ["-c", str(d / "c.sam"), "-E",
                                     str(d / "x.bed"), "-q", "0.5"]
    if case == "chip_fisher":
        # Genrich's ChIP flags on two replicates with their controls
        oracle.random_sam(sam, seed=84)
        oracle.random_sam(str(d / "b.sam"), seed=85, n_pairs=250)
        oracle.random_sam(str(d / "c.sam"), seed=86, cluster=False,
                          n_pairs=200)
        (d / "x.bed").write_text("chr1\t2000\t9000\nchr1\t40000\t41000\n")
        c = str(d / "c.sam")
        return ["-t", f"{sam},{d / 'b.sam'}", "-c", f"{c},{c}", "-r",
                "-E", str(d / "x.bed"), "-e", "chr2", "-f", "f.log"] + base
    if case == "logs":
        oracle.random_sam(sam, seed=91)
        return ["-t", sam] + base + ["-f", "f.log", "-k", "k.log"]
    assert case == "big_chrom"
    oracle.random_sam(sam, chroms=(("chrBig", 3_000_000_000),
                                   ("chr2", 50000)), seed=101, n_pairs=400)
    return ["-t", sam] + base + ["-q", "0.5"]


@pytest.mark.parametrize("case", ["boundaries", "bam", "fisher",
                                  "ctrl_excl", "logs", "big_chrom",
                                  "three_reps_q", "chip_fisher"])
def test_fixture_identical(tmp_path, case, capsys, monkeypatch):
    args = _fixture(tmp_path, case)
    want, got = _both(tmp_path, [args], capsys, monkeypatch)
    _assert_same(want, got)
    assert want[0]["out.np"]
    if case == "big_chrom":
        assert any(int(ln.split(b"\t")[1]) > 0x7FFFFFFF
                   for ln in want[0]["out.np"].splitlines()
                   if ln.startswith(b"chrBig\t"))


# --- tools/find_ns ---------------------------------------------------------

def _fasta(path):
    """Random sequences with N runs, plus leading and trailing runs and
    an all-N sequence; 60 bases per line, descriptions after the name."""
    rng = random.Random(7)
    seqs = []
    for i in range(4):
        parts = []
        for _ in range(30):
            parts.append("".join(rng.choice("ACGT") for _ in
                                 range(rng.randrange(10, 300))))
            parts.append(rng.choice("Nn") * rng.randrange(1, 300))
        seqs.append((f"chr{i}", "".join(parts)))
    seqs.append(("chrN", "N" * 250 + "ACGT" * 50 + "N" * 150))
    seqs.append(("chrAllN", "N" * 500))
    with open(path, "w") as f:
        for name, seq in seqs:
            f.write(f">{name} extra desc\n")
            for i in range(0, len(seq), 60):
                f.write(seq[i:i + 60] + "\n")


@pytest.mark.parametrize("min_len", [None, 20], ids=["default", "20"])
def test_find_ns_identical(tmp_path, min_len):
    _fasta(tmp_path / "in.fa")
    got = {}
    for pkg in ("genrich_tpu", "genrich_tpu_torch"):
        d = tmp_path / pkg
        d.mkdir()
        r = subprocess.run([sys.executable, "-m", f"{pkg}.tools.find_ns",
                            "../in.fa", "out.bed"]
                           + ([str(min_len)] if min_len else []),
                           cwd=str(d), capture_output=True, text=True,
                           env=_env())
        got[pkg] = (r.returncode, (d / "out.bed").read_bytes(), r.stderr)
    want = got["genrich_tpu"]
    assert want[0] == 0 and want[1].count(b"\n") > 10
    assert b"chrAllN\t0\t499\n" in want[1]      # the trailing-run quirk
    assert got["genrich_tpu_torch"] == want
