"""Import and fallback guards of the port's CLI.

The port stands alone: no module of it, and no line that chip_smoke.py
runs in its own process, imports jax or genrich_tpu, and every CLI path
(``--engine sharded``, ``--engine exact`` and ``--serve`` among them,
``genrich_tpu_torch.parallel`` and ``tools.find_ns``) runs on the CPU
with both imports refused.  ``--device cuda`` with no card is an error,
never a silent switch to the CPU, on the CLI as in serve, except for
``--engine exact``: the host engine touches no CUDA API and runs on a
host with no card.
"""

from __future__ import annotations

import ast
import os
import re
import subprocess
import sys

import pytest

sys.path.insert(0, os.path.dirname(__file__))
import oracle  # noqa: E402

def _env():
    env = {**os.environ, "PYTHONPATH": oracle.REPO}
    env.pop("JAX_PLATFORMS", None)
    return env


def _port(args, cwd):
    return subprocess.run([sys.executable, "-m", "genrich_tpu_torch"]
                          + args, cwd=cwd, capture_output=True,
                          text=True, env=_env())


@pytest.fixture
def sam(tmp_path):
    path = tmp_path / "in.sam"
    oracle.random_sam(str(path), seed=5, n_pairs=120)
    return str(path)


def test_cpu_run_never_imports_jax(tmp_path, sam):
    code = ("import sys\n"
            "from genrich_tpu_torch.cli import main\n"
            f"rc = main(['-t', {sam!r}, '-o', 'out.np', '-y', '-p', "
            "'0.05', '-a', '5', '--device', 'cpu'])\n"
            "assert rc == 0, rc\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    assert (tmp_path / "out.np").exists()


@pytest.mark.parametrize("flags", [
    ["-f", "f.log", "-k", "k.log"], ["-X", "-f", "f.log"], "two_reps",
    ["--engine", "exact", "-f", "f.log", "-k", "k.log"], "find_ns"])
def test_cpu_run_never_imports_jax_on_other_paths(tmp_path, sam, flags):
    args = ["-t", f"{sam},{sam}", "-o", "out.np", "-y", "-a", "5"] \
        if flags == "two_reps" \
        else ["-t", sam, "-o", "out.np", "-y", "-a", "5"] + list(flags)
    run = f"from genrich_tpu_torch.cli import main\n" \
          f"rc = main({args + ['--device', 'cpu']!r})\n"
    if flags == "find_ns":
        (tmp_path / "in.fa").write_text(">c1\nACGT" + "N" * 150 + "\n")
        run = ("from genrich_tpu_torch.tools.find_ns import main\n"
               "rc = main(['in.fa', 'f.log'])\n")
    code = ("import sys\n" + run + "assert rc == 0, rc\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    assert (tmp_path / "f.log").exists() or flags == "two_reps"


def test_every_module_imports_without_jax(tmp_path):
    """Every module of the package (the profiler and the helpers that
    chip_smoke.py imports among them) loads without jax and without
    building or launching anything."""
    code = ("import importlib, pkgutil, sys\n"
            "import genrich_tpu_torch as pkg\n"
            "names = [m.name for m in pkgutil.walk_packages(\n"
            "    pkg.__path__, 'genrich_tpu_torch.')\n"
            "         if not m.name.endswith('__main__')]\n"
            "for n in names:\n"
            "    importlib.import_module(n)\n"
            "from genrich_tpu_torch import kernels\n"
            "assert kernels._lib is None\n"
            "print('MODULES', len(names), *names)\n"
            "print('JAX_LOADED', 'jax' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "JAX_LOADED False" in r.stdout
    modules = r.stdout.split("MODULES")[1].split("\n")[0].split()
    assert int(modules[0]) >= 50
    assert {"genrich_tpu_torch.pipeline", "genrich_tpu_torch.tools",
            "genrich_tpu_torch.tools.find_ns",
            "genrich_tpu_torch.bench"} <= set(modules[1:])


REFUSED = ("jax", "genrich_tpu")


def _imports(path):
    """(line, module) of every import statement in ``path``, plus the
    first argument of each ``importlib.import_module`` / ``__import__``
    call given as a string constant."""
    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Import):
            found += [(node.lineno, a.name) for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            found.append((node.lineno, node.module))
        elif isinstance(node, ast.Call) and node.args \
                and isinstance(node.args[0], ast.Constant) \
                and isinstance(node.args[0].value, str) \
                and getattr(node.func, "attr",
                            getattr(node.func, "id", None)) \
                in ("import_module", "__import__"):
            found.append((node.lineno, node.args[0].value))
    return [(ln, m) for ln, m in found
            if m.split(".")[0] in REFUSED]


def test_no_module_of_the_port_imports_jax_or_genrich_tpu():
    pkg = os.path.join(oracle.REPO, "genrich_tpu_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    assert len(paths) >= 52
    bad = {os.path.relpath(p, pkg): _imports(p) for p in paths}
    assert not {k: v for k, v in bad.items() if v}


def test_chip_smoke_imports_neither_in_its_own_process():
    """The AST of the file: what the smoke's own process imports (a
    child's code string is text to it; the next test reads those)."""
    assert _imports(os.path.join(oracle.REPO, "chip_smoke.py")) == []


# an import of jax or genrich_tpu (not genrich_tpu_torch) in code text
_IMPORT_TEXT = re.compile(
    r"\bfrom\s+(?:genrich_tpu|jax)(?:\.[\w.]+)?\s+import\b"
    r"|\bimport\s+(?:genrich_tpu|jax)(?![\w])")


def _import_strings(path):
    """(line, text) of every string constant of ``path`` that imports
    jax or genrich_tpu (code run by ``python -c``, ``exec`` or a child)
    or names genrich_tpu as a module (``-m genrich_tpu``)."""
    found = []
    for node in ast.walk(ast.parse(open(path).read(), path)):
        if isinstance(node, ast.Constant) and isinstance(node.value, str) \
                and _IMPORT_TEXT.search(node.value):
            found.append((node.lineno, node.value[:80]))
        if isinstance(node, (ast.List, ast.Tuple)):
            words = [e.value if isinstance(e, ast.Constant) else None
                     for e in node.elts]
            found += [(node.lineno, f"-m {b}") for a, b in zip(words,
                                                              words[1:])
                      if a == "-m" and isinstance(b, str)
                      and re.fullmatch(r"genrich_tpu(?:\.[\w.]+)?", b)]
    return found


def test_no_code_string_of_the_port_or_the_smoke_imports_the_jax_package(
        tmp_path):
    """Neither chip_smoke.py nor any module of genrich_tpu_torch runs
    jax or genrich_tpu in a child process: no string of theirs imports
    either or names genrich_tpu as a module to run."""
    pkg = os.path.join(oracle.REPO, "genrich_tpu_torch")
    paths = [os.path.join(d, f) for d, _, fs in os.walk(pkg)
             for f in fs if f.endswith(".py")]
    paths.append(os.path.join(oracle.REPO, "chip_smoke.py"))
    bad = {os.path.relpath(p, oracle.REPO): _import_strings(p)
           for p in paths}
    assert not {k: v for k, v in bad.items() if v}
    # the check finds each kind of such string, and not the port's
    probe = tmp_path / "probe.py"
    probe.write_text(
        'A = "import sys; from genrich_tpu.ingest import native"\n'
        'B = [sys.executable, "-m", "genrich_tpu", "-t", "x"]\n'
        'C = "import jax.numpy as jnp"\n'
        'D = "from genrich_tpu_torch import cli; import genrich_tpu_torch"\n'
        'E = [sys.executable, "-m", "genrich_tpu_torch"]\n')
    assert [ln for ln, _ in _import_strings(str(probe))] == [1, 2, 3]


# (name, flags, files the run must write); each CLI path of the port
PATHS = [
    ("main", ["-y", "-p", "0.01", "-a", "5"], ["out.np"]),
    ("two_reps", ["-t2", "-y", "-p", "0.01", "-a", "5"], ["out.np"]),
    ("logs", ["-f", "f.log", "-k", "k.log", "-y", "-a", "5"],
     ["f.log", "k.log", "out.np"]),
    ("X_then_P", ["-X", "-f", "x.log", "-y", "-q", "0.5"], ["x.log"]),
    ("ctrl", ["-c", "CTRL", "-y", "-p", "0.01", "-a", "5"], ["out.np"]),
    ("excl", ["-E", "EXCL", "-e", "chr2", "-y", "-p", "0.05", "-a", "5"],
     ["out.np"]),
    ("sharded", ["--engine", "sharded", "-c", "CTRL", "-E", "EXCL", "-y",
                 "-q", "0.5"], ["out.np"]),
    ("sharded_fisher_logs", ["-t2", "--engine", "sharded", "-f", "f.log",
                             "-y", "-a", "5"], ["f.log", "out.np"]),
]

_REFUSE = """
import sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
from genrich_tpu_torch.cli import main
for argv in {runs!r}:
    rc = main(argv + ["--device", "cpu"])
    assert rc == 0, (rc, argv)
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}
                       & {{"jax", "genrich_tpu"}}))
"""


@pytest.mark.parametrize("name,flags,outputs", PATHS,
                         ids=[p[0] for p in PATHS])
def test_cpu_path_runs_with_jax_and_genrich_tpu_refused(tmp_path, sam,
                                                        name, flags,
                                                        outputs):
    ctrl = tmp_path / "ctrl.sam"
    oracle.random_sam(str(ctrl), seed=6, n_pairs=60)
    (tmp_path / "excl.bed").write_text("chr1\t1000\t5000\n")
    ts = f"{sam},{sam}" if "-t2" in flags else sam
    flags = [{"CTRL": str(ctrl), "EXCL": str(tmp_path / "excl.bed")}
             .get(f, f) for f in flags if f != "-t2"]
    runs = [["-t", ts, "-o", "out.np"] + flags]
    if name == "X_then_P":
        runs = [["-t", ts] + flags,
                ["-P", "-f", "x.log", "-o", "out.np", "-q", "0.5"]]
        outputs = outputs + ["out.np"]
    r = subprocess.run([sys.executable, "-c", _REFUSE.format(runs=runs)],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "LOADED []" in r.stdout
    for f in outputs:
        assert (tmp_path / f).exists(), f


def test_cuda_without_card_fails_clearly(tmp_path, sam):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: --device cuda would run")
    r = _port(["-t", sam, "-o", "out.np", "-y", "--device", "cuda"],
              str(tmp_path))
    assert r.returncode != 0
    assert "CUDA" in r.stderr and "Error!" in r.stderr
    assert not (tmp_path / "out.np").exists()


def test_default_device_is_cuda(tmp_path, sam):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the default would run")
    r = _port(["-t", sam, "-o", "out.np", "-y"], str(tmp_path))
    assert r.returncode == 1 and "CUDA" in r.stderr


_EXACT = """
import io, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
args = {args!r}
if {serve!r}:
    from genrich_tpu_torch.serve import serve_loop
    out = io.StringIO()
    assert serve_loop([], io.StringIO(" ".join(args) + "\\n"), out,
                      device="cpu") == 0
    print(out.getvalue())
else:
    from genrich_tpu_torch.cli import main
    assert main(args) == 0
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}
                       & {{"jax", "genrich_tpu"}}))
print("CUDA_INITIALIZED", "torch" in sys.modules
      and sys.modules["torch"].cuda.is_initialized())
"""


@pytest.mark.parametrize("flags", [["--engine", "exact"],
                                   ["--serve", "--engine", "exact"]])
def test_unported_flags_rejected(tmp_path, sam, flags):
    """``--engine exact``, the last flag that the port once rejected as
    unported, now runs with jax and genrich_tpu refused: on the CLI
    with the default ``--device cuda`` (the host engine reads no device,
    so no card is needed) and as a serve line (OK); neither initialises
    CUDA."""
    serve = "--serve" in flags
    args = ["-t", sam, "-o", "out.np", "-y", "-p", "0.01", "-a", "5"] \
        + [f for f in flags if f != "--serve"]
    r = subprocess.run([sys.executable, "-c", _EXACT.format(
        args=args, serve=serve)], cwd=str(tmp_path), capture_output=True,
        text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "LOADED []" in r.stdout
    assert "CUDA_INITIALIZED False" in r.stdout
    if serve:
        assert [ln.split()[0] for ln in r.stdout.splitlines()[:2]] \
            == ["READY", "OK"]
    assert (tmp_path / "out.np").stat().st_size > 0


_SERVE = """
import io, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
import genrich_tpu_torch.parallel.distributed
from genrich_tpu_torch.serve import serve_loop
out = io.StringIO()
assert serve_loop(["-y", "-a", "5"], io.StringIO({lines!r}), out,
                  device="cpu") == 0
print(out.getvalue())
print("LOADED", sorted({{m.split(".")[0] for m in sys.modules}}
                       & {{"jax", "genrich_tpu"}}))
"""


def test_serve_runs_with_jax_and_genrich_tpu_refused(tmp_path, sam):
    lines = "".join(f"-t {sam} -o {e}.np --engine {e}\n"
                    for e in ("jax", "sharded"))
    r = subprocess.run([sys.executable, "-c", _SERVE.format(lines=lines)],
                       cwd=str(tmp_path), capture_output=True, text=True,
                       env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    assert "LOADED []" in r.stdout
    assert [ln.split()[0] for ln in r.stdout.splitlines()[:3]] \
        == ["READY", "OK", "OK"]
    assert (tmp_path / "jax.np").exists()
    assert (tmp_path / "sharded.np").exists()


def test_serve_cuda_without_card_fails_clearly(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: serve would start")
    r = subprocess.run([sys.executable, "-m", "genrich_tpu_torch", "--serve",
                        "--device", "cuda"], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env(),
                       input="-t x.sam -o out.np\n")
    assert r.returncode == 1 and "CUDA" in r.stderr and "Error!" in r.stderr
    assert "READY" not in r.stdout


def test_bad_device_rejected(tmp_path, sam):
    r = _port(["-t", sam, "-o", "out.np", "--device", "tpu"],
              str(tmp_path))
    assert r.returncode == 1 and "--device" in r.stderr


# refuses jax and genrich_tpu in every Python process that finds it on
# PYTHONPATH (the bench's serve, exact and perf_synth children), and
# leaves a line per process, its pid and argv, in the file GUARD_PIDS
# names
_SITECUSTOMIZE = """
import os, sys
class Refuse:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "genrich_tpu"):
            raise ImportError("refused: " + name)
        return None
sys.meta_path.insert(0, Refuse())
with open(os.environ["GUARD_PIDS"], "a") as f:
    f.write(f"{os.getpid()} {' '.join(sys.argv)}\\n")
"""

_BENCH = """
import os, sys
from genrich_tpu_torch import bench
small = (("chr1", 30_000_000), ("chr2", 20_000_000), ("chr3", 15_000_000))
work = os.path.abspath("w")
made = bench.synth({"A": (os.path.join(work, "A.bam"), 20_000, 7)}, small)
out = bench.bench_e2e({"A": made["A"][0]}, ["atac"], 1, device="cpu",
                      work=work, chroms=small, timeout=300, par_leg=False)
print("OK", out["ok"])
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "genrich_tpu"}))
sys.exit(bench.main([]))
"""


def test_bench_runs_with_jax_and_genrich_tpu_refused(tmp_path):
    """The bench's end-to-end leg (``atac`` on a 20,000-pair BAM, one
    rep, both device engines on the CPU) with both imports refused in
    the bench's own process and in every child it starts: perf_synth,
    the ``--engine exact`` run and the serve children.  Then its entry
    point without a card fails (``--device cuda``, the default) before
    it measures anything: no fall-back to the CPU."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the bench would run")
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    pids = tmp_path / "pids.txt"
    env = {**_env(), "GUARD_PIDS": str(pids),
           "PYTHONPATH": f"{site}{os.pathsep}{oracle.REPO}"}
    r = subprocess.run([sys.executable, "-c", _BENCH], cwd=str(tmp_path),
                       capture_output=True, text=True, env=env)
    assert "OK True" in r.stdout and "LOADED []" in r.stdout, r.stderr
    assert r.returncode == 1 and "no CUDA card" in r.stderr
    procs = pids.read_text().splitlines()
    for child in (".bam.tmp", "--serve", "--engine exact"):
        assert any(child in p for p in procs), (child, procs)
    assert not (tmp_path / ".bench_cache").exists()


_LADDER = """
import json, sys
from genrich_tpu_torch import bench
small = (("chr1", 30_000_000), ("chr2", 20_000_000), ("chr3", 15_000_000))
mem = bench.mem_ladder([20_000], reps=1, device="cpu", work="w",
                       chroms=small, timeout=300, out_path="mem.json")
ov = bench.overlap([20_000], work="w", chroms=small, timeout=300,
                   out_path="overlap.json")
print("OK", mem["ok"], ov["ok"])
print("LOADED", sorted({m.split(".")[0] for m in sys.modules}
                       & {"jax", "genrich_tpu"}))
"""


def test_bench_ladder_and_overlap_run_with_jax_and_genrich_tpu_refused(
        tmp_path):
    """``bench --mem`` and ``--overlap`` (one rung of 20,000 pairs on the
    CPU) with both imports refused in the bench's own process and in
    every child it starts: perf_synth, the ``--engine exact`` runs and
    the serve children of both device engines."""
    site = tmp_path / "site"
    site.mkdir()
    (site / "sitecustomize.py").write_text(_SITECUSTOMIZE)
    pids = tmp_path / "pids.txt"
    env = {**_env(), "GUARD_PIDS": str(pids),
           "PYTHONPATH": f"{site}{os.pathsep}{oracle.REPO}"}
    r = subprocess.run([sys.executable, "-c", _LADDER], cwd=str(tmp_path),
                       capture_output=True, text=True, env=env)
    assert r.returncode == 0, r.stderr[-2000:]
    assert "OK True True" in r.stdout and "LOADED []" in r.stdout
    procs = pids.read_text().splitlines()
    for child in (".bam.tmp", "--serve", "--engine exact"):
        assert any(child in p for p in procs), (child, procs)
    # the bench itself, perf_synth, two serve children, one exact run of
    # the ladder and six of the overlap legs, each one a process
    assert len(procs) >= 11, procs
