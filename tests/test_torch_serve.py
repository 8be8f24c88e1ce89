"""``python -m genrich_tpu_torch --serve --device cpu``: the serve loop.

The five cases of test_serve.py on the port's server: READY, one
analysis per stdin line, OK/ERR status lines, warm repeats
byte-identical to cold per engine kind (``--engine jax``, the default,
and ``--engine sharded``), an ``--engine exact`` line answering OK with
the bytes of a fresh-process port run and of the JAX package's serve
(the JSON: the stage walls only), a bad line not poisoning later lines,
the -X/-P checkpoint resume, unexpected errors survived, the OK line's
JSON, and re-preparing on inputs of other sizes; then the serve outputs
against the JAX package's fresh-process ``--engine jax`` / ``--engine
sharded`` runs (narrowPeak columns 1-6 identical, columns 7-9 within
1e-5 relative) and column 10 equal to the port's exact engine's.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest

import conftest  # noqa: F401
import oracle

from genrich_tpu_torch.testing import check_summits

BASE = "-t in.sam -y -p 0.01 -a 20"


def _env():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = oracle.REPO
    return env


def _serve(tmp_path, lines, timeout=300):
    r = subprocess.run(
        [sys.executable, "-m", "genrich_tpu_torch", "--serve", "--device",
         "cpu"], input="\n".join(lines) + "\nEXIT\n", capture_output=True,
        text=True, cwd=str(tmp_path), env=_env(), timeout=timeout)
    assert r.returncode == 0, r.stderr[-1500:]
    return r.stdout.splitlines()


def _fresh_port(tmp_path, args, out):
    r = subprocess.run([sys.executable, "-m", "genrich_tpu_torch"] + args
                       + ["-o", out, "--device", "cpu"], cwd=str(tmp_path),
                       capture_output=True, text=True, env=_env())
    assert r.returncode == 0, r.stderr[-1500:]
    return (tmp_path / out).read_bytes()


def test_serve_warm_runs_identical(tmp_path):
    oracle.random_sam(str(tmp_path / "in.sam"), seed=11)
    out = _serve(tmp_path, [
        f"{BASE} -o dflt0.np",
        f"{BASE} -o jax0.np --engine jax",
        f"{BASE} -o jax1.np --engine jax",
        f"{BASE} -o sh0.np --engine sharded",
        f"{BASE} -o sh1.np --engine sharded",
        "bogus --flags",
        f"{BASE} -o exact.np --engine exact",
        f"{BASE} -o dflt1.np",
    ])
    assert out[0] == "READY"
    assert [ln.split()[0] for ln in out[1:]] \
        == ["OK"] * 5 + ["ERR", "OK", "OK"]
    read = {n: (tmp_path / f"{n}.np").read_bytes()
            for n in ("dflt0", "jax0", "jax1", "sh0", "sh1", "dflt1",
                      "exact")}
    assert read["jax0"] and read["sh0"] and read["exact"]
    # warm == cold per engine kind; no --engine is TorchEngine
    assert read["jax0"] == read["jax1"] == read["dflt0"] == read["dflt1"]
    assert read["sh0"] == read["sh1"]
    # serve output == a fresh process of the port
    assert _fresh_port(tmp_path, BASE.split(), "fresh.np") == read["jax0"]
    assert _fresh_port(tmp_path, BASE.split() + ["--engine", "sharded"],
                       "fresh_sh.np") == read["sh0"]
    assert _fresh_port(tmp_path, BASE.split() + ["--engine", "exact"],
                       "fresh_exact.np") == read["exact"]
    # the exact line: the JAX package's serve writes the same bytes, and
    # the OK line carries the stage walls, no device accounting
    r = subprocess.run(
        [sys.executable, "-m", "genrich_tpu", "--serve"],
        input=f"{BASE} -o jax_exact.np --engine exact\nEXIT\n",
        capture_output=True, text=True, cwd=str(tmp_path),
        env={**_env(), "JAX_PLATFORMS": "cpu"}, timeout=300)
    assert r.returncode == 0 and r.stdout.split()[:2] == ["READY", "OK"], \
        r.stderr[-1500:]
    assert (tmp_path / "jax_exact.np").read_bytes() == read["exact"]
    perf = json.loads(out[7].split(None, 2)[2])
    assert {"ingest_s", "findpeaks_s"} <= set(perf)
    assert not {"device_rep_s", "upload_bytes", "dispatch_n"} & set(perf)


def test_serve_checkpoint_resume(tmp_path):
    """-X writes the -f log in one analysis, -P reads it in the next, in
    one server; the result equals a fresh-process -P run's bytes."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=17)
    out = _serve(tmp_path, [
        "-t in.sam -o x.np -y -X -f stats.log",
        "-P -f stats.log -o resumed.np -p 0.01 -a 20",
    ])
    assert [ln.split()[0] for ln in out] == ["READY", "OK", "OK"]
    fresh = _fresh_port(tmp_path, ["-P", "-f", "stats.log", "-p", "0.01",
                                   "-a", "20"], "fresh.np")
    assert fresh and fresh == (tmp_path / "resumed.np").read_bytes()


def test_serve_survives_unexpected_errors(tmp_path):
    """A non-Genrich exception (an unwritable output path) must not kill
    the server; later analyses still succeed, on both engines."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=19)
    out = _serve(tmp_path, [
        "-t in.sam -o /nonexistent_dir/x.np -y --engine sharded",
        "-t in.sam -o ok.np -y -p 0.01 -a 20 --engine sharded",
        "-t in.sam -o /nonexistent_dir/y.np -y",
        "-t in.sam -o ok2.np -y -p 0.01 -a 20",
    ])
    assert [ln.split()[0] for ln in out] == ["READY", "ERR", "OK", "ERR",
                                             "OK"]
    assert (tmp_path / "ok.np").stat().st_size > 0
    assert (tmp_path / "ok2.np").stat().st_size > 0


def test_serve_ok_line_carries_decomposition(tmp_path):
    """OK lines embed the analysis's stage walls and the engine's
    upload/dispatch/fetch accounting as JSON (split on the first two
    fields); the sharded engine adds its grid."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=13)
    out = _serve(tmp_path, [f"{BASE} -o jax.np --engine jax",
                            f"{BASE} -o sh.np --engine sharded"])
    oks = [ln for ln in out if ln.startswith("OK")]
    assert len(oks) == 2
    perfs = []
    for ln in oks:
        parts = ln.split(None, 2)
        assert len(parts) == 3, ln
        perf = json.loads(parts[2])
        for key in ("ingest_s", "device_rep_s", "findpeaks_s",
                    "upload_bytes", "dispatch_n", "fetch_s"):
            assert key in perf, perf
        assert perf["upload_bytes"] > 0 and perf["dispatch_n"] > 0
        perfs.append(perf)
    assert perfs[1]["grid_tiles"] >= 1 and perfs[1]["grid_tile_len"] > 0
    assert "grid_tiles" not in perfs[0]


@pytest.mark.parametrize("engine", ["jax", "sharded"])
def test_serve_heterogeneous_inputs_reprepare(tmp_path, engine):
    """Inputs of other sizes through one server re-derive the engine's
    shape policy (the sharded grid) per analysis: the larger input after
    the smaller one equals a fresh process's bytes."""
    oracle.random_sam(str(tmp_path / "small.sam"), seed=21, n_pairs=80,
                      chroms=(("chr1", 60000),))
    oracle.random_sam(str(tmp_path / "big.sam"), seed=22, n_pairs=900,
                      chroms=(("chr1", 300000), ("chr2", 90000)))
    out = _serve(tmp_path, [
        f"-t small.sam -y -p 0.01 -a 20 -o s.np --engine {engine}",
        f"-t big.sam -y -p 0.01 -a 20 -o b.np --engine {engine}",
    ])
    assert sum(1 for ln in out if ln.startswith("OK")) == 2, out
    grids = [json.loads(ln.split(None, 2)[2]).get("grid_tile_len")
             for ln in out if ln.startswith("OK")]
    if engine == "sharded":
        assert grids[0] < grids[1], grids
    assert _fresh_port(tmp_path, ["-t", "big.sam", "-y", "-p", "0.01", "-a",
                                  "20", "--engine", engine], "fresh.np") \
        == (tmp_path / "b.np").read_bytes()


def test_serve_matches_jax_package_fresh_runs(tmp_path):
    """Each engine kind of the port's server against the JAX package's
    fresh-process run of the same engine: columns 1-6 identical, 7-9
    within 1e-5 relative; column 10 against the server's own ``--engine
    exact`` line (``testing.check_summits`` with its -f log: equal, no
    near tie)."""
    oracle.random_sam(str(tmp_path / "in.sam"), seed=75, n_pairs=600)
    out = _serve(tmp_path, [f"{BASE} -q 0.5 -o t_{e}.np --engine {e}"
                            for e in ("jax", "sharded")]
                 + [f"{BASE} -q 0.5 -o t_exact.np -f t_exact.log "
                    f"--engine exact"])
    assert [ln.split()[0] for ln in out] == ["READY", "OK", "OK", "OK"]
    exact = (tmp_path / "t_exact.np").read_text().splitlines()
    for e in ("jax", "sharded"):
        r = oracle.run_ours(BASE.split() + ["-q", "0.5", "-o", f"j_{e}.np",
                                            "--engine", e],
                            cwd=str(tmp_path))
        assert r.returncode == 0, r.stderr[-1500:]
        want = (tmp_path / f"j_{e}.np").read_text().splitlines()
        got = (tmp_path / f"t_{e}.np").read_text().splitlines()
        assert want and len(want) == len(got)
        for a, b in zip(want, got):
            fa, fb = a.split("\t"), b.split("\t")
            assert fa[:6] == fb[:6], (e, a, b)
            for i in (6, 7, 8):
                x, y = float(fa[i]), float(fb[i])
                assert abs(x - y) <= 1e-5 * max(1.0, abs(x)), (e, a, b)
        assert check_summits(exact, got, tmp_path / "t_exact.log",
                             1e-5) == (len(exact), 0)
        assert len(exact) == len(got)
