"""The port's scale ladder and ingest-overlap legs (``bench --mem`` and
``bench --overlap``) against ``scripts/bench_mem.py`` and
``scripts/bench_overlap.py``.

On the CPU at a small size: two rungs of 20,000 and 40,000 pairs of
perf_synth's seed 7 on a three-chromosome genome of 65 Mbp, three reps
of the balanced order, both device engines with ``--device cpu``; then
the overlap legs on the 20,000-pair rung.  The port's copies of the
scripts' phase timers, overlap regexes, pair rule and BAM name are held
to the scripts' own on the same stderr and legs.
"""

from __future__ import annotations

import os
import subprocess
import sys

import pytest

import conftest  # noqa: F401  (JAX on the CPU)

from genrich_tpu_torch import bench as tbench

HERE = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(HERE)
sys.path.insert(0, os.path.join(REPO, "scripts"))
import bench_e2e  # noqa: E402
import bench_mem  # noqa: E402
import bench_overlap  # noqa: E402
import perf_synth  # noqa: E402

SMALL = (("chr1", 30_000_000), ("chr2", 20_000_000), ("chr3", 15_000_000))
RUNGS = (20_000, 40_000)
CHECKS = {"exact_repeat_equal"} | {
    f"{eng}_{c}" for eng in tbench.ENGINES
    for c in ("rows", "summits", "cold_equals_warm", "no_host_peak_chroms",
              "kernels_launched")}


@pytest.fixture(scope="module")
def work(tmp_path_factory):
    return str(tmp_path_factory.mktemp("ladder"))


@pytest.fixture(scope="module")
def ladder(work):
    return tbench.mem_ladder(RUNGS, reps=3, device="cpu", work=work,
                             chroms=SMALL, timeout=300)


def _port_run(args, out, cwd, engine):
    cmd = [sys.executable, "-m", "genrich_tpu_torch"] + args + [
        "-o", out, "--engine", engine, "--device", "cpu"]
    r = subprocess.run(cmd, cwd=cwd, capture_output=True, text=True,
                       env=tbench._env())
    assert r.returncode == 0, r.stderr[-1500:]
    return open(out, "rb").read()


def test_mem_ladder_on_the_cpu(ladder, work, tmp_path):
    assert ladder["ok"], [(r["n_pairs"], r["checks"], r["faults"])
                          for r in ladder["ladder"]]
    assert ladder["flags"] == " ".join(bench_e2e.FLAGS)
    assert {"cpus", "loadavg", "ram_gb"} <= set(ladder["host"])
    assert ladder["card"] == "cpu" and "Genrich sources" in ladder["note"]
    assert [r["n_pairs"] for r in ladder["ladder"]] == list(RUNGS)
    for r in ladder["ladder"]:
        assert r["order"] == tbench.MEM_ORDER
        assert set(r["checks"]) == CHECKS and all(r["checks"].values())
        assert r["records"] > 2 * r["n_pairs"] and r["peaks"] > 0
        assert len(r["exact_rep_s"]) == 3
        assert set(r["exact_phases"]) == set(tbench.PHASE_RES)
        assert r["exact_rec_per_s"] == r["records"] / r["exact_s"]
        assert r["exact_rss_mb"] > 0
        for eng in tbench.ENGINES:
            e = r[eng]
            assert len(e["rep_s"]) == 3 and e["cold_s"] > 0
            assert len(e["ratio_reps"]) == 3 and e["speedup"] > 0
            assert e["rss_mb"] > 0
            assert e["max_memory_allocated"] is None
            assert e["rows"]["match_frac"] >= 0.99
            # four lines, none sent a chromosome to the host, no kernel
            # launched on the CPU
            assert e["host_peak_chroms"] == [0] * 4
            assert e["launches_by_card"] == [{}] * 4
        # the bench's files are the CLI's bytes: exact, and each device
        # engine on the CPU
        run = os.path.join(work, "bench_mem", str(r["n_pairs"]))
        args = ["-t", tbench.ladder_bam(r["n_pairs"], work, SMALL)] \
            + tbench.E2E_FLAGS
        for eng, tag in (("exact", "exact_2"), ("jax", "jax_w2"),
                         ("sharded", "sharded_w2")):
            want = open(os.path.join(run, f"{tag}.np"), "rb").read()
            assert _port_run(args, str(tmp_path / f"{eng}.np"),
                             str(tmp_path), eng) == want, eng


def test_mem_exact_bytes_are_the_jax_package_s(ladder, work, tmp_path):
    """The 20,000-pair rung's exact output against ``python -m genrich_tpu
    --engine exact`` (a child process) on the same BAM and flags."""
    bam = tbench.ladder_bam(RUNGS[0], work, SMALL)
    out = str(tmp_path / "jax_exact.np")
    r = subprocess.run([sys.executable, "-m", "genrich_tpu", "-t", bam,
                        "-o", out, "--engine", "exact"] + bench_e2e.FLAGS,
                       cwd=str(tmp_path), capture_output=True, text=True,
                       env=bench_e2e._env({"JAX_PLATFORMS": "cpu"}))
    assert r.returncode == 0, r.stderr[-1500:]
    got = os.path.join(work, "bench_mem", str(RUNGS[0]), "exact_0.np")
    assert open(out, "rb").read() == open(got, "rb").read()


def test_phase_timers_are_the_scripts(ladder, work):
    """The port's exact stderr under the two profiling variables prints
    every timer of ``bench_mem.PHASE_RES``; the port's parser and the
    overlap regexes read it as the scripts' do."""
    bam = tbench.ladder_bam(RUNGS[1], work, SMALL)
    run = os.path.join(work, "bench_mem", "timers")
    os.makedirs(run, exist_ok=True)
    _, err, _ = tbench._exact(["-t", bam] + tbench.E2E_FLAGS,
                              os.path.join(run, "out.np"), run, 300,
                              tbench.PROF_ENV)
    assert {k: r.pattern for k, r in tbench.PHASE_RES.items()} \
        == {k: r.pattern for k, r in bench_mem.PHASE_RES.items()}
    want = bench_mem._phases(err)
    assert set(want) == set(bench_mem.PHASE_RES)
    assert tbench._phases(err) == want
    for mine, theirs in ((tbench.RECORDS_RE, bench_overlap.RECORDS_RE),
                         (tbench.DEDUP_RE, bench_overlap.DEDUP_RE)):
        assert mine.pattern == theirs.pattern
        assert mine.findall(err) == theirs.findall(err) != []


def _bench_mem_pairs(legs, eng):
    """``scripts/bench_mem.py``'s pairing loop (ref -> exact, exact ->
    the engine) over the legs of the exact side and ``eng``."""
    pairs, cur = [], {}
    for who, t in legs:
        if who not in ("exact", eng):
            continue
        cur["ref" if who == "exact" else "exact"] = t
        if len(cur) == 2:
            pairs.append(cur["ref"] / cur["exact"])
            cur = {}
    return pairs


@pytest.mark.parametrize("reps", [1, 2, 3, 4])
def test_paired_ratios_are_bench_mem_s(reps):
    order = tbench.mem_order(reps)
    assert len(order) == 3 * reps
    assert all(order.count(c) == reps for c in ("exact", "jax", "sharded"))
    if reps == 3:       # A-B-C, C-B-A, A-B-C: bench_mem.py's balance
        assert order == tbench.MEM_ORDER
        assert order[3:6] == order[2::-1] and order[6:] == order[:3]
    legs = [(who, 1.0 + i) for i, who in enumerate(order)]
    got = tbench.paired_ratios(legs)
    for eng in ("jax", "sharded"):
        assert got[eng] == _bench_mem_pairs(legs, eng)
        assert len(got[eng]) == reps


def test_ladder_bam_name_is_bench_e2e_s(monkeypatch, tmp_path):
    made = []
    monkeypatch.setenv("GENRICH_PERF_DIR", str(tmp_path))
    monkeypatch.setattr(perf_synth, "synth_bam",
                        lambda path, n, chroms=None: made.append(path))
    for chroms in (None, SMALL):
        want = bench_e2e._bam_path(10_000_000, chroms)
        got = tbench.ladder_bam(10_000_000, str(tmp_path),
                                tbench.HG_CHROMS if chroms is None
                                else chroms)
        assert got == want == made[-1]
    assert os.path.basename(tbench.ladder_bam(2_000_000)) \
        == os.path.basename(tbench.bam_path("A"))


def test_overlap_on_the_cpu(ladder, work):
    out = tbench.overlap(RUNGS[:1], work=work, chroms=SMALL, timeout=300)
    assert out["ok"] and out["flags"] == " ".join(bench_e2e.FLAGS)
    r, = out["rungs"]
    assert r["order"] == ["seq", "par2", "par2", "seq", "default",
                          "default", "frame_only"]
    assert r["checks"] == {"seq_repeat_equal": True, "par2_equals_seq": True,
                           "default_equals_seq": True}
    assert r["cpus"] == os.cpu_count()
    assert r["default_workers"] == tbench.default_workers(os.cpu_count())
    for leg, n in (("seq", 2), ("par2", 2), ("default", 2),
                   ("frame_only", 1)):
        assert len(r[leg]["wall_rep_s"]) == n
        assert r[leg]["records_s"] >= 0, leg
    s, p, d = r["seq"]["wall_s"], r["par2"]["wall_s"], r["default"]["wall_s"]
    assert r["par2_gain_pct"] == pytest.approx(100 * (s - p) / s)
    assert r["default_gain_pct"] == pytest.approx(100 * (s - d) / s)
    assert r["records_minus_frame_s"] == pytest.approx(
        r["seq"]["records_s"] - r["frame_only"]["records_s"])
    # seq, par2 and default wrote the same bytes as the exact rung
    seq0 = os.path.join(work, "bench_overlap", str(RUNGS[0]), "seq_a_0.np")
    mem0 = os.path.join(work, "bench_mem", str(RUNGS[0]), "exact_0.np")
    assert open(seq0, "rb").read() == open(mem0, "rb").read()


@pytest.mark.parametrize("cpus,workers", [(1, 0), (2, 0), (3, 0), (4, 2),
                                          (8, 6), (32, 16)])
def test_default_workers_is_ingest_cpp_s(cpus, workers):
    """``native/ingest.cpp::parse_threads`` with GENRICH_INGEST_THREADS
    unset: cores - 2 capped at 16 on 4 cores or more, else sequential."""
    src = open(os.path.join(REPO, "native", "ingest.cpp")).read()
    assert "if (hw < 4) return 0;" in src and "w < 16 ? w : 16" in src
    assert tbench.default_workers(cpus) == workers


def _stat_log(path, stats):
    with open(path, "w") as f:
        f.write("chr\tstart\tend\ttreatment\tcontrol\t-log(p)\t-log(q)\n")
        for i, q in enumerate(stats):
            f.write(f"chr1\t{100 * i}\t{100 * (i + 1)}\t1\t1\t1\t{q}\n")


@pytest.mark.parametrize("third,tie", [(5.0, True), (4.0, False)])
def test_summit_check_reads_the_log_only_when_a_summit_differs(
        tmp_path, third, tie):
    """A peak over [100, 300) whose summit the port puts in another
    interval: a near tie when that interval's stat equals the exact
    summit's (the log is written once, on demand), a fault otherwise;
    equal summits never ask for the log."""
    row = "chr1\t100\t300\tpeak_0\t0\t.\t50.0\t5.0\t5.0\t{}"
    exact, port = tmp_path / "exact.np", tmp_path / "port.np"
    exact.write_text(row.format(10) + "\n")
    port.write_text(row.format(150) + "\n")
    log = str(tmp_path / "exact.log")
    asked = []

    def make_log():
        asked.append(1)
        _stat_log(log, [2.0, 5.0, third])
        return log
    assert tbench.summit_check(str(exact), str(exact), make_log) \
        == {"compared": 1, "differ_near_ties": 0} and not asked
    if tie:
        assert tbench.summit_check(str(exact), str(port), make_log) \
            == {"compared": 1, "differ_near_ties": 1}
    else:
        with pytest.raises(AssertionError, match="no near tie"):
            tbench.summit_check(str(exact), str(port), make_log)
    assert asked == [1]


def test_child_rss_is_its_own(tmp_path):
    """A child's peak RSS is its own, sampled from /proc/<pid>/statm by
    the parent.  wait4's ru_maxrss also counts the high-water mark of
    the process it was forked from: on the H100 host every exact leg of
    the first ladder run read 4,645.9 MB at 2M and 10M pairs alike, the
    bench process's own size."""
    import numpy as np
    big = np.ones(600 * 2**20 // 8)          # 600 MB touched here
    (tmp_path / "x.json").write_text("[1]")
    _, rc, _, rss = tbench._run_rss(
        [sys.executable, "-m", "json.tool", "x.json"], str(tmp_path), 60)
    assert rc == 0 and 0 < rss < 200, rss
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    _, _, ru = os.wait4(p.pid, 0)
    assert ru.ru_maxrss / 1024 >= 600 > rss  # the fault the sampler avoids
    client = tbench.ServeClient(str(tmp_path), "cpu",
                                str(tmp_path / "serve.log"))
    served = client.close()
    assert 0 < served < 600
    assert client.proc.returncode == 0
    del big


@pytest.mark.parametrize("mb", [0, 150, 300])
def test_rss_sampler_reads_the_childs_peak(tmp_path, mb):
    """The sampled peak holds what the child touched and held for a
    while, and little more than its interpreter."""
    code = ("import time, numpy as np; "
            f"a = np.ones({mb} * 2**20 // 8); time.sleep(0.3); del a")
    _, rc, _, rss = tbench._run_rss([sys.executable, "-c", code],
                                    str(tmp_path), 60)
    assert rc == 0 and mb < rss < mb + 150, rss
