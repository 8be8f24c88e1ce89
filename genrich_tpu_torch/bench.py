"""Benchmark of the port on one card: end-to-end legs.

    python -m genrich_tpu_torch.bench [--device cuda|cpu]
        [--configs atac,control,fisher,chip,chip_fisher] [--reps N]
        [--out PATH]
    python -m genrich_tpu_torch.bench --mem [N ...] [--device cuda|cpu]
        [--reps N] [--out PATH]
    python -m genrich_tpu_torch.bench --overlap [N ...] [--out PATH]

The port's counterpart of the repo's ``scripts/bench_e2e.py``,
``scripts/bench_mem.py`` and ``scripts/bench_overlap.py``, which drive
the JAX package.  It imports neither ``jax`` nor ``genrich_tpu`` and
keeps its own copies of what it takes from them.  It runs on the card
unless ``--device cpu`` is given; without a card it fails.  Its device
legs run the port's one device pipeline, the engine path of the CLI and
``--serve`` (``TorchEngine``, ``ShardedTorchEngine``).

End-to-end legs (``bench_e2e``): the 2M-pair BAMs that ``chip_smoke.py``
caches in ``.bench_cache/`` (``BAMS``; made by ``tools/perf_synth.py``,
the port's copy of ``scripts/perf_synth.py``, in child processes when
missing), five configurations (``CONFIGS``), each on ``--engine exact -v`` in a child process and on ``--engine
jax`` and ``--engine sharded`` through one ``--serve`` child each (no
process group: the sharded one spans every card the child sees).  A cold
line per device engine, then ``reps`` paired reps: the exact run, then
one serve line of each device engine.  Each device output must pass
``_verify_rows`` against the exact engine's and equal its cold output
byte for byte; a failed check fails the bench.  The compiled-reference
leg of ``scripts/bench_e2e.py`` is left out (it needs the Genrich
sources), so the headline's ``e2e_exact_ratio`` is the paired exact /
``--engine jax`` wall ratio on ``atac``.

The full dict goes to ``.bench_cache/bench_torch_detail.json`` (or
``--out``); the last stdout line is ``compact_headline``, with the
end-to-end keys of ``bench.py``'s headline and the card's name and
power limit.

The scale ladder (``--mem``, alone), the counterpart of
``scripts/bench_mem.py``: rungs of 2M, 10M, 40M and 60M read pairs
(perf_synth's seed 7 on ``HG_CHROMS``, cached under ``bench_e2e``'s
names; every missing BAM made at once first, read once for the page
cache), ``-r -j -q 0.05 -a 20``.  A rung starts a fresh serve child per
device engine (its first line the cold run), then runs ``MEM_ORDER``,
the script's balanced order over three contenders (exact, jax, sharded,
sharded, jax, exact, exact, jax, sharded; ``--reps`` r takes 3r legs),
the exact legs ``--engine exact -v`` children under
``GENRICH_NATIVE_PROF=1 GENRICH_TPU_PROFILE=1`` (the script's phase
split, ``PHASE_RES``); every child's own peak RSS (``RssSampler``).
Each engine's ratios come from its temporally adjacent (exact, engine)
pairs, as the script pairs its legs.  Checks: the exact reps
byte-identical; every device engine's rows against the exact output,
its summits, cold == warm bytes, no host peak call, K1, K2, K5 and K4
launched on every card in every line
(``launches_by_card`` of the serve line).  The script's compiled-
reference legs are left out (they need the Genrich sources).  The
detail goes to ``.bench_cache/bench_torch_mem.json`` (or ``--out``)
after every rung; the last line is ``compact_ladder``'s.

The ingest-overlap legs (``--overlap``, alone), the counterpart of
``scripts/bench_overlap.py``, on the port's exact engine at 10M and
40M pairs: seq (``GENRICH_INGEST_THREADS=0``), par2 (``=2``), par2,
seq, then the default (the variable unset: ``default_workers`` on this
host) twice and ``frame_only`` (``GENRICH_ABLATE=frame``); the detail
goes to ``.bench_cache/bench_torch_overlap.json`` (or ``--out``) and is
the last line.  A failed check of either fails the bench (exit code 1).
"""

from __future__ import annotations

import argparse
import json
import os
import re
import resource
import shlex
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

from . import testing

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORK = os.path.join(REPO, ".bench_cache")
DETAIL = os.path.join(WORK, "bench_torch_detail.json")

# scripts/bench_e2e.py's genome and flags, chip_smoke.py's BAMs
HG_CHROMS = (("chr1", 1_100_000_000), ("chr2", 900_000_000),
             ("chr3", 750_000_000))
E2E_FLAGS = ["-r", "-j", "-q", "0.05", "-a", "20"]
CHIP_FLAGS = ["-r", "-p", "0.01", "-a", "20"]     # + -E blk.bed -e chr3
BAMS = {"A": (2_000_000, 7), "B": (2_000_000, 8), "C": (1_000_000, 9)}
# name -> (treatment BAMs, control BAMs, ChIP flags): Genrich's ATAC use
# alone, against a control and on two replicates, then its ChIP use
CONFIGS = {"atac": ("A", "", False), "control": ("A", "B", False),
           "fisher": ("A,B", "", False), "chip": ("A", "B", True),
           "chip_fisher": ("A,B", "C,C", True)}
Q_THRESH = 1.3010299956639813       # -log10(0.05): -q 0.05
P_THRESH = 2.0                      # -log10(0.01): -p 0.01
ENGINES = ("jax", "sharded")
DIST_ENV = ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE")


# --- end-to-end legs ------------------------------------------------------

def _median(xs):
    s = sorted(xs)
    return s[len(s) // 2]


def _spread_pct(xs):
    """(max - min) / median, in percent."""
    return 100.0 * (max(xs) - min(xs)) / _median(xs)


def bam_path(key, work=WORK):
    """``chip_smoke.py``'s cache name of BAM ``key`` of ``BAMS``."""
    n, seed = BAMS[key]
    tag = "" if seed == 7 else f"_seed{seed}"
    return os.path.join(work, f"atac_e2e_hg_{n}{tag}.bam")


# tools/perf_synth.py in a child process: argv is the repo root, the
# output path, the pairs, the seed and the chromosomes as JSON
_SYNTH = ("import json, sys; sys.path.insert(0, sys.argv[1]); "
          "from genrich_tpu_torch.tools import perf_synth; "
          "perf_synth.synth_bam(sys.argv[2], int(sys.argv[3]), "
          "seed=int(sys.argv[4]), "
          "chroms=[tuple(c) for c in json.loads(sys.argv[5])])")


def synth(jobs, chroms=HG_CHROMS):
    """Each missing BAM of ``jobs`` ({key: (path, pairs, seed)}) made by
    ``tools/perf_synth.py`` in a child process, all at once; returns
    {key: (path, seconds or None when it was there)}."""
    procs, made = {}, {}
    t0 = time.perf_counter()
    for key, (path, n, seed) in jobs.items():
        made[key] = (path, None)
        if not os.path.exists(path):
            os.makedirs(os.path.dirname(os.path.abspath(path)),
                        exist_ok=True)
            procs[key] = subprocess.Popen(
                [sys.executable, "-c", _SYNTH, REPO, path + ".tmp",
                 str(n), str(seed), json.dumps(chroms)],
                stdout=subprocess.DEVNULL)
    try:
        for key, proc in procs.items():
            if proc.wait() != 0:
                raise RuntimeError(f"perf_synth of BAM {key}: exit code "
                                   f"{proc.returncode}")
            path = jobs[key][0]
            os.replace(path + ".tmp", path)
            made[key] = (path, time.perf_counter() - t0)
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return made


def make_bams(keys, work=WORK, chroms=HG_CHROMS):
    """The BAMs of ``keys`` in ``work`` (``synth``).  Returns {key:
    path}."""
    made = synth({key: (bam_path(key, work), *BAMS[key]) for key in keys},
                 chroms)
    return {key: path for key, (path, _) in made.items()}


def _env(extra=None, drop=()):
    env = {k: v for k, v in os.environ.items()
           if k not in DIST_ENV and k not in drop}
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env.update(extra or {})
    return env


class RssSampler:
    """The peak resident size of process ``pid``, read from
    /proc/<pid>/statm every 20 ms by a thread of this process until
    ``stop``.  wait4's ru_maxrss of a child also counts the high-water
    mark of the parent it was forked from (on the H100 host every exact
    child read the bench process's 4.6 GB), and the H100 host's /proc
    gives no VmHWM, so the child's resident size is sampled."""

    PAGE = os.sysconf("SC_PAGE_SIZE")

    def __init__(self, pid, period=0.02):
        self.path = f"/proc/{pid}/statm"
        self.peak = 0
        self._done = threading.Event()
        self._thread = threading.Thread(target=self._run, args=(period,),
                                        daemon=True)
        self._thread.start()

    def _read(self):
        try:
            with open(self.path) as f:
                return int(f.read().split()[1]) * self.PAGE
        except (OSError, ValueError, IndexError):
            return 0

    def _run(self, period):
        while not self._done.is_set():
            self.peak = max(self.peak, self._read())
            self._done.wait(period)

    def stop(self):
        """Ends the sampling; the peak in MB, None when no read saw the
        process."""
        self._done.set()
        self._thread.join()
        return self.peak / 2**20 or None


def _run_rss(cmd, cwd, timeout, extra_env=None, drop=()):
    """One run: (wall_s, rc, stderr_text, peak_rss_mb); the variables of
    ``drop`` unset in its environment.  The RSS is the child's own
    (``RssSampler``).

    Reads stderr to EOF itself and reaps the child; a watchdog kills on
    timeout."""
    proc = subprocess.Popen(cmd, cwd=cwd, stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE, text=True,
                            env=_env(extra_env, drop))
    t0 = time.perf_counter()
    rss = RssSampler(proc.pid)
    timed_out = []
    watchdog = threading.Timer(timeout, lambda: (timed_out.append(1),
                                                 proc.kill()))
    watchdog.start()
    try:
        err = proc.stderr.read()
    finally:
        watchdog.cancel()
        peak = rss.stop()
    proc.wait()
    if timed_out:
        return time.perf_counter() - t0, None, "timeout", None
    return time.perf_counter() - t0, proc.returncode, err, peak


class ServeClient:
    """Drives one ``python -m genrich_tpu_torch --serve --device D``
    child: one analysis per line; its stderr goes to ``log``."""

    def __init__(self, cwd, device, log, extra_env=None,
                 ready_timeout=600.0):
        self.log = log
        t0 = time.perf_counter()
        with open(log, "w") as err:
            self.proc = subprocess.Popen(
                [sys.executable, "-m", "genrich_tpu_torch", "--serve",
                 "--device", device], cwd=cwd, stdin=subprocess.PIPE,
                stdout=subprocess.PIPE, stderr=err, text=True,
                env=_env(extra_env))
        self.rss = RssSampler(self.proc.pid)
        line = self._read_line(ready_timeout)
        if line != "READY":
            raise RuntimeError(f"serve: {line!r}, not READY: "
                               f"{self._tail()}")
        self.ready_s = time.perf_counter() - t0

    def _tail(self):
        with open(self.log) as f:
            return f.read()[-2000:]

    def _read_line(self, timeout):
        import select
        r, _, _ = select.select([self.proc.stdout], [], [], timeout)
        if not r:
            raise TimeoutError("serve: no response")
        return self.proc.stdout.readline().strip()

    def analyze(self, args, timeout):
        """-> (wall_s, perf dict of the ``OK <wall> <json>`` line)."""
        t0 = time.perf_counter()
        self.proc.stdin.write(shlex.join(args) + "\n")
        self.proc.stdin.flush()
        line = self._read_line(timeout)
        if not line.startswith("OK"):
            raise RuntimeError(f"serve: {line!r} for {args}: {self._tail()}")
        parts = line.split(None, 2)
        perf = json.loads(parts[2]) if len(parts) > 2 else {}
        return time.perf_counter() - t0, perf

    def close(self, timeout=60.0):
        """Ends the child (killed when it has not exited ``timeout``
        seconds after EXIT); returns its peak RSS in MB over its life
        (``RssSampler``)."""
        try:
            self.proc.stdin.write("EXIT\n")
            self.proc.stdin.close()
        except OSError:
            pass
        peak = self.rss.stop()
        try:
            self.proc.wait(timeout=timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            self.proc.wait()
        return peak


def _verify_rows(ref_path, out_path, thresh):
    """Row-level device-vs-reference check (threshold-aware), as
    ``scripts/bench_e2e.py`` makes it: matched rows share (chrom, start,
    end); an unmatched row must overlap a peak of the other side or be
    threshold-marginal (its column 9 near ``thresh``).  Records the
    fraction matched and the worst margin of any non-overlapping
    unmatched row (0.0 = none)."""
    ref = open(ref_path).read().splitlines()
    out = open(out_path).read().splitlines()
    key = lambda ln: tuple(ln.split("\t")[:3])  # noqa: E731
    rk = {key(ln): ln for ln in ref}
    ok_ = {key(ln): ln for ln in out}

    def spans(lines):
        return [(f[0], int(f[1]), int(f[2]))
                for f in (ln.split("\t") for ln in lines)]

    def worst_margin(only_keys, src, other_spans):
        worst = 0.0
        for k in only_keys:
            f = src[k].split("\t")
            chrom, s, e, q = f[0], int(f[1]), int(f[2]), float(f[8])
            if any(c == chrom and s < oe and os_ < e
                   for c, os_, oe in other_spans):
                continue
            worst = max(worst, abs(q - thresh))
        return worst

    worst = max(worst_margin(rk.keys() - ok_.keys(), rk, spans(out)),
                worst_margin(ok_.keys() - rk.keys(), ok_, spans(ref)))
    inter = rk.keys() & ok_.keys()
    return {"rows_ref": len(ref), "rows_out": len(out),
            "match_frac": round(len(inter) / max(len(ref), 1), 4),
            "worst_unmatched_margin": round(worst, 4)}


def write_blacklist(path, exact_np, chroms=HG_CHROMS):
    """The ChIP blacklist of ``chip_smoke.py``: ``testing.blacklist_regions``
    from seed 10 on the first two chromosomes (1,000 regions of 1-50 kb
    per 2 Gbp of them), one region from the midpoint of each one's
    strongest peak of the ATAC exact file ``exact_np`` on.  Returns
    the cuts."""
    rows = [ln.split("\t") for ln in open(exact_np).read().splitlines()]
    cut = []
    for name, _ in chroms[:2]:
        mine = [r for r in rows if r[0] == name]
        if mine:
            top = max(mine, key=lambda r: float(r[6]))
            cut.append((name, (int(top[1]) + int(top[2])) // 2))
    n = round(1000 * sum(size for _, size in chroms[:2]) / 2e9)
    regions = testing.blacklist_regions(np.random.RandomState(10),
                                        chroms[:2], n, (1_000, 50_000),
                                        1 << 28, cut=cut)
    testing.write_bed(path, regions)
    return cut


def _stat(xs):
    """Median, each value in order and the spread of a leg's seconds."""
    return {"median_s": _median(xs), "rep_s": xs,
            "spread_pct": _spread_pct(xs)}


def _records(stderr):
    """BAM/SAM records analyzed, summed over the -v stderr's samples."""
    return sum(int(ln.split()[-1]) for ln in stderr.splitlines()
               if "records analyzed" in ln)


def _config_args(name, bams, run_dir):
    """(argv without -o, significance threshold) of configuration
    ``name`` (``CONFIGS``)."""
    t, c, chip = CONFIGS[name]
    args = ["-t", ",".join(bams[k] for k in t.split(","))]
    if c:
        args += ["-c", ",".join(bams[k] for k in c.split(","))]
    if not chip:
        return args + E2E_FLAGS, Q_THRESH
    return args + CHIP_FLAGS + ["-E", os.path.join(run_dir, "blk.bed"),
                                "-e", "chr3"], P_THRESH


def _exact(args, out, run_dir, timeout, extra_env=None):
    """One ``--engine exact -v`` child: (wall, stderr, peak RSS MB)."""
    cmd = [sys.executable, "-m", "genrich_tpu_torch"] + args + [
        "-o", out, "--engine", "exact", "-v"]
    wall, rc, err, rss = _run_rss(cmd, run_dir, timeout, extra_env)
    if rc != 0:
        raise RuntimeError(f"exact engine exit code {rc}: {err[-1500:]}")
    return wall, err, rss


def _same_bytes(paths):
    data = [open(p, "rb").read() for p in paths]
    return all(d == data[0] for d in data)


def e2e_config(name, bams, clients, reps, run_dir, timeout, par_leg):
    """Configuration ``name``: a cold serve line per device engine, then
    ``reps`` paired reps (the exact child, then one serve line of each
    engine), then on request the two-worker parser leg; with every
    check's result under ``checks`` (``ok`` False when one failed)."""
    args, thresh = _config_args(name, bams, run_dir)

    def out(tag):
        return os.path.join(run_dir, f"{name}_{tag}.np")
    res = {"args": shlex.join(args), "thresh": thresh}
    cold = {}
    for eng, client in clients.items():
        cold[eng] = client.analyze(args + ["-o", out(f"{eng}_cold"),
                                           "--engine", eng], timeout)
    ex_t, ex_rss, warm = [], [], {eng: [] for eng in clients}
    err = ""
    for i in range(reps):
        t, err, rss = _exact(args, out(f"exact_{i}"), run_dir, timeout)
        ex_t.append(t)
        ex_rss.append(rss)
        for eng, client in clients.items():
            warm[eng].append(client.analyze(
                args + ["-o", out(f"{eng}_w{i}"), "--engine", eng], timeout))
    res["exact"] = dict(_stat(ex_t), rss_mb=_peak(ex_rss))
    res["records"] = _records(err)
    res["exact_records_per_s"] = res["records"] / res["exact"]["median_s"]
    res["peaks"] = sum(1 for _ in open(out("exact_0")))
    checks = {"exact_repeat_equal": _same_bytes(
        [out(f"exact_{i}") for i in range(reps)])}
    res["paired"] = {}
    for eng in clients:
        walls = [w for w, _ in warm[eng]]
        perfs = [p for _, p in warm[eng]]
        stages = {k: [p.get(k) for p in perfs]
                  for k in ("ingest_s", "device_rep_s", "findpeaks_s")}
        mem = [p.get("max_memory_allocated_by_card")
               for p in [cold[eng][1]] + perfs]
        mem = [max(card) for card in zip(*(m for m in mem if m))]
        res[eng] = dict(_stat(walls), cold_s=cold[eng][0],
                        load_s=cold[eng][0] - _median(walls),
                        cold_stages={k: cold[eng][1].get(k) for k in stages},
                        stages=stages, max_memory_allocated=max(
                            mem, default=None),
                        max_memory_allocated_by_card=mem or None,
                        perf_median_rep=perfs[walls.index(_median(walls))])
        ratios = [t / w for t, w in zip(ex_t, walls)]
        res["paired"][eng] = {"ratio_rep": ratios,
                              "ratio_median": _median(ratios),
                              "ratio_spread_pct": _spread_pct(ratios)}
        rows = _verify_rows(out("exact_0"), out(f"{eng}_cold"), thresh)
        res[eng]["rows"] = rows
        checks[f"{eng}_rows"] = rows["match_frac"] >= 0.99 \
            and rows["worst_unmatched_margin"] <= 0.02
        checks[f"{eng}_cold_equals_warm"] = _same_bytes(
            [out(f"{eng}_cold")] + [out(f"{eng}_w{i}") for i in range(reps)])
    if par_leg:
        par = [_exact(args, out(f"par2_{i}"), run_dir, timeout,
                      {"GENRICH_INGEST_THREADS": "2"})[0]
               for i in range(max(2, reps - 1))]
        res["exact_par2"] = dict(_stat(par), delta_vs_exact_s=_median(par)
                                 - res["exact"]["median_s"])
        checks["par2_equals_exact"] = _same_bytes(
            [out("exact_0")] + [out(f"par2_{i}") for i in range(len(par))])
    res["checks"] = checks
    res["ok"] = all(checks.values())
    return res


def bench_e2e(bams, configs, reps, device="cuda", engines=ENGINES,
              work=WORK, chroms=HG_CHROMS, timeout=1800.0, par_leg=True):
    """The end-to-end legs of ``configs`` on ``bams`` ({"A", "B", "C":
    path}), ``atac``'s two-worker parser leg with ``par_leg``; returns
    the detail dict's ``e2e`` part (``ok`` False when a check failed)."""
    from .ingest import ensure_native
    native = ensure_native()             # built once, before any child
    run_dir = os.path.join(work, "bench_e2e")
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    for path in set(bams.values()):      # the page cache, for every leg
        read_through(path)
    out = {"reps": reps, "device": device, "engines": list(engines),
           "bams": {k: os.path.basename(p) for k, p in bams.items()},
           "genome_bp": sum(size for _, size in chroms),
           "native_ingest": native.get("path"),
           "host": {"cpus": os.cpu_count(), "loadavg": os.getloadavg()},
           "protocol": "per configuration: a cold serve line per device "
                       "engine, then reps paired reps (exact child, then "
                       "one serve line per engine); ratio = exact wall / "
                       "serve wall of the same rep",
           "exact_ratio": "exact / --engine jax on atac (paired); the "
                          "compiled-reference leg of scripts/bench_e2e.py "
                          "is left out: it needs the Genrich sources",
           "configs": {}}
    if any(CONFIGS[c][2] for c in configs):
        exact_np = os.path.join(run_dir, "blk_source_exact.np")
        _exact(_config_args("atac", bams, run_dir)[0], exact_np, run_dir,
               timeout)
        out["blacklist_cut"] = write_blacklist(
            os.path.join(run_dir, "blk.bed"), exact_np, chroms)
    clients = {}
    try:
        for eng in engines:
            # no process group: the sharded engine spans every card
            # the child sees
            clients[eng] = ServeClient(run_dir, device, os.path.join(
                run_dir, f"serve_{eng}.log"), ready_timeout=timeout)
        out["serve_ready_s"] = {e: c.ready_s for e, c in clients.items()}
        for name in configs:
            out["configs"][name] = e2e_config(name, bams, clients, reps,
                                              run_dir, timeout,
                                              par_leg and name == "atac")
    finally:
        for c in clients.values():
            c.close()
    out["ok"] = all(c["ok"] for c in out["configs"].values())
    atac = out["configs"].get("atac", {})
    if "jax" in atac.get("paired", {}):
        out["paired"] = atac["paired"]["jax"]
    for eng in engines:
        if eng in atac:
            out[f"{eng}_s"] = atac[eng]["median_s"]
    return out


# --- scale ladder and ingest overlap ----------------------------------------

# scripts/bench_mem.py's rungs and phase timers, scripts/bench_overlap.py's
MEM_RUNGS = (2_000_000, 10_000_000, 40_000_000, 60_000_000)
OVERLAP_RUNGS = (10_000_000, 40_000_000)
MEM_OUT = os.path.join(WORK, "bench_torch_mem.json")
OVERLAP_OUT = os.path.join(WORK, "bench_torch_overlap.json")
# bench_mem.py's balanced order (ref, exact, exact, ref, ref, exact) with
# three contenders; reps r take its first 3r legs, repeated past 9
MEM_ORDER = ("exact", "jax", "sharded", "sharded", "jax", "exact", "exact",
             "jax", "sharded")
PROF_ENV = {"GENRICH_NATIVE_PROF": "1", "GENRICH_TPU_PROFILE": "1"}
PATH_KERNELS = ("coverage_scan", "tile_stats", "gap_join", "peak_reduce")
SUMMIT_TOL = 1e-4        # a near tie: the two summits' stats this close
PHASE_RES = {
    "records_s": re.compile(r"\[native\] records: ([0-9.]+)s"),
    "dedup_s": re.compile(r"post\(find_dups\): ([0-9.]+)s"),
    "dedup_scatter_s": re.compile(r"of which scatter: ([0-9.]+)s"),
    "pileup_s": re.compile(r"\[profile\] pileup expt: ([0-9.]+)s"),
    "pvalues_s": re.compile(r"\[profile\] p-values: ([0-9.]+)s"),
    "findpeaks_s": re.compile(r"\[profile\] findPeaks: ([0-9.]+)s"),
}
RECORDS_RE = PHASE_RES["records_s"]
DEDUP_RE = PHASE_RES["dedup_s"]
# the variables an overlap leg sets itself
INGEST_VARS = ("GENRICH_INGEST_THREADS", "GENRICH_ABLATE")
REF_NOTE = ("the ref_* legs of scripts/bench_mem.py (the compiled Genrich "
            "reference) wait on the Genrich sources; each rung pairs the "
            "port's --engine exact with its device engines")


def _phases(err):
    """``scripts/bench_mem.py``'s phase split of one exact run's stderr:
    each ``PHASE_RES`` timer summed over its lines, rounded to ms."""
    out = {}
    for key, rx in PHASE_RES.items():
        m = rx.findall(err or "")
        if m:
            out[key] = round(sum(float(x) for x in m), 3)
    return out


def ladder_bam(n_pairs, work=WORK, chroms=HG_CHROMS):
    """``scripts/bench_e2e.py::_bam_path``'s name of the ``n_pairs`` BAM
    (perf_synth's seed 7) in ``work``: the 2M rung's is BAM A."""
    tag = "hg" if tuple(map(tuple, chroms)) == HG_CHROMS \
        else "c%d" % sum(size for _, size in chroms)
    return os.path.abspath(os.path.join(work,
                                        f"atac_e2e_{tag}_{n_pairs}.bam"))


def ladder_bams(rungs, work=WORK, chroms=HG_CHROMS):
    """The rungs' BAMs, each missing one made by perf_synth, all at once;
    {n_pairs: (path, synthesis seconds or None)}."""
    return synth({n: (ladder_bam(n, work, chroms), n, 7) for n in rungs},
                 chroms)


def read_through(path):
    """Reads the file once, for the page cache."""
    with open(path, "rb") as f:
        while f.read(1 << 24):
            pass


def host_info():
    """The host's CPU count, load and RAM."""
    return {"cpus": os.cpu_count(), "loadavg": list(os.getloadavg()),
            "ram_gb": os.sysconf("SC_PAGE_SIZE")
            * os.sysconf("SC_PHYS_PAGES") / 1e9}


def mem_order(reps):
    """The legs of ``reps`` reps, ``MEM_ORDER``'s balanced order."""
    return (MEM_ORDER * -(-reps // 3))[:3 * reps]


def paired_ratios(legs):
    """Per device engine the ratios exact wall / engine wall of each
    temporally adjacent (exact, engine) pair of ``legs`` ([(contender,
    wall)], in order), as ``scripts/bench_mem.py`` pairs its legs: an
    exact leg stands for every engine, and a pair is closed when both
    sides have a leg."""
    engines = sorted({c for c, _ in legs} - {"exact"})
    cur = {eng: {} for eng in engines}
    out = {eng: [] for eng in engines}
    for who, t in legs:
        for eng in engines:
            if who in ("exact", eng):
                cur[eng][who] = t
            if len(cur[eng]) == 2:
                out[eng].append(cur[eng]["exact"] / cur[eng][eng])
                cur[eng] = {}
    return out


def _launched(perf, device):
    """Every card's launches of the path's kernels: each at least once
    on every card of the line on a card; none on the CPU, where the
    wrappers run their plain versions."""
    by_card = perf.get("launches_by_card", {})
    if device == "cpu":
        return all(not any(c.values()) for c in by_card.values())
    return bool(by_card) and all(c.get(k, 0) > 0 for c in by_card.values()
                                 for k in PATH_KERNELS)


def summit_check(exact_np, out_np, make_log, tol=SUMMIT_TOL):
    """``testing.check_summits`` of ``out_np`` against ``exact_np``;
    ``make_log()`` writes the exact engine's ``-f`` log and returns its
    path, called only when a matched row's summit differs (the log of a
    large input is gigabytes).  Raises AssertionError; returns
    {"compared", "differ_near_ties"}."""
    exact = open(exact_np).read().splitlines()
    port = open(out_np).read().splitlines()
    want = {tuple(ln.split("\t")[:3]): ln.split("\t")[9] for ln in exact}
    differ = any(want.get(tuple(f[:3]), f[9]) != f[9]
                 for f in (ln.split("\t") for ln in port))
    log = make_log() if differ else os.devnull
    n, ties = testing.check_summits(exact, port, log, tol)
    return {"compared": n, "differ_near_ties": ties}


def _peak(xs):
    """The largest of the values that are not None, else None."""
    return max((x for x in xs if x is not None), default=None)


def _engine_summary(cold, warm, rss, ready_s):
    """One device engine's lines of a rung: walls, stages, device memory
    (the largest of each card over its lines), re-dispatches, host peak
    chromosomes, its child's RSS (MB, how) over its whole life."""
    walls = [w for w, _ in warm]
    perfs = [cold[1]] + [p for _, p in warm]
    mem = [p.get("max_memory_allocated_by_card") for p in perfs]
    mem = [max(card) for card in zip(*(m for m in mem if m))]
    stages = ("ingest_s", "device_rep_s", "findpeaks_s")
    return dict(
        _stat(walls), cold_s=cold[0], ready_s=ready_s,
        cold_stages={k: cold[1].get(k) for k in stages},
        stages={k: [p.get(k) for _, p in warm] for k in stages},
        max_memory_allocated_by_card=mem or None,
        max_memory_allocated=max(mem, default=None), rss_mb=rss,
        peak_redispatch=[p.get("peak_redispatch") for p in perfs],
        host_peak_chroms=[p.get("host_peak_chroms") for p in perfs],
        launches_by_card=[p.get("launches_by_card") for p in perfs],
        perf_median_rep=warm[walls.index(_median(walls))][1])


def mem_rung(n_pairs, bam, reps=3, device="cuda", work=WORK,
             timeout=7200.0, engines=ENGINES):
    """One rung of the ladder on ``bam``: a fresh serve child per device
    engine (its first line the cold run), then the legs of
    ``mem_order(reps)``, the exact ones ``--engine exact -v`` children
    under ``PROF_ENV``.  Returns the rung's dict: ``scripts/bench_mem.py``'s
    keys for the exact side, one dict per engine with its paired ratios
    (``ratio_reps``, their median ``speedup``, ``ratio_spread_pct``), and
    ``checks`` (``ok`` False when one failed, ``faults`` saying why)."""
    run_dir = os.path.abspath(os.path.join(work, "bench_mem", str(n_pairs)))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    read_through(bam)
    args = ["-t", os.path.abspath(bam)] + E2E_FLAGS

    def out(tag):
        return os.path.join(run_dir, f"{tag}.np")
    res = {"n_pairs": n_pairs, "bam": os.path.basename(bam),
           "bam_mb": os.path.getsize(bam) / 1e6, "order": mem_order(reps)}
    clients, rss, cold = {}, {}, {}
    warm = {eng: [] for eng in engines}
    legs, ex_t, ex_rss, phase_reps = [], [], [], []
    err = ""
    try:
        for eng in engines:
            clients[eng] = ServeClient(run_dir, device, os.path.join(
                run_dir, f"serve_{eng}.log"), ready_timeout=timeout)
            cold[eng] = clients[eng].analyze(
                args + ["-o", out(f"{eng}_cold"), "--engine", eng], timeout)
        for who in res["order"]:
            if who == "exact":
                t, err, r = _exact(args, out(f"exact_{len(ex_t)}"), run_dir,
                                   timeout, PROF_ENV)
                ex_t.append(t)
                ex_rss.append(r)
                phase_reps.append(_phases(err))
            elif who in clients:
                t, perf = clients[who].analyze(args + [
                    "-o", out(f"{who}_w{len(warm[who])}"), "--engine", who],
                    timeout)
                warm[who].append((t, perf))
            else:
                continue
            legs.append((who, t))
    finally:
        for eng, c in clients.items():
            rss[eng] = c.close()
    res.update(exact_rep_s=ex_t, exact_s=_median(ex_t),
               exact_rss_mb=_peak(ex_rss),
               records=_records(err),
               peaks=sum(1 for _ in open(out("exact_0"))))
    keys = sorted({k for p in phase_reps for k in p})
    res["exact_phases"] = {k: _median([p[k] for p in phase_reps if k in p])
                           for k in keys}
    res["exact_phase_reps"] = phase_reps
    res["exact_rec_per_s"] = res["records"] / res["exact_s"]
    res["exact_us_per_rec"] = 1e6 * res["exact_s"] / res["records"]
    checks = {"exact_repeat_equal": _same_bytes(
        [out(f"exact_{i}") for i in range(len(ex_t))])}
    faults = {}
    log = []

    def make_log():
        if not log:
            log.append(os.path.join(run_dir, "exact.log"))
            _exact(args + ["-f", log[0]], out("exact_log"), run_dir,
                   timeout)
        return log[0]
    ratios = paired_ratios(legs)
    for eng in engines:
        e = res[eng] = _engine_summary(cold[eng], warm[eng], rss[eng],
                                       clients[eng].ready_s)
        pairs = ratios[eng]
        e.update(ratio_reps=pairs, speedup=_median(pairs),
                 ratio_spread_pct=_spread_pct(pairs))
        outs = [out(f"{eng}_cold")] + [out(f"{eng}_w{i}")
                                       for i in range(len(warm[eng]))]
        e["rows"] = _verify_rows(out("exact_0"), outs[0], Q_THRESH)
        checks[f"{eng}_rows"] = e["rows"]["match_frac"] >= 0.99 \
            and e["rows"]["worst_unmatched_margin"] <= 0.02
        try:
            e["summits"] = summit_check(out("exact_0"), outs[0], make_log)
            checks[f"{eng}_summits"] = True
        except AssertionError as x:
            checks[f"{eng}_summits"] = False
            faults[f"{eng}_summits"] = str(x)[:1000]
        checks[f"{eng}_cold_equals_warm"] = _same_bytes(outs)
        checks[f"{eng}_no_host_peak_chroms"] = not any(e["host_peak_chroms"])
        checks[f"{eng}_kernels_launched"] = all(
            _launched(p, device) for p in [cold[eng][1]]
            + [p for _, p in warm[eng]])
    res["exact_log_written"] = bool(log)
    res["checks"] = checks
    res["faults"] = faults
    res["ok"] = all(checks.values())
    return res


def mem_ladder(rungs=MEM_RUNGS, reps=3, device="cuda", work=WORK,
               chroms=HG_CHROMS, timeout=7200.0, out_path=None):
    """``scripts/bench_mem.py`` on the port: every rung's BAM made first
    (all missing ones at once), then ``mem_rung`` for each; the detail
    written to ``out_path`` after every rung.  Returns the dict with the
    script's top-level keys (``flags``, ``host``, ``ladder``), the card
    and ``ok``."""
    from .ingest import ensure_native
    native = ensure_native()             # built once, before any child
    if device == "cuda":
        from . import kernels
        kernels.library()                # so no cold line includes nvcc
    bams = ladder_bams(rungs, work, chroms)
    out = {"flags": " ".join(E2E_FLAGS), "host": host_info(),
           "card": card_line(torch.device(device)), "reps": reps,
           "device": device, "native_ingest": native.get("path"),
           "genome_bp": sum(size for _, size in chroms),
           "synth_s": {str(n): s for n, (_, s) in bams.items()},
           "note": REF_NOTE, "ladder": []}
    for n in rungs:
        out["ladder"].append(mem_rung(n, bams[n][0], reps, device, work,
                                      timeout))
        out["ok"] = all(r["ok"] for r in out["ladder"])
        out["bench_process_maxrss_mb"] = resource.getrusage(
            resource.RUSAGE_SELF).ru_maxrss / 1024.0
        if out_path:
            _write(out_path, out)
    return out


def compact_ladder(out):
    """The last stdout line of ``--mem``: the detail's rungs cut to
    ``scripts/bench_mem.py``'s keys and each engine's headline."""
    rungs = []
    for r in out["ladder"]:
        keep = {k: r[k] for k in (
            "n_pairs", "records", "peaks", "exact_rep_s", "exact_s",
            "exact_rss_mb", "exact_phases", "exact_rec_per_s",
            "exact_us_per_rec", "ok")}
        for eng in ENGINES:
            if eng in r:
                e = r[eng]
                keep[eng] = {
                    "warm_s": e["median_s"], "rep_s": e["rep_s"],
                    "cold_s": e["cold_s"], "ratio_reps": e["ratio_reps"],
                    "speedup": e["speedup"],
                    "ratio_spread_pct": e["ratio_spread_pct"],
                    "rss_mb": e["rss_mb"],
                    "max_memory_allocated": e["max_memory_allocated"],
                    "stages_median": {k: _median(v) for k, v in
                                      e["stages"].items() if None not in v}}
        keep["failed"] = [k for k, v in r["checks"].items() if not v]
        rungs.append(keep)
    return {k: out[k] for k in ("flags", "host", "card", "note", "ok")} \
        | {"ladder": rungs}


def overlap_leg(args, run_dir, tag, env, reps, timeout, ablate=None):
    """``scripts/bench_overlap.py``'s ``_leg`` on the port's exact engine:
    ``reps`` runs under ``GENRICH_NATIVE_PROF=1`` and ``env``, the
    ingest variables not in ``env`` unset.  Every run must print the
    record and dedup timers (one line of the native ingest); an ablated
    run's exit code is ignored (its records loop makes no fragments).
    Returns the walls, the median records and dedup timers, and the
    outputs written."""
    env = {"GENRICH_NATIVE_PROF": "1", **env}
    if ablate:
        env["GENRICH_ABLATE"] = ablate
    drop = [v for v in INGEST_VARS if v not in env]
    walls, recs, deds, outs = [], [], [], []
    for i in range(reps):
        o = os.path.join(run_dir, f"{tag}_{i}.np")
        cmd = [sys.executable, "-m", "genrich_tpu_torch"] + args + [
            "-o", o, "--engine", "exact"]
        t, rc, err, _ = _run_rss(cmd, run_dir, timeout, env, drop)
        if not ablate and rc != 0:
            raise RuntimeError(f"overlap {tag}: exit code {rc}: "
                               f"{(err or '')[-400:]}")
        if not ablate:
            outs.append(o)
        walls.append(t)
        for rx, got in ((RECORDS_RE, recs), (DEDUP_RE, deds)):
            m = rx.search(err or "")
            if not m:
                raise RuntimeError(f"overlap {tag}: no {rx.pattern} "
                                   f"timer: {(err or '')[-400:]}")
            got.append(float(m.group(1)))
    return {"wall_s": _median(walls), "wall_rep_s": walls, "outputs": outs,
            "records_s": _median(recs), "dedup_s": _median(deds)}


def default_workers(cpus):
    """The record-parse workers ``native/ingest.cpp::parse_threads``
    starts with GENRICH_INGEST_THREADS unset: cores - 2, at most 16, on
    4 cores or more, else none (sequential)."""
    return 0 if cpus < 4 else min(cpus - 2, 16)


def overlap_rung(n_pairs, bam, work=WORK, timeout=3600.0):
    """One rung of ``scripts/bench_overlap.py``: seq, par2, par2, seq
    (A-B-B-A, as the script), then the ``default`` leg (the variable
    unset: ``default_workers`` of this host), twice, and ``frame_only``
    (inflate and framing alone); the script's ``par2_gain_pct`` and
    ``records_minus_frame_s``, and ``default_gain_pct``.  Checks that
    every par2 and default output is seq's bytes."""
    run_dir = os.path.abspath(os.path.join(work, "bench_overlap",
                                           str(n_pairs)))
    shutil.rmtree(run_dir, ignore_errors=True)
    os.makedirs(run_dir)
    read_through(bam)
    args = ["-t", os.path.abspath(bam)] + E2E_FLAGS
    seq_env = {"GENRICH_INGEST_THREADS": "0"}
    s1 = overlap_leg(args, run_dir, "seq_a", seq_env, 1, timeout)
    p = overlap_leg(args, run_dir, "par2", {"GENRICH_INGEST_THREADS": "2"},
                    2, timeout)
    s2 = overlap_leg(args, run_dir, "seq_b", seq_env, 1, timeout)
    d = overlap_leg(args, run_dir, "default", {}, 2, timeout)
    frame = overlap_leg(args, run_dir, "frame_only", seq_env, 1, timeout,
                        ablate="frame")
    seq = {"wall_s": _median([s1["wall_s"], s2["wall_s"]]),
           "records_s": _median([s1["records_s"], s2["records_s"]]),
           "dedup_s": _median([s1["dedup_s"], s2["dedup_s"]]),
           "wall_rep_s": s1["wall_rep_s"] + s2["wall_rep_s"],
           "outputs": s1["outputs"] + s2["outputs"]}
    legs = {"seq": seq, "par2": p, "default": d, "frame_only": frame}
    checks = {"seq_repeat_equal": _same_bytes(seq["outputs"]),
              **{f"{k}_equals_seq": _same_bytes(seq["outputs"][:1]
                                                + legs[k]["outputs"])
                 for k in ("par2", "default")}}
    cpus = os.cpu_count()
    res = {"n_pairs": n_pairs, "cpus": cpus,
           "default_workers": default_workers(cpus),
           "order": ["seq", "par2", "par2", "seq", "default", "default",
                     "frame_only"],
           **{k: {x: v for x, v in leg.items() if x != "outputs"}
              for k, leg in legs.items()},
           "par2_gain_pct": 100.0 * (seq["wall_s"] - p["wall_s"])
           / seq["wall_s"],
           "default_gain_pct": 100.0 * (seq["wall_s"] - d["wall_s"])
           / seq["wall_s"],
           "records_minus_frame_s": seq["records_s"]
           - frame["records_s"],
           "checks": checks, "ok": all(checks.values())}
    return res


def overlap(rungs=OVERLAP_RUNGS, work=WORK, chroms=HG_CHROMS,
            timeout=3600.0, out_path=None):
    """``scripts/bench_overlap.py`` on the port: ``overlap_rung`` for each
    rung (the BAMs made first); the detail written after every rung."""
    from .ingest import ensure_native
    native = ensure_native()
    bams = ladder_bams(rungs, work, chroms)
    out = {"flags": " ".join(E2E_FLAGS), "host": host_info(),
           "native_ingest": native.get("path"), "rungs": []}
    for n in rungs:
        out["rungs"].append(overlap_rung(n, bams[n][0], work, timeout))
        out["ok"] = all(r["ok"] for r in out["rungs"])
        if out_path:
            _write(out_path, out)
    return out


# --- output -----------------------------------------------------------------

def compact_headline(out):
    """The last stdout line: the end-to-end keys of ``bench.py``'s
    headline and the card's name and power limit, well under 1,500
    characters whatever the detail holds."""
    e2e = out.get("e2e", {})
    e2e = e2e if isinstance(e2e, dict) else {}
    paired = e2e.get("paired", {})
    return {
        "e2e_exact_ratio": paired.get("ratio_median"),
        "e2e_ratio_spread_pct": paired.get("ratio_spread_pct"),
        "e2e_jax_warm_s": e2e.get("jax_s"),
        "e2e_sharded_warm_s": e2e.get("sharded_s"),
        "detail": out.get("detail"),
        "device": out.get("device"),
    }


def card_line(device):
    """``nvidia-smi``'s name and power limit of the card, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip() \
        .splitlines()[0]


def _write(path, out):
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as f:
        json.dump(out, f, indent=1, sort_keys=True, default=str)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m genrich_tpu_torch.bench")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--configs", default=",".join(CONFIGS),
                    help="end-to-end configurations, comma-separated")
    ap.add_argument("--reps", type=int, help="reps of every leg (default: "
                    "GENRICH_BENCH_E2E_REPS or 3 end to end, 3 on the "
                    "ladder)")
    ap.add_argument("--mem", nargs="*", type=int, metavar="N",
                    help="the scale ladder alone (scripts/bench_mem.py's "
                    "measure) at N read pairs a rung (default: "
                    f"{' '.join(map(str, MEM_RUNGS))}); its JSON is the "
                    "last line")
    ap.add_argument("--overlap", nargs="*", type=int, metavar="N",
                    help="the ingest-overlap legs alone "
                    "(scripts/bench_overlap.py's measure) at N read pairs a "
                    f"rung (default: {' '.join(map(str, OVERLAP_RUNGS))}); "
                    "its JSON is the last line")
    ap.add_argument("--out", help=f"the detail JSON (default: {DETAIL}, "
                    f"with --mem {MEM_OUT}, --overlap {OVERLAP_OUT})")
    a = ap.parse_args(argv)
    configs = [c for c in a.configs.split(",") if c]
    bad = [c for c in configs if c not in CONFIGS]
    if bad:
        ap.error(f"unknown configurations {bad}; known: {list(CONFIGS)}")
    device = torch.device(a.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("bench: no CUDA card "
                         "(torch.cuda.is_available() is False)")
    if a.mem is not None:
        out = mem_ladder(a.mem or MEM_RUNGS, a.reps or 3, a.device,
                         out_path=a.out or MEM_OUT)
        print(json.dumps(compact_ladder(out)))
        return 0 if out["ok"] else 1
    if a.overlap is not None:
        out = overlap(a.overlap or OVERLAP_RUNGS, out_path=a.out or OVERLAP_OUT)
        print(json.dumps(out))
        return 0 if out["ok"] else 1
    t0 = time.perf_counter()
    out = {"device": card_line(device), "detail": a.out or DETAIL}
    reps = a.reps or int(os.environ.get("GENRICH_BENCH_E2E_REPS", "3"))
    keys = sorted({k for c in configs for side in CONFIGS[c][:2]
                   for k in side.split(",") if k} | {"A"})
    out["e2e"] = bench_e2e(make_bams(keys), configs, reps, a.device)
    out["seconds"] = time.perf_counter() - t0
    _write(out["detail"], out)
    print(f"# {','.join(configs)}, {reps} reps, {out['device']}, "
          f"{out['seconds']:.0f} s", file=sys.stderr)
    if not out["e2e"]["ok"]:
        failed = {n: [c for c, v in r["checks"].items() if not v]
                  for n, r in out["e2e"]["configs"].items() if not r["ok"]}
        print(f"# FAILED checks: {failed}", file=sys.stderr)
    print(json.dumps(compact_headline(out)))
    return 0 if out["e2e"]["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
