"""PyTorch device engine for the CLI (twin of engine/jax_bridge.py).

``TorchEngine`` is what ``pipeline._replicate_device`` and
``pipeline._find_peaks_device`` drive (the JAX package's device-engine
contract, ``genrich_tpu/pipeline.py:310-505``): per-chromosome interval arrays stay resident on
the device between stages, and only compact data comes back to the
host -- the fragment-length scalars, the distinct (p, bp) table for the
host BH sweep (``engine/qvalue.merge_distinct_tables``) and the peak
records.  Reference semantics per stage:
  coverage/pileup   savePileupExpt/Ctrl   Genrich.c:2052-2295
  p-values          savePval/calcPval     Genrich.c:1628-1794
  q-values          computeQval           Genrich.c:146-401
  peak calling      callPeaks             Genrich.c:977-1069
Float32 on the device: results are close to the exact engine (about
1e-4 relative on -log10 p), not byte-identical.

Several replicates (``-t a,b``) archive each replicate's p-value RLE
on the device (``archive_replicate``) and combine them by Fisher's
method at peak-calling time (``finalize_fisher``, kernel K3); the
-f/-k logs and -X pull compact RLE pileups back to the host
(``pvalue_pileups``).  Chromosomes longer than 2^31-1 bp run on the
host (``HostChromMixin``), as in the JAX engine.

Events upload as int32 starts/ends and uint8 count codes at their real
length, narrowed on the host into reused (on CUDA, page-locked) slots
(``engine/staging.py``); the kernels mask their ragged tails, so
nothing is padded.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np
import torch

from .. import kernels
from ..ops import compact
from ..ops.peaks import call_peaks
from ..ops.pipeline import tile_coverage, tile_stats
from . import qvalue
from .host_fallback import INT32_MAX, HostChromMixin
from .perf import PerfMixin, span
from .pileup import Pileup
from .staging import EventStager

F32 = np.float32
PEAK_CAP = 1 << 15        # per-chrom device peak rows (jax_bridge's cap)
SKIP = -1.0


def pow2(n: int, lo: int = 1) -> int:
    """The least power of two that is at least ``n`` and ``lo``."""
    size = lo
    while size < n:
        size <<= 1
    return size


def check_device(device) -> torch.device:
    """``device`` as a torch.device: "cuda", "cuda:N" or "cpu".  A CUDA
    device with no card raises, never a silent switch to the CPU."""
    device = torch.device(device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {device} requested but no CUDA card "
                f"is available (torch.cuda.is_available() is False)")
    elif device.type != "cpu":
        raise ValueError(f"unsupported device {device}")
    return device


def chrom_peaks(starts, ends, pv, live, qtable, min_pq, min_auc,
                min_len: int, max_gap: int, use_q: bool, k: int):
    """One chromosome's peaks over its rows in genomic order (K5, K4),
    ``k`` candidate slots; the statistic is the q-value of ``qtable``
    (``assign_qvals``) with ``use_q``, else -log10 p.  Returns (int32
    [4, k] start, end, summit offset and valid; float32 [3, k] AUC,
    summit p and q; the candidate count)."""
    if use_q:
        qv = compact.assign_qvals(pv, *qtable)
        stat = qv
    else:
        qv = torch.full_like(pv, SKIP)
        stat = pv
    res = call_peaks(starts, ends, stat, pv, qv, live, float(F32(min_pq)),
                     float(F32(min_auc)), int(min_len), int(max_gap),
                     k_peaks=k)
    ints = torch.stack([res.start, res.end, res.summit_pos,
                        res.valid.to(torch.int32)])
    flts = torch.stack([res.auc, res.summit_pval, res.summit_qval])
    return ints, flts, res.n_peaks


def fetch_chrom_peaks(engine, handle):
    """Resolve a (dispatch, (ints, flts, n), slots, rows) handle of
    ``chrom_peaks`` through ``engine``'s accounted fetches.

    Returns (start, end, auc, summit_pval, summit_qval, summit_pos)
    numpy arrays of the emitted peaks in genomic order.  When the
    chromosome has more candidates than its slots, its peaks are
    called again on the device with the candidate count rounded up
    to a power of two (at most the row count) as the slots
    (``perf["peak_redispatch"]``): the rows one call with enough
    slots gives.
    """
    dispatch, (ints_d, flts_d, n_d), cap, rows = handle
    n, ints, flts = engine._fetch_many((n_d, ints_d, flts_d))
    if int(n) > cap:
        engine.perf["peak_redispatch"] += 1
        ints_d, flts_d, _ = dispatch(min(pow2(int(n)), rows))
        ints, flts = engine._fetch_many((ints_d, flts_d))
    k = np.flatnonzero(ints[3] != 0)
    return (ints[0, k].astype(np.int64), ints[1, k].astype(np.int64),
            flts[0, k], flts[1, k], flts[2, k],
            ints[2, k].astype(np.int64))


class TorchEngine(PerfMixin, HostChromMixin):
    """Per-run device context on one explicit ``device``.

    ``device`` is "cuda", "cuda:N" or "cpu"; a CUDA device with no card
    raises.  On CUDA the coverage scan, the p-value stage, the Fisher
    combination and the per-peak reduction run the hand-written
    kernels; on the CPU their plain PyTorch versions.
    """

    def __init__(self, device):
        self.device = check_device(device)
        self._stager = EventStager(self.device)
        self._chrom: Dict[int, dict] = {}
        self._reps: List[dict] = []
        self._qtable = None
        self._qtable_host = None
        self.begin_run()

    def begin_run(self) -> None:
        """Reset the per-analysis accounting, with the interval rows
        before and after ``stats_all`` merges them (``merge_rows``) and
        the event staging's counters (``EventStager``)."""
        super().begin_run()
        self.perf.update(interval_rows=0, real_rows=0, merged_rows=0,
                         merged_width=0, host_peak_chroms=0,
                         peak_redispatch=0, stage_bytes=0,
                         stage_alloc_n=0, stage_wait_s=0.0)

    def prepare(self, max_chrom_len: int = 0, max_gap: int = 0) -> None:
        """Build the CUDA kernels before the first chromosome.

        Takes the sharded engine's grid arguments and ignores them: eager
        PyTorch needs no shape buckets or program prewarm.  A build
        failure raises here.
        """
        if self.device.type == "cuda":
            kernels.library()

    # --- input staging -------------------------------------------------

    def _events(self, ev):
        """(starts int32, ends int32, count codes uint8) on the device,
        staged through ``EventStager``."""
        if ev is None or len(ev[0]) == 0:
            z = torch.zeros(0, dtype=torch.int32, device=self.device)
            return z, z, torch.zeros(0, dtype=torch.uint8,
                                     device=self.device)
        return self._stager.put(ev, self.perf)

    # --- stage 1: coverage (resident) + fragment sums -------------------

    def coverage_chrom(self, cidx: int, expt_ev, ctrl_ev,
                       bed: List[int], chrom_len: int) -> tuple:
        """Pileup coverage for one chromosome (asynchronous).

        Returns the two weighted fragment-length sums as device scalars
        (``coverage_finish`` pulls a batch of them at once).  A
        chromosome longer than 2^31-1 bp overflows int32 coordinates and
        is computed on the host instead (host_fallback.py).
        """
        if chrom_len > INT32_MAX:
            return self.host_coverage_chrom(cidx, expt_ev, ctrl_ev,
                                            bed, chrom_len)
        n_e = len(expt_ev[0]) if expt_ev is not None else 0
        n_c = len(ctrl_ev[0]) if ctrl_ev is not None else 0
        pairs = len(bed) // 2 + 1       # + one inert (len, len) pair
        rows = 1 + 2 * (n_e + n_c) + 2 * pairs
        if rows > INT32_MAX:
            raise ValueError(f"chromosome {cidx}: {rows} interval rows "
                             f"overflow int32 row indices")
        es, ee, ec = self._events(expt_ev)
        cs, ce, cc = self._events(ctrl_ev)
        excl = np.full((pairs, 2), chrom_len, np.int32)
        excl[:len(bed) // 2] = np.asarray(bed, np.int64).reshape(-1, 2)
        zero4 = torch.zeros(4, dtype=torch.int32, device=self.device)
        excl = self._put(excl)
        (starts, ends, ev, cr, excluded, live, frag, cfrag,
         level) = self._call(tile_coverage, es, ee, ec, cs, ce, cc, excl,
                             chrom_len, zero4, zero4, levels=True)
        self._chrom[cidx] = {
            "starts": starts, "ends": ends, "ev": ev, "cr": cr,
            "excluded": excluded, "live": live, "len": chrom_len,
            "level": level, "excl": excl,
        }
        return frag, cfrag

    def coverage_finish(self, handles: List[tuple]
                        ) -> Tuple[float, float]:
        """Resolve coverage handles to the two fragment sums.

        One pull for every device scalar; accumulation in submission
        order, as the JAX engine does.
        """
        dev = [x for h in handles for x in h
               if isinstance(x, torch.Tensor)]
        got = iter(self._fetch(torch.stack(dev)).tolist() if dev else ())
        frag = 0.0
        cfrag = 0.0
        for fe, fc in handles:
            frag += float(next(got) if isinstance(fe, torch.Tensor)
                          else fe)
            cfrag += float(next(got) if isinstance(fc, torch.Tensor)
                           else fc)
        return frag, cfrag

    # --- stage 2: p-values (resident) -----------------------------------

    def stats_all(self, lam: float, factor: float) -> None:
        """-log10 p per interval for every resident chromosome.

        First the interval rows become the exact engine's intervals
        (``merge_rows``), then K2 runs on them.  The coverage arrays
        (ev, cr, excluded) stay: ``pvalue_pileups`` reads them with λ
        and the control factor kept here.  The stages that only the
        full-device path reaches free them (``_drop_coverage``).
        """
        self._lam = F32(lam)
        self._factor = F32(factor)
        self.merge_rows()
        for st in self._chrom.values():
            if st.get("host"):
                continue
            st["pv"] = self._call(tile_stats, st["ev"], st["cr"],
                                  st["excluded"], F32(factor), F32(lam))
        self.host_stats(lam, factor)

    def merge_rows(self) -> None:
        """Merge each device chromosome's rows into the exact engine's
        intervals (``compact.pileup_runs``, with λ and the factor of
        ``stats_all``) and keep only those: one pull of every count.
        Each chromosome's merged arrays replace its rows as soon as they
        are queued, so the unmerged rows of one chromosome at a time are
        alive beside them."""
        pend = []
        for st in self._chrom.values():
            if st.get("host"):
                continue
            width = st["starts"].shape[0]
            r = self._call(compact.pileup_runs, st["starts"], st["ends"],
                           st["ev"], st["cr"], st["excluded"], st["live"],
                           st.pop("level"), st.pop("excl"), self._lam,
                           self._factor)
            st.update(starts=r.starts, ends=r.ends, ev=r.ev, cr=r.cr,
                      excluded=r.excluded)
            pend.append((st, width, torch.stack([r.n, r.n_rows])))
        if not pend:
            return
        p = self.perf
        for (st, width, _), (n, n_rows) in zip(
                pend, self._fetch_many([c for _, _, c in pend])):
            n = int(n)
            k = max(n, 1)        # an empty chromosome keeps a dead row
            p["interval_rows"] += width
            p["real_rows"] += int(n_rows)
            p["merged_rows"] += n
            p["merged_width"] += k
            for key in ("starts", "ends", "ev", "cr", "excluded"):
                st[key] = st[key][:k].clone()
            st["live"] = torch.arange(k, device=self.device) < n

    @staticmethod
    def _drop_coverage(st) -> None:
        for key in ("ev", "cr", "excluded"):
            st.pop(key, None)

    # --- multi-replicate: archive + device Fisher ------------------------

    def archive_replicate(self) -> None:
        """Compact this replicate's p-values to RLE and free coverage.

        Each chromosome's (ends, pv) runs stay resident, sliced (and
        copied, so the full-width arrays can go) to the run count, with
        at least one (chrom_len, SKIP) row; the dense arrays are
        released.  Used when a later replicate follows and the
        combination (Fisher) happens on the device at findPeaks time.
        The kept runs of the device chromosomes add to
        ``perf["archive_rows"]``.
        """
        rep: Dict[int, tuple] = {}
        pend = []
        for cidx, st in self._chrom.items():
            if st.get("host"):
                rep[cidx] = self.host_archive(st)
                continue
            self._drop_coverage(st)
            pend.append((cidx, st["len"], self._call(
                compact.rle_pv, st["starts"], st["ends"], st["pv"],
                st["live"], st["len"])))
        if pend:
            counts = self._fetch_many([b for _, _, (_, _, b) in pend])
            for (cidx, length, (e_b, pv_b, _)), nb in zip(pend, counts):
                n = max(int(nb), 1)
                self.perf["archive_rows"] += n
                rep[cidx] = (e_b[:n].clone(), pv_b[:n].clone(), length)
        self._reps.append(rep)
        self._chrom.clear()

    def finalize_fisher(self) -> None:
        """combinePval (Genrich.c:612-667) on the device.

        Merges every replicate's RLE breakpoints per chromosome and
        combines -log10 p with kernel K3 (``compact.merge_fisher``); the
        result repopulates ``self._chrom`` so q-values and peak calling
        run unchanged.  Host chromosomes combine on the host.  K3's
        lanes (the merged width: every replicate's kept runs) add to
        ``perf["fisher_rows"]``.
        """
        chroms = sorted({c for rep in self._reps for c in rep})
        for cidx in chroms:
            present = [rep[cidx] for rep in self._reps if cidx in rep]
            if any(self.host_is_archived(r) for r in present):
                self.host_fisher(cidx, present)
                continue
            self.perf["fisher_rows"] += sum(r[0].shape[0] for r in present)
            starts, ends, comb, live = self._call(
                compact.merge_fisher, [r[0] for r in present],
                [r[1] for r in present])
            self._chrom[cidx] = {
                "starts": starts, "ends": ends, "pv": comb,
                "live": live, "len": present[0][2],
            }
        self._reps.clear()

    def pval_pileup(self, cidx: int) -> Pileup:
        """The p-value RLE pileup (host peak caller fallback)."""
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pval_pileup(st)
        e_b, pv_b, b = self._call(compact.rle_pv, st["starts"],
                                  st["ends"], st["pv"], st["live"],
                                  st["len"])
        nb = int(self._fetch(b))
        if nb == 0:
            return Pileup(np.array([st["len"]], np.int64),
                          np.zeros(1, F32))
        e_np, pv_np = self._fetch_many((e_b[:nb], pv_b[:nb]))
        return Pileup(e_np.astype(np.int64), pv_np.astype(F32))

    # --- host-RLE path (-f/-k logs, -X, Fisher with logs) ----------------

    def pvalue_pileups(self, cidx: int
                       ) -> Tuple[Pileup, Pileup, Pileup]:
        """(expt, ctrl, pval) RLE pileups, compacted on the device first."""
        st = self._chrom[cidx]
        if st.get("host"):
            return self.host_pvalue_pileups(st)
        e_b, pv_b, ev_b, cv_b, b = self._call(
            compact.rle_runs, st["starts"], st["ends"], st["pv"],
            st["ev"], st["cr"], st["excluded"], st["live"], self._lam,
            self._factor)
        nb = int(self._fetch(b))
        if nb == 0:
            ends = np.array([st["len"]], np.int64)
            return (Pileup(ends, np.zeros(1, F32)),
                    Pileup(ends, np.full(1, self._lam, F32)),
                    Pileup(ends, np.zeros(1, F32)))
        e_np, pv_np, ev_np, cv_np = self._fetch_many(
            (e_b[:nb], pv_b[:nb], ev_b[:nb], cv_b[:nb]))
        ends = e_np.astype(np.int64)
        return (Pileup(ends, ev_np.astype(F32)),
                Pileup(ends, cv_np.astype(F32)),
                Pileup(ends, pv_np.astype(F32)))

    # --- stage 3: q-values ----------------------------------------------

    def qvalue_table(self, genome_len: int) -> bool:
        """Genome-wide BH from device-collected distinct p-values.

        Distinct (p, bp) pairs per chromosome are compacted on the
        device and merged on the host; the q sweep is the exact
        engine's float32 math (computeQval, Genrich.c:352-401).
        Returns the "all q-values are 1" warning condition.
        """
        ps, ws = [], []
        pend = []
        for st in self._chrom.values():
            if st.get("host"):
                hp, hw = self.host_distinct(st)
                if len(hp):
                    ps.append(np.asarray(hp, F32))
                    ws.append(np.asarray(hw, np.uint64))
                continue
            self._drop_coverage(st)
            pend.append(self._call(compact.distinct_pvals, st["starts"],
                                   st["ends"], st["pv"], st["live"]))
        if pend:
            nds = self._fetch_many([d for _, _, d in pend])
            live = [(pv_d[:int(nd)], w_d[:int(nd)])
                    for (pv_d, w_d, _), nd in zip(pend, nds) if int(nd)]
            if live:
                flat = self._fetch_many([x for pair in live for x in pair])
                for i in range(0, len(flat), 2):
                    ps.append(flat[i])
                    ws.append(flat[i + 1].astype(np.uint64))
        if not ps:
            z = torch.zeros(1, dtype=torch.float32, device=self.device)
            self._qtable = (z, z)
            self._qtable_host = (np.zeros(0, F32), np.zeros(0, F32))
            return False
        with span("pipeline.qvalue_merge", self.perf, "qvalue_merge_s"):
            uv, qv, tab_p, tab_q, _, all_one = \
                qvalue.merge_distinct_tables(ps, ws, genome_len)
        self._qtable = (self._put(tab_p), self._put(tab_q))
        self._qtable_host = (uv, qv)
        return all_one

    # --- stage 4: peaks (device) ----------------------------------------

    def peaks_submit(self, cidx: int, min_pq: float, min_auc: float,
                     min_len: int, max_gap: int, use_q: bool):
        """Queue peak calling for one chromosome (no blocking), with
        ``PEAK_CAP`` candidate slots.

        Returns a handle for ``peaks_fetch``, or None for a host
        chromosome (over 2^31-1 bp: the pipeline then runs the host
        peak caller, counted in ``perf["host_peak_chroms"]``).
        """
        st = self._chrom[cidx]
        if st.get("host"):
            self.perf["host_peak_chroms"] += 1
            return None
        self._drop_coverage(st)
        rows = st["starts"].shape[0]
        cap = min(PEAK_CAP, rows)

        def dispatch(k):
            return self._call(chrom_peaks, st["starts"], st["ends"],
                              st["pv"], st["live"], self._qtable, min_pq,
                              min_auc, min_len, max_gap, use_q, k)
        return dispatch, dispatch(cap), cap, rows

    def peaks_fetch(self, handle):
        """Resolve a ``peaks_submit`` handle (``fetch_chrom_peaks``)."""
        return fetch_chrom_peaks(self, handle)

    def release(self) -> None:
        self._chrom.clear()
        self._reps.clear()
        self._qtable = None
