"""Host (exact numpy) per-chromosome fallback for the device engines.

Device interval positions are int32 (PARITY.md), so a chromosome
longer than 2^31-1 bp cannot ride the device path.  Instead of dying
(the round-2 behavior), the jax/sharded bridges route *that
chromosome* through the exact engine's float32 operations — the same
code path as ``--engine exact`` (savePileupExpt/Ctrl + calcPval,
Genrich.c:2052-2295, 1628-1794) — while every other chromosome stays
on the device.  Host chromosomes live in the engine's ``_chrom`` dict
with a ``"host": True`` marker; q-values merge their distinct
(p, bp) tables with the device tables (one genome-wide exact BH), and
``peaks_chrom`` returns None for them so the pipeline's existing host
peak-caller fallback finishes the job.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..utils.cfloat import SKIP
from .pileup import Pileup

F32 = np.float32

INT32_MAX = 0x7FFFFFFF


def _widen(ev):
    """An event triple as the exact engine takes it: int64 arrays (the
    device path hands over the dtypes ingest gave)."""
    return None if ev is None else tuple(np.asarray(a, np.int64)
                                         for a in ev)


class HostChromMixin:
    """Mixin for JaxEngine/ShardedEngine: exact-engine computation of
    chromosomes whose coordinates overflow device int32."""

    INT32_MAX = INT32_MAX

    def host_coverage_chrom(self, cidx: int, expt_ev, ctrl_ev,
                            bed: List[int], chrom_len: int
                            ) -> Tuple[float, float]:
        """savePileupExpt + calcFactor's ctrl sweep for one host chrom.

        Control/lambda pileups need the global lam/factor, so they are
        deferred to :meth:`host_stats`; only the fragment-length sums
        (the engine contract of ``coverage_chrom``) return now.
        """
        from .pileup import (ctrl_frag_terms, exact_sum_f64,
                             expt_pileup)
        expt_ev, ctrl_ev = _widen(expt_ev), _widen(ctrl_ev)
        if expt_ev is None or len(expt_ev[0]) == 0:
            epu = Pileup(np.array([chrom_len], np.int64),
                         np.zeros(1, F32))
            frag = 0.0
        else:
            epu, terms = expt_pileup(expt_ev[0], expt_ev[1],
                                     expt_ev[2], chrom_len, bed)
            frag = exact_sum_f64(terms)
        cfrag = 0.0
        if ctrl_ev is not None and len(ctrl_ev[0]):
            cfrag = exact_sum_f64(ctrl_frag_terms(
                ctrl_ev[0], ctrl_ev[1], ctrl_ev[2], chrom_len, bed))
        self._chrom[cidx] = {
            "host": True, "epu": epu, "ctrl_ev": ctrl_ev,
            "bed": list(bed), "len": chrom_len,
        }
        return float(frag), float(cfrag)

    def host_stats(self, lam: float, factor: float) -> None:
        """Ctrl pileup + p-values for every pending host chromosome
        (savePileupCtrl/NoCtrl + calcPval, float32 exact order)."""
        from . import pvalue
        from .pileup import ctrl_pileup, lambda_pileup
        for st in self._chrom.values():
            if not st.get("host") or "epu" not in st:
                continue
            cv = st.pop("ctrl_ev")
            if cv is None or len(cv[0]) == 0:
                cpu = lambda_pileup(st["len"], st["bed"], F32(lam))
            else:
                cpu = ctrl_pileup(cv[0], cv[1], cv[2], st["len"],
                                  st["bed"], F32(factor), F32(lam))
            epu = st.pop("epu")
            ends, evv, cvv = pvalue.merge_pileups(epu, cpu)
            pv, tab = pvalue.calc_pval_unique_tab(ends, evv, cvv)
            st.update(ends=ends, ev=evv, cv=cvv, pv=pv, tab=tab)

    # --- RLE / distinct-table accessors -----------------------------------

    def host_pvalue_pileups(self, st) -> Tuple[Pileup, Pileup, Pileup]:
        return (Pileup(st["ends"], st["ev"]),
                Pileup(st["ends"], st["cv"]),
                Pileup(st["ends"], st["pv"], tab=st["tab"]))

    def host_pval_pileup(self, st) -> Pileup:
        return Pileup(st["ends"], st["pv"], tab=st.get("tab"))

    def host_distinct(self, st) -> Tuple[np.ndarray, np.ndarray]:
        """(distinct p, bp) contribution for the genome-wide BH."""
        if st.get("tab") is not None:
            return st["tab"]
        ends, pv = st["ends"], st["pv"]
        starts = np.concatenate([[0], ends[:-1]])
        lens = (ends - starts).astype(np.uint64)
        keep = pv != F32(SKIP)
        return pv[keep], lens[keep]

    # --- multi-replicate (Fisher) -----------------------------------------

    def host_archive(self, st) -> tuple:
        """Archive entry for one host chromosome's replicate."""
        return ("host", Pileup(st["ends"], st["pv"],
                               tab=st.get("tab")), st["len"])

    @staticmethod
    def host_is_archived(entry) -> bool:
        # device archive entries are also 3-tuples whose first element
        # is a device array: type-check before comparing, so the
        # marker test never evaluates array == str (whose semantics
        # vary across jax versions)
        return isinstance(entry, tuple) and len(entry) == 3 \
            and isinstance(entry[0], str) and entry[0] == "host"

    def host_fisher(self, cidx: int, entries: List[tuple]) -> None:
        """combinePval (Genrich.c:612-667) across replicates, exact."""
        from . import chisq
        chrom_len = entries[0][2]
        pus: List[Optional[Pileup]] = [e[1] for e in entries]
        comb = chisq.combine_pvals(pus, chrom_len)
        self._chrom[cidx] = {
            "host": True, "ends": comb.end, "pv": comb.cov,
            "tab": comb.tab, "len": chrom_len,
        }
