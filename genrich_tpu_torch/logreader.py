"""Peaks-only re-analysis from a -f log (-P mode).

Streaming state machine mirroring findPeaksOnly/getIdx/loadBDG/
callPeaksLog (Genrich.c:5243-5288, 1219-1488): header-sniffs the last
``-log(p)``/``-log(q)`` columns, re-applies new -e/-E exclusions post
hoc (with sub-interval splitting and warnings), re-derives the genome
length from record spans when -L is absent, and runs the same
updatePeak/checkPeak logic as the full pipeline.  Runs in O(log size)
time and O(1) memory — the resume half of the -X/-f checkpoint pair.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from .engine.peaks import Peak
from .errors import ERRINT, ERRLOG, ERRLOGIDX, fatal, warn
from .io import files
from .io.bed import load_bed, save_xbed
from .output.writers import write_peak
from .params import Params
from .utils.cfloat import SKIP, fmt_ld, fmt_prec, strtof

F32 = np.float32
UINT32_MAX = 0xFFFFFFFF


def _get_int(s: str) -> int:
    try:
        return int(s, 10)
    except ValueError:
        raise fatal(s, ERRINT)


def _get_float(s: str) -> np.float32:
    try:
        return strtof(s)
    except ValueError:
        raise fatal(s, ERRINT + 1)  # ERRFLOAT


class _PeakState:
    """updatePeak/checkPeak/resetVars state (Genrich.c:916-970)."""

    def __init__(self, out, min_auc, min_len):
        self.out = out
        self.min_auc = F32(min_auc)
        self.min_len = min_len
        self.count = 0
        self.peak_bp = 0
        self.reset()
        self.peak_end = -1

    def reset(self):
        self.peak_start = -1
        self.summit_val = F32(-1.0)
        self.summit_len = 0
        self.auc = F32(0.0)
        self.summit_pval = F32(-1.0)
        self.summit_qval = F32(-1.0)
        self.summit_pos = 0

    def update(self, start: int, end: int, pqval, min_pqval, pval,
               qval):
        length = (end - start) & UINT32_MAX
        self.auc = F32(self.auc + F32(
            np.uint32(length).astype(F32) * F32(pqval - F32(min_pqval))))
        if self.peak_start == -1:
            self.peak_start = start
        self.peak_end = end
        if pqval > self.summit_val:
            self.summit_val = pqval
            self.summit_pval = pval
            self.summit_qval = qval
            self.summit_pos = (((start + end) & UINT32_MAX) // 2
                               - self.peak_start) & UINT32_MAX
            self.summit_len = length
        elif pqval == self.summit_val and length > self.summit_len:
            self.summit_pos = (((start + end) & UINT32_MAX) // 2
                               - self.peak_start) & UINT32_MAX
            self.summit_len = length

    def check(self, name: str):
        if self.peak_start != -1 and self.auc >= self.min_auc \
                and self.peak_end - self.peak_start >= self.min_len:
            write_peak(self.out, name,
                       Peak(self.peak_start, self.peak_end, self.auc,
                            self.summit_pval, self.summit_qval,
                            self.summit_pos), self.count)
            self.peak_bp += self.peak_end - self.peak_start
            self.count += 1


def _get_idx(header: str, qval_opt: bool):
    """getIdx (Genrich.c:1224-1246): last -log(p)/-log(q) columns."""
    idx_p = -1
    idx_q = -1
    for i, field in enumerate(
            header.rstrip("\n").replace("\n", "\t").split("\t")):
        if field.startswith("-log(p)"):
            idx_p = i
        elif field.startswith("-log(q)"):
            idx_q = i
    if idx_p == -1:
        raise fatal("-log(p)", ERRLOGIDX)
    if qval_opt and idx_q == -1:
        raise fatal("-log(q)", ERRLOGIDX)
    return idx_p, idx_q


def find_peaks_only(p: Params) -> None:
    """findPeaksOnly (Genrich.c:5243-5288)."""
    xbed = load_bed(p.x_file) if p.x_file else []
    stream, _gz = files.open_read(p.log_file)
    out = files.open_write(p.out_file, p.gz_out)
    if p.verbose:
        warn(f"Peak-calling from log file: {p.log_file}\n")

    lines = iter(stream)
    try:
        header = next(lines)
    except StopIteration:
        raise fatal("<header>", ERRLOGIDX)
    if isinstance(header, (bytes, bytearray)):
        header = header.decode("ascii", "replace")
    idx_p, idx_q = _get_idx(header, p.qval_opt)
    idx = idx_q if p.qval_opt else idx_p

    # native fast path: the common resume case (no post-hoc -e/-E, a
    # regular file); anomalies fall back to the Python machine below
    if not xbed and not p.xchr_list and p.log_file != "-" \
            and p.ingest in ("auto", "native"):
        from .ingest import native as native_mod
        nat = native_mod.call_peaks_log_native(
            p.log_file, idx_p, idx_q, p.qval_opt, p.pqvalue,
            p.min_auc, p.min_len, p.max_gap, p.genome_len == 0)
        if nat is not None:
            (names, sec, starts, ends_, aucs, spvs, sqvs, sposs,
             glen, peak_bp) = nat
            for i in range(len(sec)):
                write_peak(out, names[sec[i]],
                           Peak(int(starts[i]), int(ends_[i]),
                                aucs[i], spvs[i], sqvs[i],
                                int(sposs[i])), i)
            if p.verbose:
                genome_len = p.genome_len or glen
                warn("Peak-calling parameters:\n")
                warn(f"  Genome length: {fmt_ld(genome_len)}bp\n")
                warn(f"  Significance threshold: "
                     f"-log({'q' if p.qval_opt else 'p'}) > "
                     f"{fmt_prec(F32(p.pqvalue), 3)}\n")
                warn(f"  Min. AUC: {fmt_prec(p.min_auc, 3)}\n")
                if p.min_len:
                    warn(f"  Min. peak length: {p.min_len}bp\n")
                warn(f"  Max. gap between sites: {p.max_gap}bp\n")
                warn(f"Peaks identified: {len(sec)} ({peak_bp}bp)\n")
            stream.close()
            if out is not None:
                import sys
                if out is not sys.stdout:
                    out.close()
            return

    st = _PeakState(out, p.min_auc, p.min_len)
    genome_opt = p.genome_len == 0
    genome_len = p.genome_len
    min_pqval = F32(p.pqvalue)
    warn_bed = False

    prev = ""
    skip = False
    bed: List[int] = []
    bed_idx = 0
    bed_pos = UINT32_MAX
    save = True
    chrom = ""

    for raw in lines:
        line = raw.decode("ascii", "replace") if isinstance(
            raw, (bytes, bytearray)) else raw
        fields = [f for f in line.rstrip("\n").split("\t") if True]
        if len(fields) <= idx:
            raise fatal("", ERRLOG)
        chrom = fields[0]
        start = _get_int(fields[1]) & UINT32_MAX
        end = _get_int(fields[2]) & UINT32_MAX
        p_stat = fields[idx_p]
        q_stat = fields[idx_q] if p.qval_opt else None

        if chrom != prev:
            st.check(prev)
            st.reset()
            skip = chrom in p.xchr_list
            if p.verbose and skip:
                warn(f"Warning! Skipping chromosome {chrom} --\n  "
                     f"Reads aligning to it were used in the background"
                     f" pileup calculation,\n  and its length was "
                     f"included in the genome length "
                     f"{'(and q-value) ' if p.qval_opt else ''}"
                     f"calculation\n")
            bed = []
            if not skip:
                bed = save_xbed(chrom, UINT32_MAX, xbed, p.verbose)
                bed_idx = 0
                bed_pos = bed[0] if bed else UINT32_MAX
                save = True
            prev = chrom
        if skip:
            continue

        stat = q_stat if p.qval_opt else p_stat
        if stat == "NA":
            st.check(chrom)
            st.reset()
            continue
        pqval = _get_float(stat)

        # new -E region starting exactly at this interval's start
        if bed_pos == start:
            if save:
                st.check(chrom)
                st.reset()
            save = not save
            bed_idx += 1
            bed_pos = bed[bed_idx] if bed_idx < len(bed) else UINT32_MAX

        # -E boundaries inside the interval: split into subintervals
        sub_start = start
        while start < bed_pos < end:
            if save:
                if pqval > min_pqval:
                    st.update(sub_start, bed_pos, pqval, min_pqval,
                              _get_float(p_stat) if p.qval_opt
                              else pqval,
                              pqval if p.qval_opt else SKIP)
                st.check(chrom)
                st.reset()
                if genome_opt:
                    genome_len += bed_pos - sub_start
            else:
                warn_bed = True
            sub_start = bed_pos
            save = not save
            bed_idx += 1
            bed_pos = bed[bed_idx] if bed_idx < len(bed) else UINT32_MAX
        if not save:
            warn_bed = True
            continue
        start = sub_start

        if genome_opt:
            genome_len += end - start
        if pqval > min_pqval:
            st.update(start, end, pqval, min_pqval,
                      _get_float(p_stat) if p.qval_opt else pqval,
                      pqval if p.qval_opt else SKIP)
        elif end - st.peak_end > p.max_gap:
            st.check(chrom)
            st.reset()

    st.check(chrom)

    if p.verbose:
        if warn_bed:
            warn("Warning! Skipping given BED regions --\n  Reads "
                 "aligning to them were used in the background pileup "
                 "calculation,\n  and the lengths were included in the "
                 "genome length "
                 f"{'(and q-value) ' if p.qval_opt else ''}"
                 "calculation\n")
        warn("Peak-calling parameters:\n")
        warn(f"  Genome length: {fmt_ld(genome_len)}bp\n")
        warn(f"  Significance threshold: "
             f"-log({'q' if p.qval_opt else 'p'}) > "
             f"{fmt_prec(min_pqval, 3)}\n")
        warn(f"  Min. AUC: {fmt_prec(p.min_auc, 3)}\n")
        if p.min_len:
            warn(f"  Min. peak length: {p.min_len}bp\n")
        warn(f"  Max. gap between sites: {p.max_gap}bp\n")
        warn(f"Peaks identified: {st.count} ({st.peak_bp}bp)\n")

    stream.close()
    if out is not None:
        import sys
        if out is not sys.stdout:
            out.close()
