"""Output writers: narrowPeak, -f stats log, -k pileup log.

Formats replicate printPeak (Genrich.c:885-909), printLogHeader /
printInterval / printIntervalN (674-803) and printPileHeader/printPile
(1680-1715) byte-for-byte, including the uint32->%d reinterpretation of
the summit position.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..engine.peaks import Peak, peak_score
from ..engine.pileup import Pileup
from ..utils.cfloat import SKIP, fmt_f

NA = "NA"  # Genrich.h:40


def _i32(x: int) -> int:
    """Print a uint32 through C's %d (reinterpret as int32)."""
    x &= 0xFFFFFFFF
    return x - (1 << 32) if x >= (1 << 31) else x


class RowLog:
    """Path-backed append log with native bulk-row fast paths.

    Behaves like a text stream for headers and odd rows (buffered,
    appended via the native library so interleaving with the bulk
    writers keeps file order); per-chromosome interval blocks go
    through gi_write_log_rows/gi_write_pile_rows at fprintf speed.
    Gzip targets gain one member per append; decompressed bytes match
    the reference's single-member stream.
    """

    def __init__(self, path: str, gz: bool):
        from ..io import files
        from ..ingest import native as native_mod
        self._nat = native_mod
        self.path = files.resolve_out_path(path, gz)
        self.gz = gz
        self._buf: List[str] = []
        open(self.path, "wb").close()

    def write(self, text: str) -> None:
        self._buf.append(text)
        if len(self._buf) >= 65536:
            self.flush()

    def flush(self) -> None:
        if self._buf:
            self._nat.append_text(self.path, self.gz,
                                  "".join(self._buf))
            self._buf = []

    def log_rows(self, name, starts, ends, expt, ctrl, pval, qval,
                 sig) -> bool:
        self.flush()
        return self._nat.write_log_rows(self.path, self.gz, name,
                                        starts, ends, expt, ctrl,
                                        pval, qval, sig)

    def pile_rows(self, name, starts, ends, expt, ctrl, pval) -> bool:
        self.flush()
        return self._nat.write_pile_rows(self.path, self.gz, name,
                                         starts, ends, expt, ctrl,
                                         pval)

    def close(self) -> None:
        self.flush()


def write_peak(out, name: str, peak: Peak, count: int) -> None:
    """printPeak: one narrowPeak row; ``count`` is the global index."""
    score = peak_score(peak.auc, peak.end - peak.start)
    row = (f"{name}\t{peak.start}\t{peak.end}\tpeak_{count}\t{score}"
           f"\t.\t{fmt_f(peak.auc)}\t{fmt_f(peak.summit_pval)}")
    if peak.summit_qval == SKIP:
        row += f"\t-1\t{_i32(peak.summit_pos)}\n"
    else:
        row += f"\t{fmt_f(peak.summit_qval)}\t{_i32(peak.summit_pos)}\n"
    out.write(row)


def log_header(log, n: int, qval_opt: bool, sig_opt: bool) -> None:
    """printLogHeader (Genrich.c:674-717)."""
    if n:
        cols = "chr\tstart\tend"
        for i in range(n):
            cols += f"\t-log(p)_{i}"
        cols += "\t-log(p)_comb"
    else:
        cols = "chr\tstart\tend\texperimental\tcontrol\t-log(p)"
    if qval_opt:
        cols += "\t-log(q)"
    if sig_opt:
        cols += "\tsignif"
    log.write(cols + "\n")


def log_interval(log, name: str, start: int, end: int,
                 expt: np.float32, ctrl: np.float32, pval: np.float32,
                 qval_opt: bool, qval: np.float32, sig: bool) -> None:
    """printInterval (Genrich.c:770-803): single-replicate row."""
    if ctrl == SKIP:
        row = (f"{name}\t{_i32(start)}\t{_i32(end)}\t{fmt_f(expt)}"
               f"\t{fmt_f(0.0)}\t{NA}")
        if qval_opt:
            row += f"\t{NA}"
        log.write(row + "\n")
    else:
        row = (f"{name}\t{_i32(start)}\t{_i32(end)}\t{fmt_f(expt)}"
               f"\t{fmt_f(ctrl)}\t{fmt_f(pval)}")
        if qval_opt:
            row += f"\t{fmt_f(qval)}"
        log.write(row + ("\t*\n" if sig else "\n"))


def log_interval_n(log, name: str, start: int, end: int,
                   rep_vals: List[Optional[np.float32]],
                   pval: np.float32, qval_opt: bool,
                   qval: np.float32, sig: bool) -> None:
    """printIntervalN (Genrich.c:724-763): multi-replicate row.

    ``rep_vals`` holds each replicate's value (None/SKIP -> NA).
    """
    row = f"{name}\t{_i32(start)}\t{_i32(end)}"
    for v in rep_vals:
        if v is None or v == SKIP:
            row += f"\t{NA}"
        else:
            row += f"\t{fmt_f(v)}"
    if pval == SKIP:
        row += f"\t{NA}"
        if qval_opt:
            row += f"\t{NA}"
    else:
        row += f"\t{fmt_f(pval)}"
        if qval_opt:
            row += f"\t{fmt_f(qval)}"
    log.write(row + ("\t*\n" if sig else "\n"))


def pile_header(pile, expt_name: str, ctrl_name: Optional[str]) -> None:
    """printPileHeader (Genrich.c:1680-1691)."""
    cname = ctrl_name if ctrl_name and ctrl_name != "null" else NA
    pile.write(f"# experimental file: {expt_name}; control file: "
               f"{cname}\n")
    pile.write("chr\tstart\tend\texperimental\tcontrol\t-log(p)\n")


def pile_row(pile, name: str, start: int, end: int, expt: np.float32,
             ctrl: np.float32, pval: np.float32) -> None:
    """printPile (Genrich.c:1697-1715)."""
    if ctrl == SKIP:
        pile.write(f"{name}\t{_i32(start)}\t{_i32(end)}\t{fmt_f(expt)}"
                   f"\t{fmt_f(0.0)}\t{NA}\n")
    else:
        pile.write(f"{name}\t{_i32(start)}\t{_i32(end)}\t{fmt_f(expt)}"
                   f"\t{fmt_f(ctrl)}\t{fmt_f(pval)}\n")
