"""Fragment-interval generation: reads/pairs -> pileup events.

Mirrors saveInterval/saveFragment/saveFragAtac/saveUnpair/saveAvgExt/
processAvgExt (Genrich.c:2490-2774).  Instead of scatter-adding into
per-base 'diff' arrays immediately (the reference's approach), events
``(start, end, count)`` are buffered in flat arrays per chromosome; the
device engine converts them to pileups in bulk (genrich_tpu.engine).

Integer semantics replicate the C code exactly, including uint32
wraparound in the ATAC window arithmetic and the int32 casts when those
wrapped values are handed to saveInterval's int64 parameters.

Known divergence from the reference: the reference skips an alignment
(with a warning) when the int16 per-base diff counter would overflow
(Genrich.c:2557-2573, requires ~32767 fragment ends at one base); this
implementation uses 32-bit accumulators and keeps such alignments.
"""

from __future__ import annotations

from typing import Dict, List, Optional

from ..errors import ERRPOS, fatal, warn
from ..params import MAX_ALNS, ATACADJF, ATACADJR
from .chroms import Chrom

U32 = 1 << 32


def u32(x: int) -> int:
    return x & (U32 - 1)


def i32(x: int) -> int:
    x &= U32 - 1
    return x - U32 if x >= (1 << 31) else x


class EventSink:
    """Per-chromosome buffers of (start, end, count) events.

    Event order is file order (only observable via the -b BED log, which
    is written on the fly, and the reference's int16-overflow guard,
    which is not replicated).
    """

    def __init__(self) -> None:
        self.by_chrom: Dict[int, List[List[int]]] = {}

    def add(self, chrom: Chrom, start: int, end: int, count: int) -> None:
        buf = self.by_chrom.get(chrom.index)
        if buf is None:
            buf = [[], [], []]
            self.by_chrom[chrom.index] = buf
        buf[0].append(start)
        buf[1].append(end)
        buf[2].append(count)

    def clear(self) -> None:
        self.by_chrom.clear()

    def has_events(self, chrom_index: int) -> bool:
        return chrom_index in self.by_chrom


class IntervalWriter:
    """Shared state for interval generation within one input file."""

    def __init__(self, sink: EventSink, bed_stream=None, ctrl: bool = False,
                 sample: int = 0, verbose: bool = False):
        self.sink = sink
        self.bed = bed_stream
        self.ctrl = ctrl
        self.sample = sample
        self.verbose = verbose
        self.err_count = 0  # capped-warning counter (Genrich.c:2524-2528)

    # --- saveInterval (Genrich.c:2510-2591) ---
    def save_interval(self, c: Chrom, start: int, end: int, qname: str,
                      count: int) -> int:
        if start < 0:
            if self.verbose:
                if self.err_count < MAX_ALNS:
                    warn(f"Warning! Read {qname} prevented from extending "
                         f"below 0 on {c.name}\n")
                self.err_count += 1
            start = 0
        if start >= c.length:
            raise fatal(f"Read {qname}, ref. {c.name}", ERRPOS)
        if end > c.length:
            if self.verbose:
                if self.err_count < MAX_ALNS:
                    warn(f"Warning! Read {qname} prevented from extending "
                         f"past {c.length} on {c.name}\n")
                self.err_count += 1
            end = c.length
        self.sink.add(c, start, end, count)
        if self.bed is not None:
            self.bed.write(f"{c.name}\t{start}\t{end}\t{qname}_{count}_"
                           f"{'C' if self.ctrl else 'E'}_{self.sample}\n")
        return end - start

    # --- saveFragment (Genrich.c:2751-2774) ---
    def save_fragment(self, qname: str, a, count: int, atac_opt: bool,
                      atac_len5: int, atac_len3: int, atac_adj: bool) -> int:
        if a.pos0 > a.pos1:
            start, end = a.pos1, a.pos0
        else:
            start, end = a.pos0, a.pos1
        if atac_opt:
            return self.save_frag_atac(a.chrom, start, end, atac_len5,
                                       atac_len3, atac_adj, qname, count)
        return self.save_interval(a.chrom, start, end, qname, count)

    # --- saveFragAtac (Genrich.c:2723-2749) ---
    def save_frag_atac(self, c: Chrom, start: int, end: int, atac_len5: int,
                       atac_len3: int, atac_adj: bool, qname: str,
                       count: int) -> int:
        if atac_adj:
            start = u32(start + ATACADJF)
            end = u32(end + ATACADJR)
        # C compares uint32(start+len3) >= uint32(int32(end-len3))
        if u32(start + atac_len3) >= u32(i32(u32(end - atac_len3))):
            # expanded intervals overlap: one merged interval
            return self.save_interval(c, i32(u32(start - atac_len5)),
                                      u32(end + atac_len5), qname, count)
        return (self.save_interval(c, i32(u32(start - atac_len5)),
                                   u32(start + atac_len3), qname, count)
                + self.save_interval(c, i32(u32(end - atac_len3)),
                                     u32(end + atac_len5), qname, count))

    # --- saveUnpair (Genrich.c:2684-2721) ---
    def save_unpair(self, qname: str, a, count: int, extend_opt: bool,
                    extend: int, atac_opt: bool, atac_len5: int,
                    atac_len3: int, atac_adj: bool) -> int:
        if extend_opt:
            if a.strand:
                return self.save_interval(a.chrom, a.pos0,
                                          u32(a.pos0 + extend), qname, count)
            return self.save_interval(a.chrom, i32(u32(a.pos1 - extend)),
                                      a.pos1, qname, count)
        if atac_opt:
            if a.strand:
                if atac_adj:
                    a.pos0 = u32(a.pos0 + ATACADJF)
                return self.save_interval(a.chrom, i32(u32(a.pos0 - atac_len5)),
                                          u32(a.pos0 + atac_len3),
                                          qname, count)
            if atac_adj:
                a.pos1 = u32(a.pos1 + ATACADJR)
            return self.save_interval(a.chrom, i32(u32(a.pos1 - atac_len3)),
                                      u32(a.pos1 + atac_len5), qname, count)
        return self.save_interval(a.chrom, a.pos0, a.pos1, qname, count)


def calc_avg_len(total_len: float, paired_pr: int, verbose: bool) -> int:
    """calcAvgLen (Genrich.c:2593-2607)."""
    if not paired_pr:
        if verbose:
            warn("Warning! No paired alignments to calculate avg frag "
                 "length --\n  Printing unpaired alignments \"as is\"\n")
        return 0
    return int(total_len / paired_pr + 0.5)


class UnpairBuffer:
    """Deferred unpaired alignments for -x (saveAvgExt, Genrich.c:2649-2682)."""

    def __init__(self) -> None:
        self.items: List = []  # (qname, chrom, strand, pos0, pos1, count)

    def add(self, qname: str, a, count: int) -> None:
        self.items.append((qname, a.chrom, a.strand, a.pos0, a.pos1, count))

    def process(self, writer: IntervalWriter, total_len: float,
                paired_pr: int, verbose: bool) -> None:
        """processAvgExt (Genrich.c:2609-2647)."""
        avg_len = calc_avg_len(total_len, paired_pr, verbose)
        for (qname, chrom, strand, pos0, pos1, count) in self.items:
            if not avg_len:
                writer.save_interval(chrom, pos0, pos1, qname, count)
            elif strand:
                writer.save_interval(chrom, pos0, u32(pos0 + avg_len),
                                     qname, count)
            else:
                writer.save_interval(chrom, i32(u32(pos1 - avg_len)), pos1,
                                     qname, count)
        self.items.clear()
