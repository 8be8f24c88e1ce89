"""PCR-duplicate removal (-r): deferred read stores + keyed matching.

Mirrors the reference's three-class scheme (Genrich.c:2776-2977,
3269-4042): reads are buffered whole-file, then evaluated in descending
summed-quality order (stable; ties keep file order, reproducing
johnSort, Genrich.c:3274-3354).  Hashtables become Python dicts keyed on
the alignment coordinates; chain-insertion-order effects on the -R log
are reproduced by overwriting names on direct adds (head insertion =
latest match wins) and keeping the first name on check-and-add seeding.

Classes: properly paired (key: chrom, 5'pos-sorted pair), discordant
(key: both ends with strand, checked in both orientations), singleton
(key: chrom, 5' pos, strand).  The singleton table is pre-seeded with
both ends of every kept pair and discordant aln (Genrich.c:3579-3585,
3703-3711).  A read matching on *any* alignment is a duplicate.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np

from ..utils.cfloat import NOSCORE
from .alnproc import Aln, process_pair, process_single
from .intervals import IntervalWriter, calc_avg_len

F32 = np.float32


class ReadRec:
    """A buffered read with its surviving alignments (Genrich.h:227-237)."""

    __slots__ = ("name", "qual", "score", "score_r2", "first",
                 "alns", "alns_r2")

    def __init__(self) -> None:
        self.name = ""
        self.qual = 0
        self.score = NOSCORE
        self.score_r2 = NOSCORE
        self.first = False
        self.alns: List[Aln] = []
        self.alns_r2: List[Aln] = []


def _copy_alns(alns: List[Aln], score, as_diff, first: bool) -> List[Aln]:
    """copyAlns (Genrich.c:2815-2851): singles filtered by score."""
    if score != NOSCORE:
        score = F32(score - F32(as_diff))
    out = []
    for a in alns:
        if not a.paired and a.first == first and a.score >= score:
            b = Aln()
            b.paired = a.paired
            b.first = a.first
            b.strand = a.strand
            b.score = a.score
            b.chrom = a.chrom
            b.pos0 = a.pos0
            b.pos1 = a.pos1
            out.append(b)
    return out


class DedupState:
    """Per-file read stores for deferred duplicate evaluation."""

    def __init__(self) -> None:
        self.reads_pr: List[ReadRec] = []
        self.reads_dc: List[ReadRec] = []
        self.reads_sn: List[ReadRec] = []

    def save_alns(self, qname: str, alns: List[Aln], pair: bool,
                  single_opt: bool, single_r1: bool, single_r2: bool,
                  score_pr, score_r1, score_r2, as_diff,
                  qual_r1: int, qual_r2: int) -> None:
        """saveAlns (Genrich.c:2942-2977)."""
        if pair:
            r = ReadRec()
            r.name = qname
            r.qual = min(qual_r1 + qual_r2, 0xFFFF)
            r.score = score_pr
            score = score_pr
            if score != NOSCORE:
                score = F32(score - F32(as_diff))
            for a in alns:
                if a.paired and a.full and a.score >= score:
                    b = Aln()
                    b.paired = a.paired
                    b.full = a.full
                    b.score = a.score
                    b.chrom = a.chrom
                    if a.pos0 > a.pos1:
                        b.pos0, b.pos1 = a.pos1, a.pos0
                    else:
                        b.pos0, b.pos1 = a.pos0, a.pos1
                    r.alns.append(b)
            self.reads_pr.append(r)
        elif single_opt:
            if single_r1 and single_r2:
                r = ReadRec()
                r.name = qname
                r.first = True
                r.score = score_r1
                r.score_r2 = score_r2
                r.qual = min(qual_r1 + qual_r2, 0xFFFF)
                r.alns = _copy_alns(alns, score_r1, as_diff, True)
                r.alns_r2 = _copy_alns(alns, score_r2, as_diff, False)
                self.reads_dc.append(r)
            elif single_r1 or single_r2:
                r = ReadRec()
                r.name = qname
                r.first = single_r1
                r.score = score_r1 if single_r1 else score_r2
                r.qual = qual_r1 if single_r1 else qual_r2
                r.alns = _copy_alns(alns, r.score, as_diff, single_r1)
                self.reads_sn.append(r)


def _sort_order(reads: List[ReadRec]) -> np.ndarray:
    """sortReads/johnSort: stable descending by summed quality."""
    qual = np.fromiter((r.qual for r in reads), np.int32, len(reads))
    return np.argsort(-qual, kind="stable")


def find_dups(state: DedupState, totals, writer: IntervalWriter,
              single_opt: bool, extend_opt: bool, extend: int,
              avg_ext_opt: bool, as_diff, atac_opt: bool,
              atac_len5: int, atac_len3: int, atac_adj: bool,
              dups_stream=None, verbose: bool = False) -> None:
    """findDups (Genrich.c:3949-4042): evaluate all three classes."""
    seed_singles = single_opt and len(state.reads_sn) > 0
    table_sn: Dict[Tuple, Optional[str]] = {}
    dups_verb = dups_stream is not None

    def check_and_add(chrom, pos, strand, name):
        key = (chrom.index, pos, strand)
        if key not in table_sn:
            table_sn[key] = name

    # --- properly paired (findDupsPr, Genrich.c:3616-3683) ---
    table: Dict[Tuple, Optional[str]] = {}
    for i in _sort_order(state.reads_pr):
        r = state.reads_pr[i]
        hit = None
        for a in r.alns:
            key = (a.chrom.index, a.pos0, a.pos1)
            if key in table:
                hit = (a, table[key])
                break
        totals.count_pr += 1
        if hit is not None:
            totals.dups_pr += 1
            if dups_verb:
                a, match = hit
                dups_stream.write(f"{r.name}\t{a.chrom.name}:{a.pos0}-"
                                  f"{a.pos1}\t{match}\tpaired\n")
            continue
        for a in r.alns:
            table[(a.chrom.index, a.pos0, a.pos1)] = \
                r.name if dups_verb else None
            if seed_singles:
                check_and_add(a.chrom, a.pos0, True,
                              r.name if dups_verb else None)
                check_and_add(a.chrom, a.pos1, False,
                              r.name if dups_verb else None)
        totals.paired_pr += process_pair(
            r.name, r.alns, totals, r.score, as_diff, atac_opt,
            atac_len5, atac_len3, atac_adj, writer)

    if not single_opt:
        return

    # with -x, switch to fixed extension by the average fragment length
    if avg_ext_opt:
        extend = calc_avg_len(totals.total_len, totals.paired_pr, verbose)
        extend_opt = extend != 0

    # --- discordant (findDupsDc, Genrich.c:3761-3839) ---
    table = {}
    for i in _sort_order(state.reads_dc):
        r = state.reads_dc[i]
        dup = None
        for a in r.alns:
            pos = a.pos0 if a.strand else a.pos1
            for b in r.alns_r2:
                pos1 = b.pos0 if b.strand else b.pos1
                k1 = (a.chrom.index, a.strand, pos,
                      b.chrom.index, b.strand, pos1)
                k2 = (b.chrom.index, b.strand, pos1,
                      a.chrom.index, a.strand, pos)
                if k1 in table:
                    dup = (table[k1], a.chrom, pos, a.strand,
                           b.chrom, pos1, b.strand)
                    break
                if k2 in table:
                    dup = (table[k2], b.chrom, pos1, b.strand,
                           a.chrom, pos, a.strand)
                    break
            if dup:
                break
        totals.count_dc += 1
        if dup:
            totals.dups_dc += 1
            if dups_verb:
                (m, c0, p0, s0, c1, p1, s1) = dup
                dups_stream.write(
                    f"{r.name}\t{c0.name}:{p0},{'+' if s0 else '-'};"
                    f"{c1.name}:{p1},{'+' if s1 else '-'}\t{m}"
                    f"\tdiscordant\n")
            continue
        for k, a in enumerate(r.alns):
            pos = a.pos0 if a.strand else a.pos1
            for j, b in enumerate(r.alns_r2):
                pos1 = b.pos0 if b.strand else b.pos1
                table[(a.chrom.index, a.strand, pos,
                       b.chrom.index, b.strand, pos1)] = \
                    r.name if dups_verb else None
                if seed_singles:
                    if j == 0:
                        check_and_add(a.chrom, pos, a.strand,
                                      r.name if dups_verb else None)
                    if k == 0:
                        check_and_add(b.chrom, pos1, b.strand,
                                      r.name if dups_verb else None)
        totals.single_pr += process_single(
            r.name, r.alns, extend_opt, extend, False, None,
            r.score, as_diff, True, atac_opt, atac_len5, atac_len3,
            atac_adj, writer)
        totals.single_pr += process_single(
            r.name, r.alns_r2, extend_opt, extend, False, None,
            r.score_r2, as_diff, False, atac_opt, atac_len5,
            atac_len3, atac_adj, writer)

    # --- singletons (findDupsSn, Genrich.c:3886-3943) ---
    for i in _sort_order(state.reads_sn):
        r = state.reads_sn[i]
        match = None
        mkey = None
        for a in r.alns:
            pos = a.pos0 if a.strand else a.pos1
            key = (a.chrom.index, pos, a.strand)
            if key in table_sn:
                match = table_sn[key]
                mkey = (a.chrom, pos, a.strand)
                break
        totals.count_sn += 1
        if mkey is not None:
            totals.dups_sn += 1
            if dups_verb:
                c, pos, s = mkey
                dups_stream.write(f"{r.name}\t{c.name}:{pos},"
                                  f"{'+' if s else '-'}\t{match}"
                                  f"\tsingle\n")
            continue
        for a in r.alns:
            pos = a.pos0 if a.strand else a.pos1
            table_sn[(a.chrom.index, pos, a.strand)] = \
                r.name if dups_verb else None
        totals.single_pr += process_single(
            r.name, r.alns, extend_opt, extend, False, None,
            r.score, as_diff, r.first, atac_opt, atac_len5,
            atac_len3, atac_adj, writer)

    state.reads_pr.clear()
    state.reads_dc.clear()
    state.reads_sn.clear()
