"""Alignment assembly and read-set processing (multimapper weighting).

Mirrors parseAlign/savePairedAln/updatePairedAln/saveSingleAln/sumQual
(Genrich.c:4044-4212) and processAlns/processPair/processSingle/
subsamplePair/subsampleSingle (Genrich.c:2979-3265).

All alignment-score arithmetic is float32 (C float): pair scores are
summed in f32, the asDiff tolerance is subtracted in f32, and NOSCORE is
-FLT_MAX so comparisons degrade exactly like the reference.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..errors import ERRINDEX, ERRISSUE, ERRLINEAR, fatal, warn
from ..params import MAX_ALNS
from ..utils.cfloat import NOSCORE
from .chroms import Chrom
from .intervals import IntervalWriter, UnpairBuffer

F32 = np.float32


class Aln:
    """One alignment of the current read template (Genrich.h:203-214)."""

    __slots__ = ("pos0", "pos1", "score", "primary", "paired", "full",
                 "first", "strand", "chrom")

    def __init__(self) -> None:
        self.pos0 = 0
        self.pos1 = 0
        self.score = NOSCORE
        self.primary = False
        self.paired = False
        self.full = False
        self.first = False
        self.strand = False
        self.chrom: Optional[Chrom] = None


def sum_qual(qual, offset: int) -> int:
    """sumQual (Genrich.c:4124-4134). qual: bytes (BAM) or str (SAM)."""
    if len(qual) and (qual[0] == 0xFF if isinstance(qual, (bytes, bytearray))
                      else ord(qual[0]) == 0xFF):
        return 0  # BAM 'null' value
    s = 0
    if isinstance(qual, (bytes, bytearray)):
        for q in qual:
            s += q - offset
    else:
        for ch in qual:
            s += ord(ch) - offset
    return min(s, 0xFFFF) if s <= 0xFFFF else 0xFFFF


class TemplateState:
    """Alignments + quality sums for the current queryname group."""

    def __init__(self) -> None:
        self.alns: List[Aln] = []
        self.qual_r1 = 0
        self.qual_r2 = 0

    def reset(self) -> None:
        self.alns.clear()
        self.qual_r1 = 0
        self.qual_r2 = 0


def parse_align(state: TemplateState, flag: int, chrom: Chrom, pos: int,
                length: int, pnext: int, counters, single_opt: bool,
                score, dups_opt: bool, qual, qual_offset: int) -> bool:
    """parseAlign (Genrich.c:4136-4212). Returns False at the aln cap."""
    if flag & 0x1:
        if (flag & 0xC0) == 0xC0:
            raise fatal("", ERRLINEAR)
        if not (flag & 0xC0):
            raise fatal("", ERRINDEX)

    if dups_opt:
        if flag & 0x40:
            if not state.qual_r1 and not _is_star(qual):
                state.qual_r1 = sum_qual(qual, qual_offset)
        else:
            if not state.qual_r2 and not _is_star(qual):
                state.qual_r2 = sum_qual(qual, qual_offset)

    if (flag & 0x3) == 0x3:
        # properly paired alignment
        if chrom.skip or not chrom.save:
            counters.skipped += 1
        else:
            counters.paired += 1
            if flag & 0x100:
                counters.sec_pair += 1

        # search for the matching half (already analyzed)
        for a in state.alns:
            if (a.paired and not a.full and a.chrom is chrom
                    and ((not a.first and a.pos0 == pos) if flag & 0x40
                         else (a.first and a.pos1 == pos))
                    and ((not a.primary) if flag & 0x100 else a.primary)):
                # updatePairedAln (Genrich.c:4046-4060)
                if flag & 0x40:
                    a.pos0 = pos + length if flag & 0x10 else pos
                else:
                    a.pos1 = pos + length if flag & 0x10 else pos
                if score == NOSCORE:
                    a.score = NOSCORE
                elif a.score != NOSCORE:
                    a.score = F32(a.score + F32(score))
                a.full = True
                return True

        # savePairedAln (Genrich.c:4062-4096)
        if len(state.alns) == MAX_ALNS:
            return False
        a = Aln()
        a.chrom = chrom
        a.score = F32(score)
        a.primary = not (flag & 0x100)
        a.full = False
        a.paired = True
        if flag & 0x40:
            a.pos0 = pos + length if flag & 0x10 else pos
            a.pos1 = pnext
            a.first = True
        else:
            a.pos0 = pnext
            a.pos1 = pos + length if flag & 0x10 else pos
            a.first = False
        state.alns.append(a)
        return True

    # unpaired alignment
    if chrom.skip or not chrom.save:
        counters.skipped += 1
    else:
        counters.single += 1
        if flag & 0x100:
            counters.sec_single += 1

    if single_opt:
        # saveSingleAln (Genrich.c:4098-4122)
        if len(state.alns) == MAX_ALNS:
            return False
        a = Aln()
        a.chrom = chrom
        a.score = F32(score)
        a.primary = not (flag & 0x100)
        a.paired = False
        a.strand = not (flag & 0x10)
        a.first = bool(flag & 0x40)
        a.pos0 = pos
        a.pos1 = pos + length
        state.alns.append(a)
    return True


def _is_star(qual) -> bool:
    if isinstance(qual, (bytes, bytearray)):
        return qual[:2] == b"*" or qual == b"*"
    return qual == "*"


def _subsample(valid_scores: List[np.float32], count: int):
    """subsamplePair/-Single (Genrich.c:2981-3012, 3085-3115).

    Insertion sort descending (stable: strict '>' keeps equal scores in
    encounter order); returns (new_count, new_min_score).
    """
    arr: List[np.float32] = []
    for s in valid_scores:
        j = 0
        while j < len(arr) and not (s > arr[j]):
            j += 1
        arr.insert(j, s)
    new_count = 10 if count > 10 else count - 1
    return new_count, arr[new_count - 1]


def process_pair(qname: str, alns: List[Aln], totals, score, as_diff,
                 atac_opt: bool, atac_len5: int, atac_len3: int,
                 atac_adj: bool, writer: IntervalWriter) -> int:
    """processPair (Genrich.c:3117-3176). Returns 1 if any aln saved."""
    if score != NOSCORE:
        score = F32(score - F32(as_diff))

    def valid(a: Aln) -> bool:
        return (a.paired and a.full and a.score >= score
                and a.chrom.save and not a.chrom.skip)

    count = sum(1 for a in alns if valid(a))
    if not count:
        return 0
    if count > 10 or count == 7 or count == 9:
        count, score = _subsample([a.score for a in alns if valid(a)], count)

    frag_len = 0
    saved = 0
    for a in alns:
        if valid(a):
            frag_len += writer.save_fragment(qname, a, count, atac_opt,
                                             atac_len5, atac_len3, atac_adj)
            saved += 1
            if saved == count:
                break  # in case of AS ties
    if saved != count:
        raise fatal(f"Saved {saved} alignments for read {qname}; "
                    f"should have been {count}", ERRISSUE)
    totals.total_len += frag_len / count
    return 1


def process_single(qname: str, alns: List[Aln], extend_opt: bool,
                   extend: int, avg_ext_opt: bool,
                   unpair: Optional[UnpairBuffer], score, as_diff,
                   first: bool, atac_opt: bool, atac_len5: int,
                   atac_len3: int, atac_adj: bool,
                   writer: IntervalWriter) -> int:
    """processSingle (Genrich.c:3014-3083)."""
    if score != NOSCORE:
        score = F32(score - F32(as_diff))

    def valid(a: Aln) -> bool:
        return (not a.paired and a.first == first and a.score >= score
                and a.chrom.save and not a.chrom.skip)

    count = sum(1 for a in alns if valid(a))
    if not count:
        return 0
    if count > 10 or count == 7 or count == 9:
        count, score = _subsample([a.score for a in alns if valid(a)], count)

    saved = 0
    for a in alns:
        if valid(a):
            if avg_ext_opt:
                unpair.add(qname, a, count)
            else:
                writer.save_unpair(qname, a, count, extend_opt, extend,
                                   atac_opt, atac_len5, atac_len3, atac_adj)
            saved += 1
            if saved == count:
                break  # in case of AS ties
    if saved != count:
        raise fatal(f"Saved {saved} alignments for read {qname}; "
                    f"should have been {count}", ERRISSUE)
    return 1


def process_alns(qname: str, state: TemplateState, totals, single_opt: bool,
                 extend_opt: bool, extend: int, avg_ext_opt: bool,
                 unpair: Optional[UnpairBuffer], as_diff, atac_opt: bool,
                 atac_len5: int, atac_len3: int, atac_adj: bool,
                 writer: IntervalWriter, dups_opt: bool, dedup) -> None:
    """processAlns (Genrich.c:3178-3265)."""
    score_pr = NOSCORE
    score_r1 = NOSCORE
    score_r2 = NOSCORE
    pair = single_r1 = single_r2 = False
    for a in state.alns:
        if a.paired:
            if a.full:
                if not pair or score_pr < a.score:
                    score_pr = a.score
                pair = True
            else:
                totals.orphan += 1
        elif single_opt and not pair:
            if a.first and score_r1 <= a.score:
                score_r1 = a.score
                single_r1 = True
            elif not a.first and score_r2 <= a.score:
                score_r2 = a.score
                single_r2 = True

    if dups_opt:
        dedup.save_alns(qname, state.alns, pair, single_opt, single_r1,
                        single_r2, score_pr, score_r1, score_r2,
                        as_diff, state.qual_r1, state.qual_r2)
        return

    if pair:
        totals.paired_pr += process_pair(
            qname, state.alns, totals, score_pr, as_diff, atac_opt,
            atac_len5, atac_len3, atac_adj, writer)
    elif single_opt:
        if single_r1:
            totals.single_pr += process_single(
                qname, state.alns, extend_opt, extend, avg_ext_opt, unpair,
                score_r1, as_diff, True, atac_opt, atac_len5, atac_len3,
                atac_adj, writer)
        if single_r2:
            totals.single_pr += process_single(
                qname, state.alns, extend_opt, extend, avg_ext_opt, unpair,
                score_r2, as_diff, False, atac_opt, atac_len5, atac_len3,
                atac_adj, writer)
