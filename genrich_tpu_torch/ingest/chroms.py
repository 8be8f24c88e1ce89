"""Chromosome (reference-sequence) registry from SAM/BAM headers.

Mirrors saveChrom/loadChrom/checkHeader (Genrich.c:4214-4342): dedupe by
name with length-mismatch check; 'save' is per-sample (reset before each
replicate; set when the chrom appears in an experimental file; ctrl-only
chroms stay save=False); 'skip' marks -e exclusions permanently.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

from ..errors import ERRCHRLEN, ERRSORT, fatal
from ..io.bed import save_xbed


class Chrom:
    __slots__ = ("name", "length", "skip", "save", "bed", "index")

    def __init__(self, name: str, length: int, skip: bool, save: bool,
                 bed: List[int], index: int):
        self.name = name
        self.length = length
        self.skip = skip
        self.save = save
        self.bed = bed      # flat [s0,e0,s1,e1,...] merged -E exclusions
        self.index = index


class ChromRegistry:
    def __init__(self, xchr_list: List[str],
                 xbed: List[Tuple[str, int, int]], verbose: bool):
        self.chroms: List[Chrom] = []
        self.by_name: Dict[str, Chrom] = {}
        self.xchr_list = xchr_list
        self.xbed = xbed
        self.verbose = verbose

    def __len__(self) -> int:
        return len(self.chroms)

    def __iter__(self):
        return iter(self.chroms)

    def save_chrom(self, name: str, length: int, ctrl: bool) -> Chrom:
        """saveChrom (Genrich.c:4216-4270)."""
        c = self.by_name.get(name)
        if c is not None:
            if c.length != length:
                raise fatal(c.name, ERRCHRLEN)
            if not ctrl:
                c.save = True
            return c
        skip = name in self.xchr_list
        bed = [] if skip else save_xbed(name, length, self.xbed, self.verbose)
        c = Chrom(name, length, skip, not ctrl, bed, len(self.chroms))
        self.chroms.append(c)
        self.by_name[name] = c
        return c

    def reset_save_flags(self) -> None:
        """Per-replicate reset (runProgram, Genrich.c:5462-5464)."""
        for c in self.chroms:
            c.save = False


def check_sam_header(line: str, registry: ChromRegistry, ctrl: bool,
                     sort_opt: bool) -> None:
    """checkHeader (Genrich.c:4303-4342) for one SAM header line."""
    fields = line.rstrip("\n").split("\t")
    if not fields:
        return
    tag = fields[0]
    if tag == "@HD":
        order: Optional[str] = None
        for f in fields[1:]:
            if f.startswith("SO:"):
                order = f[3:]
        if sort_opt and (order is None or order != "queryname"):
            raise fatal("", ERRSORT)
    elif tag == "@SQ":
        name = None
        length = None
        for f in fields[1:]:
            if f.startswith("SN:"):
                name = f[3:]
            elif f.startswith("LN:"):
                length = f[3:]
        if name is None or length is None:
            return
        registry.save_chrom(name, int(length), ctrl)
