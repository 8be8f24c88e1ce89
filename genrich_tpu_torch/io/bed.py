"""Exclusion-region loading (-E BED files) and per-chrom merge.

Mirrors loadBED (Genrich.c:5183-5238) and saveXBed (Genrich.c:1141-1206):
-E accepts comma-separated BED files; per chromosome, intervals are
insertion-sorted by start, clamped to the chromosome length (with
warnings), and overlapping/adjacent intervals are merged.
"""

from __future__ import annotations

import sys
from typing import List, Tuple

from ..errors import ERRBED, ERRINT, warn, fatal
from . import files


def load_bed(x_file: str) -> List[Tuple[str, int, int]]:
    """Load exclusion intervals from comma-separated BED file(s)."""
    out: List[Tuple[str, int, int]] = []
    for filename in [f for f in x_file.replace(",", " ").split() if f]:
        stream, _gz = files.open_read(filename)
        for raw in stream:
            line = raw.decode("utf-8", "replace")
            fields = line.rstrip("\n").split("\t")
            if not fields or fields[0] == "":
                raise fatal(line, ERRBED)
            if len(fields) < 3:
                raise fatal(line, ERRBED)
            name = fields[0]
            try:
                pos0 = int(fields[1], 10)
            except ValueError:
                raise fatal(fields[1], ERRINT)
            try:
                pos1 = int(fields[2], 10)
            except ValueError:
                raise fatal(fields[2], ERRINT)
            if pos1 <= pos0 or pos0 < 0 or pos1 < 0:
                raise fatal(f"{name}, {pos0} - {pos1}", ERRBED)
            out.append((name, pos0, pos1))
        stream.close()
    return out


def save_xbed(name: str, length: int, xbed: List[Tuple[str, int, int]],
              verbose: bool) -> List[int]:
    """saveXBed: flat [s0,e0,s1,e1,...] for one chromosome, merged.

    Matches the reference's insertion order (stable by start; equal
    starts keep earlier-inserted interval first... the reference inserts
    at the first slot with b.start <= existing start, i.e. a new equal
    start goes *before* the old one) and merge rule (overlap when
    start <= previous end, including adjacency).
    """
    bed: List[int] = []
    for (bname, p0, p1) in xbed:
        if bname != name:
            continue
        if p0 >= length:
            if verbose:
                warn(f"Warning! BED interval ({bname}, {p0} - {p1}) ignored\n")
                warn(f"  - located off end of reference {name} "
                     f"(length {length})\n")
            continue
        # insertion sort by start pos (new goes before equal starts)
        j = 0
        while j < len(bed) and not (p0 <= bed[j]):
            j += 2
        bed[j:j] = [p0, p1]

    # merge overlapping intervals (and clamp ends past chrom length)
    i = 0
    while i < len(bed):
        if bed[i + 1] > length:
            if verbose:
                warn(f"Warning! BED interval ({name}, {bed[i]} - {bed[i+1]}) "
                     f"extends past end of ref.\n  - edited to "
                     f"({name}, {bed[i]} - {length})\n")
            bed[i + 1] = length
        if i and bed[i] <= bed[i - 1]:
            if bed[i + 1] > bed[i - 1]:
                bed[i - 1] = bed[i + 1]
            del bed[i:i + 2]
        else:
            i += 2
    return bed
