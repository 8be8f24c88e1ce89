"""BED of 'N' homopolymers from a FASTA (findNs.py accessory).

Replicates the reference's findNs.py (findNs.py:45-135) with a
vectorized run scanner: intervals of >= minLen consecutive N/n bases
per sequence, written as BED for feeding back via -E.  The reference's
trailing-run quirk is preserved: a run ending at the sequence end is
reported with end = len(seq)-1 and measured one base short.

Usage: python -m genrich_tpu_torch.tools.find_ns <in.fa[.gz]> <out.bed[.gz]>
       [<minLen>]
"""

from __future__ import annotations

import gzip
import sys
from typing import List, Tuple

import numpy as np


def _open_read(filename: str):
    if filename == "-":
        return sys.stdin
    try:
        if filename.endswith(".gz"):
            return gzip.open(filename, "rt")
        return open(filename, "r")
    except IOError:
        sys.stderr.write(f"Error! Cannot open {filename} for reading\n")
        sys.exit(-1)


def _open_write(filename: str):
    if filename == "-":
        return sys.stdout
    try:
        if filename.endswith(".gz"):
            return gzip.open(filename, "wt")
        return open(filename, "w")
    except IOError:
        sys.stderr.write(f"Error! Cannot open {filename} for writing\n")
        sys.exit(-1)


def n_runs(seq: str, min_len: int) -> List[Tuple[int, int]]:
    """Intervals of >= min_len consecutive Ns (reference semantics)."""
    if not seq:
        return []
    arr = np.frombuffer(seq.encode("ascii", "replace"), np.uint8)
    mask = (arr == ord("N")) | (arr == ord("n"))
    d = np.diff(mask.astype(np.int8))
    starts = list(np.flatnonzero(d == 1) + 1)
    ends = list(np.flatnonzero(d == -1) + 1)
    if mask[0]:
        starts.insert(0, 0)
    out = []
    for k, s in enumerate(starts):
        if k < len(ends):
            e = ends[k]
        else:
            # trailing run: the reference measures/reports one short
            e = len(seq) - 1
        if e - s >= min_len:
            out.append((s, e))
    return out


def run(fin, fout, min_len: int) -> Tuple[int, int]:
    count = pure = 0
    head = ""
    chunks: List[str] = []

    def flush():
        nonlocal count, pure
        if head:
            count += 1
            for (s, e) in n_runs("".join(chunks), min_len):
                fout.write(f"{head}\t{s}\t{e}\n")
                pure += 1

    for line in fin:
        if line.startswith(">"):
            flush()
            head = line.rstrip().split(" ")[0][1:]
            chunks = []
        elif head:
            chunks.append(line.rstrip())
    flush()
    return count, pure


def main(argv=None) -> int:
    args = sys.argv[1:] if argv is None else argv
    if len(args) < 2:
        sys.stderr.write(
            "Usage: python findNs.py  <input>  <output>  [<minLen>]\n"
            "  <input>     Input fasta file\n"
            "  <output>    Output BED file of 'N' homopolymers\n"
            "  <minLen>    Minimum length of Ns (def. 100bp)\n")
        return -1
    fin = _open_read(args[0])
    fout = _open_write(args[1])
    min_len = int(args[2]) if len(args) > 2 else 100
    count, pure = run(fin, fout, min_len)
    if fin is not sys.stdin:
        fin.close()
    if fout is not sys.stdout:
        fout.close()
    sys.stderr.write(f"Total fasta sequences in {args[0]}: {count}\n")
    sys.stderr.write(f"Intervals of Ns (min. {min_len}bp): {pure}\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
