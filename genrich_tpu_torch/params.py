"""Command-line parameters with Genrich-compatible semantics.

Mirrors getArgs() (Genrich.c:5718-5827) including validation order,
option-override rules (-q over -p, -x over -w, ATAC disabling -w/-x),
the ATAC length split d -> (d/2, round(d/2.0+0.5)), and the up-front
conversion of the significance threshold to -log10 (float32).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from .errors import (
    ERRATAC, ERREXTEND, ERRFILE, ERRFLOAT, ERRGENLEN, ERRINT,
    ERRASDIFF, ERRMINAUC, ERRMINLEN, ERRPARAM, ERRPQVAL, fatal,
)

# defaults (Genrich.h:29-36)
DEFPVAL = np.float32(0.01)
DEFAUC = np.float32(200.0)
DEFMAXGAP = 100
DEFMINLEN = 0
DEFATAC = 100
ATACADJF = 5
ATACADJR = -5

MAX_ALNS = 128  # Genrich.h:17: max alignments per template / name length
MAX_SIZE = 65520  # Genrich.h:16: line buffer / chunk size


def _get_int(s: str) -> int:
    """getInt (Genrich.c:117-123): strtol base 10, full-string."""
    try:
        return int(s, 10)
    except ValueError:
        raise fatal(s, ERRINT)


def _get_float(s: str) -> np.float32:
    """getFloat (Genrich.c:106-112): strtof."""
    try:
        return np.float32(s)
    except ValueError:
        raise fatal(s, ERRFLOAT)


@dataclass
class Params:
    """Resolved run configuration (post-validation)."""

    in_file: Optional[str] = None       # -t (comma-separated)
    ctrl_file: Optional[str] = None     # -c
    out_file: Optional[str] = None      # -o
    log_file: Optional[str] = None      # -f
    pile_file: Optional[str] = None     # -k
    bed_file: Optional[str] = None      # -b
    dups_file: Optional[str] = None     # -R
    gz_out: bool = False                # -z
    single_opt: bool = False            # -y
    extend_opt: bool = False            # -w
    extend: int = 0
    avg_ext_opt: bool = False           # -x
    atac_opt: bool = False              # -j
    atac_len5: int = DEFATAC            # -d (split in validate())
    atac_len3: int = 0
    atac_adj: bool = True               # cleared by -D
    xchr_list: List[str] = field(default_factory=list)  # -e
    x_file: Optional[str] = None        # -E
    min_mapq: int = 0                   # -m
    as_diff: np.float32 = np.float32(0.0)  # -s
    pqvalue: np.float32 = DEFPVAL       # -p/-q (becomes -log10 in validate())
    qval_opt: bool = False
    min_auc: np.float32 = DEFAUC        # -a
    min_len: int = DEFMINLEN            # -l
    max_gap: int = DEFMAXGAP            # -g
    dups_opt: bool = False              # -r
    peaks_opt: bool = True              # cleared by -X
    peaks_only: bool = False            # -P
    sort_opt: bool = True               # cleared by -S
    genome_len: int = 0                 # -L
    verbose: bool = False               # -v
    engine: str = "exact"        # extension: exact | jax | sharded
    ingest: str = "auto"                # extension: auto | native | python

    def validate(self) -> None:
        """Argument checks in the reference's order (Genrich.c:5775-5817)."""
        if (self.peaks_opt and self.out_file is None) \
                or (self.peaks_only and self.log_file is None) \
                or (not self.peaks_only and self.in_file is None):
            raise fatal("", ERRFILE)
        if self.avg_ext_opt:
            self.single_opt = True
            self.extend_opt = False  # avgExtOpt takes precedence
        if self.extend_opt:
            self.single_opt = True
            if self.extend <= 0:
                raise fatal("", ERREXTEND)
        if self.atac_opt:
            self.avg_ext_opt = self.extend_opt = False
            if self.atac_len5 <= 0:
                raise fatal("", ERRATAC)
            # split atacLen into 5' / 3' parts (Genrich.c:5796-5797)
            self.atac_len3 = int(np.float32(self.atac_len5) / np.float32(2.0)
                                 + np.float32(0.5))
            self.atac_len5 //= 2
        if self.min_len < 0:
            raise fatal("", ERRMINLEN)
        if self.min_auc < 0.0:
            raise fatal("", ERRMINAUC)
        if self.as_diff < 0.0:
            raise fatal("", ERRASDIFF)
        # Genrich.c:5806's ERRGENLEN check is dead code: genomeLen is
        # uint64_t, so -L -5 silently wraps (getLong, Genrich.c:130).
        self.genome_len &= (1 << 64) - 1
        # p/q threshold -> -log10 scale (float32; Genrich.c:5815-5817)
        if self.pqvalue <= np.float32(0.0) or self.pqvalue > np.float32(1.0):
            raise fatal("", ERRPQVAL)
        from .utils.cfloat import log10f
        self.pqvalue = np.float32(-log10f(self.pqvalue))


# option letter -> (attr, kind); kind: str/int/float/flag/special
_OPTS = {
    "t": ("in_file", "str"), "c": ("ctrl_file", "str"),
    "o": ("out_file", "str"), "f": ("log_file", "str"),
    "k": ("pile_file", "str"), "b": ("bed_file", "str"),
    "R": ("dups_file", "str"), "E": ("x_file", "str"),
    "z": ("gz_out", "flag"), "y": ("single_opt", "flag"),
    "x": ("avg_ext_opt", "flag"), "j": ("atac_opt", "flag"),
    "d": ("atac_len5", "int"), "m": ("min_mapq", "int"),
    "s": ("as_diff", "float"), "a": ("min_auc", "float"),
    "l": ("min_len", "int"), "g": ("max_gap", "int"),
    "r": ("dups_opt", "flag"), "P": ("peaks_only", "flag"),
    "v": ("verbose", "flag"),
}
_TAKES_ARG = set("tcofkbREdmspqalgLwe")  # from OPTIONS string Genrich.h:56


def parse_args(argv: List[str]) -> Params:
    """getopt-style parse of Genrich's option set.

    Raises GenrichError on unknown arguments; '-h'/'--help' and
    '-V'/'--version' raise UsageExit handled by the CLI.
    """
    p = Params()
    i = 0
    positional = []
    while i < len(argv):
        arg = argv[i]
        if arg == "--help":
            raise UsageRequested()
        if arg == "--version":
            raise VersionRequested()
        if arg == "--verbose":
            p.verbose = True
            i += 1
            continue
        if arg == "--engine":  # extension flag: exact | jax | sharded
            p.engine = argv[i + 1]
            if p.engine not in ("exact", "jax", "sharded"):
                raise fatal(f"--engine {p.engine}", ERRPARAM)
            i += 2
            continue
        if arg == "--ingest":  # extension flag: auto | native | python
            p.ingest = argv[i + 1]
            if p.ingest not in ("auto", "native", "python"):
                raise fatal(f"--ingest {p.ingest}", ERRPARAM)
            i += 2
            continue
        if not arg.startswith("-") or arg == "-":
            positional.append(arg)
            i += 1
            continue
        # possibly bundled short options; Genrich uses getopt so support
        # "-v -t x" and "-tx" forms
        j = 1
        while j < len(arg):
            c = arg[j]
            if c in _TAKES_ARG:
                if j + 1 < len(arg):
                    val = arg[j + 1:]
                else:
                    i += 1
                    if i >= len(argv):
                        raise fatal(arg, ERRPARAM)
                    val = argv[i]
                _apply(p, c, val)
                break
            elif c == "h":
                raise UsageRequested()
            elif c == "V":
                raise VersionRequested()
            elif c == "v":
                p.verbose = True
            elif c in ("z", "y", "x", "j", "D", "r", "X", "P", "S"):
                _apply_flag(p, c)
            else:
                raise fatal(f"-{c}", ERRPARAM)
            j += 1
        i += 1
    if positional:
        raise fatal(positional[0], ERRPARAM)
    p.validate()
    return p


def _apply_flag(p: Params, c: str) -> None:
    if c == "z":
        p.gz_out = True
    elif c == "y":
        p.single_opt = True
    elif c == "x":
        p.avg_ext_opt = True
    elif c == "j":
        p.atac_opt = True
    elif c == "D":
        p.atac_adj = False
    elif c == "r":
        p.dups_opt = True
    elif c == "X":
        p.peaks_opt = False
    elif c == "P":
        p.peaks_only = True
    elif c == "S":
        p.sort_opt = False


def _apply(p: Params, c: str, val: str) -> None:
    if c == "t":
        p.in_file = val
    elif c == "c":
        p.ctrl_file = val
    elif c == "o":
        p.out_file = val
    elif c == "f":
        p.log_file = val
    elif c == "k":
        p.pile_file = val
    elif c == "b":
        p.bed_file = val
    elif c == "R":
        p.dups_file = val
    elif c == "E":
        p.x_file = val
    elif c == "e":
        # comma-separated chromosome list (saveXChrom, Genrich.c:5701-5713;
        # strtok with ", " treats both ',' and ' ' as delimiters)
        p.xchr_list = [s for s in val.replace(",", " ").split() if s]
    elif c == "w":
        p.extend = _get_int(val)
        p.extend_opt = True
    elif c == "d":
        p.atac_len5 = _get_int(val)
    elif c == "m":
        p.min_mapq = _get_int(val)
    elif c == "s":
        p.as_diff = _get_float(val)
    elif c == "p":
        p.pqvalue = _get_float(val)
    elif c == "q":
        p.pqvalue = _get_float(val)
        p.qval_opt = True
    elif c == "a":
        p.min_auc = _get_float(val)
    elif c == "l":
        p.min_len = _get_int(val)
    elif c == "g":
        p.max_gap = _get_int(val)
    elif c == "L":
        p.genome_len = _get_int(val)


class UsageRequested(Exception):
    pass


class VersionRequested(Exception):
    pass
