"""Error/warning system with the reference's 44-entry message table.

Mirrors Genrich.h:97-154 (enum errCode / errMsg[]) and Genrich.c:78-81
(error()).  Errors raise :class:`GenrichError`; the CLI prints
``Error! <msg><table entry>`` to stderr and exits 1, matching the
reference's fail-fast behavior.
"""

from __future__ import annotations

import sys

# enum errCode, Genrich.h:97-106
(
    ERRFILE, ERROPEN, ERROPENW, ERRCLOSE,
    ERRMEM, ERRINT, ERRFLOAT, ERRPARAM, ERREXTEND, ERRATAC,
    ERRPQVAL, ERRASDIFF, ERRMINAUC, ERRMINLEN, ERRMISM,
    ERRINFO, ERRSAM, ERRCHROM, ERRHEAD, ERRBAM, ERRGEN,
    ERREXPT, ERRCHRLEN, ERRCTRL, ERRPOS, ERRSORT, ERRTYPE,
    ERRAUX, ERRBED, ERRLINEAR, ERRINDEX, ERRLOGIDX, ERRLOG,
    ERRISSUE, ERRALNS, ERRPILE, ERRPVAL, ERRARR, ERRARRC,
    ERRDF, ERRALNTYPE, ERRUNGET, ERRGZIP, ERRNAME, ERRCIGAR,
    ERRGENLEN, DEFERR,
) = range(47)

# errMsg[], Genrich.h:107-154 (byte-for-byte)
ERR_MSG = [
    "Need input/output files",
    ": cannot open file for reading",
    ": cannot open file for writing",
    ": cannot close file",
    "Cannot allocate memory",
    ": cannot convert to int",
    ": cannot convert to float",
    ": unknown command-line argument",
    "Extension length must be > 0",
    "ATAC-seq interval length must be > 0",
    "p-/q-value must be in (0,1]",
    "Secondary alignment score threshold must be >= 0.0",
    "Minimum AUC must be >= 0.0",
    "Minimum peak length must be >= 0",
    ": mismatch between sequence length and CIGAR",
    ": no sequence information (SEQ or CIGAR)",
    ": poorly formatted SAM/BAM record",
    ": cannot find reference sequence name in SAM header",
    ": misplaced SAM header line",
    "Cannot parse BAM file",
    "No analyzable genome (length=0)",
    "Experimental sample has no analyzable fragments",
    ": reference sequence has different lengths in BAM/SAM files",
    ": reference sequence missing from control sample(s)",
    ": read aligned beyond reference end",
    "SAM/BAM file not sorted by queryname (samtools sort -n)",
    ": unknown value type in BAM auxiliary field",
    "Poorly formatted BAM auxiliary field",
    ": poorly formatted BED record",
    "Linear template with >2 reads -- not allowed",
    "Unknown index of paired alignment",
    ": cannot find field in header of bedgraph-ish log file",
    "Poorly formatted bedgraph-ish log record",
    "\n  (internal error: please open an Issue on https://github.com/jsh58/Genrich)",
    "Disallowed number of alignments",
    "Invalid pileup value (< 0)",
    "Failure collecting p-values",
    "Failure creating experimental pileup",
    "Failure creating control pileup",
    "Invalid df in pchisq()",
    "Invalid alignment type",
    "Failure in ungetc() call",
    "Cannot pipe in gzip-compressed file (use zcat instead)",
    ": output filename cannot start with '-'",
    ": unknown Op in CIGAR",
    "Genome length must be a positive int",
    "Unknown error",
]


class GenrichError(Exception):
    """Fatal error carrying a reference error code and prefix message."""

    def __init__(self, msg: str, code: int):
        self.msg = msg
        self.code = code
        super().__init__(f"Error! {msg}{ERR_MSG[code]}")

    def render(self) -> str:
        return f"Error! {self.msg}{ERR_MSG[self.code]}"


def fatal(msg: str, code: int) -> GenrichError:
    """Build a GenrichError (callers ``raise fatal(...)``)."""
    return GenrichError(msg, code)


def warn(text: str, file=None) -> None:
    """Print a warning to stderr (reference warnings go to stderr)."""
    print(text, end="", file=file if file is not None else sys.stderr)
