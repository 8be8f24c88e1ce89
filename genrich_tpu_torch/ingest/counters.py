"""Per-file accounting counters (verbose -v output; logCounts parity)."""

from __future__ import annotations

from dataclasses import dataclass, field


@dataclass
class FileCounters:
    """Counters reset per input file (runProgram, Genrich.c:5513-5519)."""

    count: int = 0
    unmapped: int = 0
    paired: int = 0
    single: int = 0
    orphan: int = 0
    paired_pr: int = 0
    single_pr: int = 0
    supp: int = 0
    skipped: int = 0
    low_mapq: int = 0
    sec_pair: int = 0
    sec_single: int = 0
    count_pr: int = 0
    dups_pr: int = 0
    count_dc: int = 0
    dups_dc: int = 0
    count_sn: int = 0
    dups_sn: int = 0
    total_len: float = 0.0  # weighted length of paired fragments (double)
    err_count: int = 0      # capped clamp warnings (saveInterval)
