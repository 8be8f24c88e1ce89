"""Host allocator tuning for genome-scale array churn.

The numeric pipeline allocates and frees hundreds of multi-hundred-MB
numpy temporaries per run (event sorts, cumulative sums, RLE
compaction).  glibc serves any block over its mmap threshold (<= 32 MB
by default) with a fresh ``mmap`` and returns it with ``munmap`` on
free, so every such temporary pays full page-population cost on first
touch — measured at ~10 us/page on this class of VM, i.e. ~2.5 s per
GB of temporary traffic, several times the arithmetic it feeds.  (The
reference never sees this: its dense per-base diff arrays are
allocated once per chromosome and swept in place, Genrich.c:2547-2555.)

Raising the mmap/trim thresholds keeps big blocks on the persistent
heap, so pages fault in once per process instead of once per
temporary.  Measured on the 24.4M-record MEMBENCH workload this cuts
the exact engine's wall time ~30% end-to-end (pileup phase 10.8 s ->
7.0 s, dedup 9.3 s -> 5.8 s) with byte-identical output.  The native
ingest library's own arenas (hugepage-backed above a few MB) get the
same treatment for their growth reallocs, which also flow through
malloc.

Peak RSS is unchanged (the heap high-water mark is the same working
set); steady-state RSS between phases is higher because freed blocks
stay mapped — the right trade for a batch analysis or a resident
``--serve`` process, where re-use is the point.

``mallopt`` is glibc-specific; on other libcs the calls are skipped.
"""

from __future__ import annotations

import ctypes

_M_TRIM_THRESHOLD = -1      # glibc malloc.h
_M_MMAP_THRESHOLD = -3

_done = False

# Measured dead ends on this VM class, so nobody retries them: THP
# for the heap (madvise [heap] MADV_HUGEPAGE, or MADV_COLLAPSE on the
# dedup stores) makes first-touch SLOWER here (sys 8 s -> 14 s on the
# 24M-record run) — the host's 2 MB fault path stalls on compaction.
# The win is purely keeping blocks mapped (the thresholds below).


def tune_malloc(threshold: int = 1 << 30) -> bool:
    """Raise glibc's mmap/trim thresholds (idempotent, best-effort).

    Returns True when both mallopt calls succeeded.  Call early:
    mallopt only affects allocations made after it.
    """
    global _done
    if _done:
        return True
    try:
        libc = ctypes.CDLL(None, use_errno=True)
        ok = (libc.mallopt(_M_MMAP_THRESHOLD, threshold) == 1
              and libc.mallopt(_M_TRIM_THRESHOLD, threshold) == 1)
    except (OSError, AttributeError):
        return False
    _done = ok
    return ok
