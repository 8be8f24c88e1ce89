"""Host ingest: SAM/BAM records to per-chromosome fragment events.

``ensure_native()`` makes the C++ ingest library (``native.py``) load
on this host before a run, building it when the committed one does not.
"""

from .native import ensure_native

__all__ = ["ensure_native"]
