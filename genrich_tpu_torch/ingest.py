"""Native ingest that loads on the host the port runs on.

``genrich_tpu``'s C++ ingest (``native/ingest.cpp``, bound by
``genrich_tpu.ingest.native``) is committed as a prebuilt
``native/libgenrich_ingest.so``, which links whatever compression
libraries the machine that built it had (libdeflate among them).  On a
host without them the library does not load, and the pipeline silently
parses with the Python reader, some fifty times slower.

``ensure_native()`` keeps the committed library when it loads.  When it
does not, it builds ``native/ingest.cpp`` with the repo's own Makefile
(which drops libdeflate where the host lacks it) into the git-ignored
``genrich_tpu_torch/_build/``, keyed by a hash of ``ingest.cpp`` and
the Makefile, and points ``genrich_tpu.ingest.native._SO`` at it before
the first load.  Nothing is written into ``native/``.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import tempfile
import time
from pathlib import Path
from typing import Dict

from .kernels import BUILD_DIR

NATIVE_DIR = Path(__file__).resolve().parent.parent / "native"

INFO: Dict[str, object] = {}


def build_native(build_dir) -> Dict[str, object]:
    """Build the ingest library into ``build_dir`` (cached by hash).

    Returns {"path", "seconds", "cached", "libdeflate"}; raises
    RuntimeError if ``make`` fails.
    """
    h = hashlib.sha256()
    for name in ("ingest.cpp", "Makefile"):
        h.update((NATIVE_DIR / name).read_bytes())
    build_dir = Path(build_dir)
    so = build_dir / f"libgenrich_ingest_{h.hexdigest()[:16]}.so"
    stamp = so.with_suffix(".flags")
    if so.exists():
        return {"path": str(so), "seconds": 0.0, "cached": True,
                "libdeflate": stamp.exists()
                and "-DUSE_LIBDEFLATE" in stamp.read_text()}
    build_dir.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix=".so", dir=build_dir)
    os.close(fd)
    os.unlink(tmp)                     # make builds a missing target
    t0 = time.perf_counter()
    r = subprocess.run(["make", "-C", str(NATIVE_DIR), f"TARGET={tmp}"],
                       capture_output=True, text=True)
    secs = time.perf_counter() - t0
    if r.returncode != 0 or not os.path.exists(tmp):
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise RuntimeError(f"make of native/ingest.cpp failed "
                           f"({r.returncode}): {r.stderr.strip()[-500:]}")
    stamp.write_text(r.stdout)
    os.replace(tmp, so)
    return {"path": str(so), "seconds": secs, "cached": False,
            "libdeflate": "-DUSE_LIBDEFLATE" in r.stdout}


def ensure_native() -> Dict[str, object]:
    """Make ``genrich_tpu.ingest.native`` load a library on this host.

    Returns {"path", "built", ...} (the build's info when it built);
    raises RuntimeError when the committed library does not load and
    the build fails.  Idempotent within a process.
    """
    from genrich_tpu.ingest import native
    if INFO.get("path") == native._SO:
        return INFO
    try:
        ctypes.CDLL(native._SO)
        INFO.clear()
        INFO.update(path=native._SO, built=False)
        return INFO
    except OSError as e:
        committed_error = str(e)
    info = build_native(BUILD_DIR)
    ctypes.CDLL(info["path"])
    native._SO = info["path"]
    native._lib = None
    INFO.clear()
    INFO.update(info, built=True, committed_error=committed_error)
    return INFO
