"""File I/O: gzip autodetection, BAM magic check, stdin/stdout handling.

Mirrors openRead/openWrite/checkBAM (Genrich.c:5070-5181): input
compression is detected from the 0x1F 0x8B magic (gzip on stdin is an
error, ERRGZIP); gzip outputs get a '.gz' suffix appended unless already
present (or the path is '-' or /dev/null); output names may not start
with '-' (except '-' itself).
"""

from __future__ import annotations

import gzip
import io
import sys
import zlib

from ..errors import ERRGZIP, ERRNAME, ERROPEN, ERROPENW, fatal

GZEXT = ".gz"


class _TolerantGz(io.RawIOBase):
    """gzip stream that reads truncation/corruption as EOF.

    zlib's gzread (the reference's input layer, Genrich.c:4983-5068)
    returns a short read on a truncated or CRC-corrupt stream; the
    record parsers then raise ERRBAM/ERRSAM.  Python's gzip module
    raises instead, so translate those exceptions into EOF to keep
    the error surface identical.
    """

    def __init__(self, gz):
        self._gz = gz
        self._dead = False

    def readable(self) -> bool:
        return True

    def readinto(self, b) -> int:
        if self._dead:
            return 0
        try:
            data = self._gz.read(len(b))
        except (EOFError, zlib.error, gzip.BadGzipFile):
            self._dead = True
            return 0
        b[:len(data)] = data
        return len(data)


def open_read(path: str):
    """Open for reading with gzip autodetect.

    Returns (stream, is_gzip); stream yields bytes.
    """
    if path == "-":
        stream = sys.stdin.buffer
        head = stream.peek(2)[:2] if hasattr(stream, "peek") else b""
        if len(head) < 2:
            # mirror: EOF while checking magic -> ERROPEN
            if head[:2] == b"\x1f\x8b":
                raise fatal("", ERRGZIP)
        if head[:2] == b"\x1f\x8b":
            raise fatal("", ERRGZIP)
        return stream, False
    try:
        raw = open(path, "rb")
    except OSError:
        raise fatal(path, ERROPEN)
    head = raw.read(2)
    if len(head) < 2:
        # reference: fgetc EOF during magic check -> ERROPEN
        raw.close()
        raise fatal(path, ERROPEN)
    raw.seek(0)
    if head == b"\x1f\x8b":
        gz = _TolerantGz(gzip.GzipFile(fileobj=raw))
        return io.BufferedReader(gz), True
    return raw, False


def check_bam(stream) -> bool:
    """checkBAM (Genrich.c:5104-5126): peek for the 'BAM\\1' magic.

    Only meaningful on gzip-compressed streams (BAM is BGZF).  Uses
    peek() so the stream is not consumed on a miss.
    """
    head = stream.peek(4)[:4]
    if head == b"BAM\x01":
        stream.read(4)
        return True
    return False


def resolve_out_path(path: str, gz: bool) -> str:
    """The on-disk name openWrite would use (.gz suffix handling)."""
    if gz and path != "-" and path != "/dev/null" \
            and not path.endswith(GZEXT):
        return path + GZEXT
    return path


def open_write(path: str, gz: bool):
    """openWrite (Genrich.c:5072-5102). Returns a text-mode stream."""
    if path.startswith("-") and len(path) > 1:
        raise fatal(path, ERRNAME)
    if gz:
        if path == "-":
            return gzip.open(sys.stdout.buffer, "wt", compresslevel=6)
        if not (path.endswith(GZEXT) or path == "/dev/null"):
            path = path + GZEXT
        try:
            return gzip.open(path, "wt", compresslevel=6)
        except OSError:
            raise fatal(path, ERROPENW)
    if path == "-":
        return sys.stdout
    try:
        return open(path, "w")
    except OSError:
        raise fatal(path, ERROPENW)
