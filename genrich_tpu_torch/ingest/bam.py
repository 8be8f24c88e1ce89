"""BAM binary parsing (readBAM/parseBAM, Genrich.c:4626-5068).

Reads BAM (BGZF) through the generic gzip stream exactly like the
reference does (no htslib): little-endian block framing, packed
bin_mq_nl / flag_nc fields, binary CIGAR, and a typed auxiliary-field
walk for the AS score (c/C/s/S/i/I accepted; arrays skipped).
"""

from __future__ import annotations

import struct
from typing import List

import numpy as np

from ..errors import (ERRAUX, ERRBAM, ERRSAM, ERRSORT, ERRTYPE, fatal,
                      warn)
from ..params import MAX_ALNS, MAX_SIZE
from ..utils.cfloat import NOSCORE
from .alnproc import TemplateState, parse_align, process_alns
from .chroms import ChromRegistry

F32 = np.float32
_AUX_SIZE = {"A": 1, "c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4,
             "f": 4}
_AS_PARSE = {"c": (1, True), "C": (1, False), "s": (2, True),
             "S": (2, False), "i": (4, True), "I": (4, False)}


def _read_exact(stream, n: int) -> bytes:
    buf = stream.read(n)
    if len(buf) != n:
        raise fatal("", ERRBAM)
    return buf


def _read_i32(stream, end: bool):
    buf = stream.read(4)
    if len(buf) < 4:
        if end:
            raise fatal("", ERRBAM)
        return None
    return struct.unpack("<i", buf)[0]


def calc_dist_bam(l_seq: int, cigar_ops: np.ndarray) -> int:
    """calcDistBAM (Genrich.c:4697-4709)."""
    length = l_seq
    for c in cigar_ops:
        op = c & 0xF
        op_len = int(c) >> 4
        if op == 1 or op == 4:      # I / S
            length -= op_len
        elif op == 2:               # D
            length += op_len
    return length


def get_bam_score(extra: bytes):
    """getBAMscore (Genrich.c:4751-4821): typed AS aux-field search."""
    n = len(extra)
    i = 0
    while i < n - 4:
        tag = extra[i:i + 2]
        val = chr(extra[i + 2])
        i += 3
        if tag == b"AS":
            if val not in _AS_PARSE:
                raise fatal(f"'{val}'", ERRTYPE)
            size, signed = _AS_PARSE[val]
            return F32(int.from_bytes(extra[i:i + size], "little",
                                      signed=signed))
        if val in _AUX_SIZE:
            i += _AUX_SIZE[val]
        elif val == "Z":
            j = extra.index(b"\x00", i)
            i = j + 1
        elif val == "H":
            j = i
            while extra[j] != 0:
                j += 2
            i = j + 1
        elif val == "B":
            sub = chr(extra[i])
            if sub not in "cCsSiIf":
                raise fatal(f"'{sub}'", ERRTYPE)
            cnt = struct.unpack_from("<i", extra, i + 1)[0]
            i += 1 + 4 + _AUX_SIZE[sub] * cnt
        else:
            raise fatal(f"'{val}'", ERRTYPE)
        if i > n:
            raise fatal("", ERRAUX)
    return NOSCORE


def read_bam(stream, registry: ChromRegistry, counters, writer,
             state_ctx, params, ctrl: bool) -> int:
    """readBAM + parseBAM: header, chrom registry, record loop."""
    p = params
    unpair, dedup = state_ctx

    # --- header (readBAM, Genrich.c:5007-5055; magic consumed by caller)
    l_text = _read_i32(stream, True)
    text = _read_exact(stream, l_text)
    nl = len(text)
    for j, b in enumerate(text):
        if b in (0x0A, 0x00):
            nl = j
            break
    first = text[:nl].decode("ascii", "replace")
    fields = first.split("\t")
    if not fields or fields[0] != "@HD":
        raise fatal("", ERRBAM)
    sort_order = None
    for f in fields[1:]:
        if f.startswith("SO:"):
            sort_order = f[3:]
    if p.sort_opt and sort_order != "queryname":
        raise fatal("", ERRSORT)

    n_ref = _read_i32(stream, True)
    idx: List[int] = []
    for _ in range(n_ref):
        l_name = _read_i32(stream, True)
        if l_name < 1 or l_name > MAX_SIZE:
            raise fatal("", ERRBAM)
        name = _read_exact(stream, l_name)
        if name[-1] != 0:
            raise fatal("", ERRBAM)
        l_ref = _read_i32(stream, True) & 0xFFFFFFFF
        c = registry.save_chrom(name[:-1].decode("ascii", "replace"),
                                l_ref, ctrl)
        idx.append(c.index)

    # --- record loop (parseBAM, Genrich.c:4869-4943)
    tstate = TemplateState()
    read_name = ""
    count = 0

    def flush_group():
        process_alns(read_name, tstate, counters, p.single_opt,
                     p.extend_opt, p.extend, p.avg_ext_opt, unpair,
                     p.as_diff, p.atac_opt, p.atac_len5, p.atac_len3,
                     p.atac_adj, writer, p.dups_opt, dedup)

    while True:
        block_size = _read_i32(stream, False)
        if block_size is None:
            break
        if block_size < 6 * 4 + 2 * 4:
            raise fatal("", ERRBAM)
        block = _read_exact(stream, block_size)

        (ref_id, pos, bin_mq_nl, flag_nc, l_seq, _next_ref,
         next_pos, _tlen) = struct.unpack_from("<8i", block, 0)
        l_read_name = bin_mq_nl & 0xFF
        mapq = (bin_mq_nl >> 8) & 0xFF
        n_cigar_op = flag_nc & 0xFFFF
        flag = (flag_nc >> 16) & 0xFFFF
        off = 32
        qname = block[off:off + l_read_name]
        qname = qname.split(b"\x00", 1)[0].decode("ascii", "replace")
        off += l_read_name
        cigar = np.frombuffer(block, "<u4", n_cigar_op, off)
        off += n_cigar_op * 4
        off += (l_seq + 1) // 2          # packed SEQ (ignored)
        qual = block[off:off + l_seq]
        off += l_seq
        if off > block_size:
            raise fatal("", ERRBAM)
        extra = block[off:]

        count += 1
        if flag & 0x4:
            counters.unmapped += 1
            continue
        if qname == "*" or ref_id < 0 or ref_id >= n_ref \
                or idx[ref_id] < 0 or idx[ref_id] >= len(registry) \
                or pos < 0:
            raise fatal(qname, ERRSAM)
        if flag & 0xE00:
            counters.supp += 1
            continue
        if mapq < p.min_mapq:
            counters.low_mapq += 1
            continue

        if read_name == "" or qname != read_name:
            if read_name != "":
                flush_group()
            tstate.reset()
            read_name = qname[:MAX_ALNS]

        length = calc_dist_bam(l_seq, cigar)
        score = get_bam_score(extra)
        chrom = registry.chroms[idx[ref_id]]
        if not parse_align(tstate, flag, chrom, pos & 0xFFFFFFFF,
                           length, next_pos & 0xFFFFFFFF, counters,
                           p.single_opt, score, p.dups_opt, qual,
                           0) and p.verbose:
            warn(f"Warning! Read {qname} has more than {MAX_ALNS} "
                 f"alignments\n")

    if read_name != "":
        flush_group()
    return count
