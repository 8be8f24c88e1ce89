"""SAM text parsing (readSAM, Genrich.c:4344-4624).

Field handling, CIGAR arithmetic, AS-score extraction and the
queryname-group state machine replicate the reference, including its
integer-wrap quirks (POS stored as uint32 after the 1-based -> 0-based
shift; FLAG/MAPQ truncated to uint16/uint8) and the 128-char cap on the
remembered read name (MAX_ALNS, Genrich.c:4576).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from ..errors import (ERRCHROM, ERRCIGAR, ERRHEAD, ERRINFO, ERRINT,
                      ERRMISM, ERRSAM, fatal, warn)
from ..params import MAX_ALNS
from ..utils.cfloat import NOSCORE, strtof
from .alnproc import TemplateState, parse_align, process_alns
from .chroms import ChromRegistry, check_sam_header

SAMQUAL = 33
F32 = np.float32


def _get_int(s: str) -> int:
    try:
        return int(s, 10)
    except ValueError:
        raise fatal(s, ERRINT)


def parse_cigar(cigar: str):
    """parseCigar (Genrich.c:4408-4445): (seq length, ref offset)."""
    length = 0
    offset = 0
    pos = 0
    for i, ch in enumerate(cigar):
        if ch < "0" or ch > "9":
            op_len = _get_int(cigar[pos:i])
            if ch in "M=X":
                length += op_len
            elif ch in "IS":
                length += op_len
                offset -= op_len
            elif ch == "D":
                offset += op_len
            elif ch in "NHP":
                pass
            else:
                raise fatal(f"'{ch}'", ERRCIGAR)
            pos = i + 1
    return length, offset


def calc_dist(qname: str, seq: str, cigar: str) -> int:
    """calcDist (Genrich.c:4451-4463): distance to the 3' end."""
    length = 0 if seq == "*" else len(seq)
    offset = 0
    if cigar != "*":
        clen, offset = parse_cigar(cigar)
        if not length:
            length = clen
        elif length != clen:
            raise fatal(qname, ERRMISM)
    elif not length:
        raise fatal(qname, ERRINFO)
    return length + offset


def get_score(extra: Optional[str]):
    """getScore (Genrich.c:4383-4402): first AS:<type>:<val> field."""
    if extra is None:
        return NOSCORE
    for field in extra.split("\t"):
        parts = field.split(":")
        if parts[0] == "AS":
            if len(parts) < 3:
                return NOSCORE
            try:
                return strtof(parts[2])
            except ValueError:
                raise fatal(parts[2], ERRINT + 1)  # ERRFLOAT
    return NOSCORE


def read_sam(stream, registry: ChromRegistry, counters, writer,
             state_ctx, params, ctrl: bool) -> int:
    """Parse a SAM stream; events flow into ``writer``.

    ``state_ctx`` carries (unpair buffer, dedup state) shared handles.
    Returns the record count.
    """
    p = params
    unpair, dedup = state_ctx
    tstate = TemplateState()
    read_name = ""
    past_header = False
    count = 0

    def flush_group():
        process_alns(read_name, tstate, counters, p.single_opt,
                     p.extend_opt, p.extend, p.avg_ext_opt, unpair,
                     p.as_diff, p.atac_opt, p.atac_len5, p.atac_len3,
                     p.atac_adj, writer, p.dups_opt, dedup)

    for raw in stream:
        line = raw.decode("ascii", "replace") if isinstance(
            raw, (bytes, bytearray)) else raw
        if line.startswith("@"):
            if past_header:
                raise fatal(line, ERRHEAD)
            check_sam_header(line, registry, ctrl, p.sort_opt)
            continue
        past_header = True

        line = line.rstrip("\n")
        fields = line.split("\t")
        if not fields or fields[0] == "":
            raise fatal(line, ERRSAM)
        qname = fields[0]
        if len(fields) < 11:
            raise fatal(qname, ERRSAM)
        flag = _get_int(fields[1]) & 0xFFFF
        rname = fields[2]
        pos = (_get_int(fields[3]) - 1) & 0xFFFFFFFF
        mapq = _get_int(fields[4]) & 0xFF
        cigar = fields[5]
        pnext = (_get_int(fields[7]) - 1) & 0xFFFFFFFF
        seq = fields[9]
        qual = fields[10]
        extra = "\t".join(fields[11:]) if len(fields) > 11 else None

        count += 1
        if flag & 0x4:
            counters.unmapped += 1
            continue
        if qname == "*" or rname == "*":
            raise fatal(qname, ERRSAM)
        if flag & 0xE00:
            counters.supp += 1
            continue
        chrom = registry.by_name.get(rname)
        if chrom is None:
            raise fatal(rname, ERRCHROM)
        if mapq < p.min_mapq:
            counters.low_mapq += 1
            continue

        if read_name == "" or qname != read_name:
            if read_name != "":
                flush_group()
            tstate.reset()
            read_name = qname[:MAX_ALNS]

        length = calc_dist(qname, seq, cigar)
        score = get_score(extra)
        if not parse_align(tstate, flag, chrom, pos, length, pnext,
                           counters, p.single_opt, score, p.dups_opt,
                           qual, SAMQUAL) and p.verbose:
            warn(f"Warning! Read {qname} has more than {MAX_ALNS} "
                 f"alignments\n")

    if read_name != "":
        flush_group()
    return count
