"""Synthesize a realistic large ATAC-like BAM (BGZF) for perf runs.

The port's copy of ``scripts/perf_synth.py``: ``synth_bam`` writes the
same bytes for the same arguments, so the BAMs cached in
``.bench_cache/`` keep their names.

The golden tests use tiny inputs; this builds a multi-million-record
queryname-sorted BAM with peak-like clustering, PCR duplicates, and
multimappers so end-to-end timing reflects the reference's published
workload shape (SURVEY.md §6: 146M records, ATAC, -r -j -q).

BGZF framing (SAM spec §4.1): a series of gzip members, each with an
extra subfield BC giving the compressed block size, raw-deflate
payload <= 65280 bytes of uncompressed data, ending with the fixed
28-byte EOF block.  The reference reads BAM through zlib's gzFile,
which transparently concatenates members (Genrich.c:4983), so BGZF
files are valid inputs for both programs.
"""

from __future__ import annotations

import os
import random
import struct
import sys
import zlib

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")


class BgzfWriter:
    def __init__(self, path: str, level: int = 1):
        self.f = open(path, "wb")
        self.level = level
        self.buf = bytearray()

    def write(self, data: bytes) -> None:
        self.buf += data
        while len(self.buf) >= 65280:
            self._flush_block(bytes(self.buf[:65280]))
            del self.buf[:65280]

    def _flush_block(self, payload: bytes) -> None:
        co = zlib.compressobj(self.level, zlib.DEFLATED, -15)
        comp = co.compress(payload) + co.flush()
        bsize = len(comp) + 25
        hdr = struct.pack(
            "<BBBBIBBHBBHH",
            0x1F, 0x8B, 8, 4, 0, 0, 0xFF, 6,
            ord("B"), ord("C"), 2, bsize)
        self.f.write(hdr + comp +
                     struct.pack("<II", zlib.crc32(payload),
                                 len(payload)))

    def close(self) -> None:
        if self.buf:
            self._flush_block(bytes(self.buf))
            self.buf.clear()
        self.f.write(BGZF_EOF)
        self.f.close()


def pack_record(qname: bytes, flag: int, ref: int, pos: int, mapq: int,
                cigar: bytes, n_cigar: int, nref: int, npos: int,
                tlen: int, l_seq: int, seqqual: bytes,
                aux: bytes) -> bytes:
    body = struct.pack(
        "<iiBBHHHiiii", ref, pos, len(qname) + 1, mapq, 4680,
        n_cigar, flag, l_seq, nref, npos, tlen
    ) + qname + b"\x00" + cigar + seqqual + aux
    return struct.pack("<i", len(body)) + body


def synth_bam(path: str, n_pairs: int, seed: int = 7,
              read_len: int = 50, dup_frac: float = 0.12,
              multi_frac: float = 0.05,
              chroms=(("chr1", 60_000_000), ("chr2", 40_000_000),
                      ("chr3", 25_000_000))) -> None:
    rng = random.Random(seed)
    w = BgzfWriter(path)

    text = "@HD\tVN:1.6\tSO:queryname\n" + "".join(
        f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in chroms)
    tb = text.encode()
    hdr = b"BAM\x01" + struct.pack("<i", len(tb)) + tb
    hdr += struct.pack("<i", len(chroms))
    for n, l in chroms:
        nb = n.encode() + b"\x00"
        hdr += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    w.write(hdr)

    cigar = struct.pack("<I", (read_len << 4) | 0)
    # Random seq/qual from pools so the BAM deflates like a real one
    # (~2-3x compression, not 30x from constant strings).  Qual bytes
    # stay in [2, 41] (valid phred, never 0xFF missing-qual).
    seq_len = (read_len + 1) // 2
    seq_pool = bytes(rng.randrange(256) for _ in range(1 << 20))
    qual_pool = bytes(2 + rng.randrange(40) for _ in range(1 << 20))
    seq_max = len(seq_pool) - seq_len
    qual_max = len(qual_pool) - read_len

    def seqqual_rand() -> bytes:
        return (seq_pool[(o := rng.randrange(seq_max)):o + seq_len] +
                qual_pool[(o := rng.randrange(qual_max)):o + read_len])

    # ~120 tight hotspots per chrom: at 1M+ pairs the clustered
    # coverage reaches a few hundred x background, deep enough that
    # BH-corrected q-values pass 0.05 on the 125 Mbp genome (the
    # README example's regime: strong ATAC peaks vs lambda~2.5).
    hotspots = []
    for ci, (_, clen) in enumerate(chroms):
        hotspots += [(ci, clen, rng.randrange(10_000, clen - 10_000))
                     for _ in range(120)]

    def one_pair(qi: int, ci: int, clen: int, p1: int,
                 frag: int = 0) -> int:
        frag = frag or rng.randrange(read_len + 20, 500)
        p2 = min(p1 + frag - read_len, clen - read_len - 1)
        qn = b"q%09d" % qi
        n_aln = 1
        if rng.random() < multi_frac:
            n_aln = rng.choice((2, 2, 3, 4))
        recs = []
        sq = seqqual_rand()
        for a in range(n_aln):
            sec = 0x100 if a else 0
            aux = b"ASi" + struct.pack("<i", -5 * a)
            if a == 0:
                q1, q2 = p1, p2
            else:
                q1 = rng.randrange(0, clen - 600)
                q2 = min(q1 + frag - read_len, clen - read_len - 1)
            recs.append(pack_record(
                qn, 0x63 | sec, ci, q1, 42, cigar, 1, ci, q2,
                q2 + read_len - q1, read_len, sq, aux))
            recs.append(pack_record(
                qn, 0x93 | sec, ci, q2, 42, cigar, 1, ci, q1,
                -(q2 + read_len - q1), read_len, seqqual_rand(), aux))
        w.write(b"".join(recs))
        return frag

    qi = 0
    n_hot = len(hotspots)
    for i in range(n_pairs):
        if rng.random() < 0.6:
            ci, clen, hs = hotspots[rng.randrange(n_hot)]
            p1 = max(0, hs + rng.randrange(-150, 150))
        else:
            ci, clen = rng.randrange(len(chroms)), 0
            clen = chroms[ci][1]
            p1 = rng.randrange(0, clen - 600)
        frag = one_pair(qi, ci, clen, p1)
        qi += 1
        if rng.random() < dup_frac:
            # true PCR duplicate: identical 5' coordinates both ends
            one_pair(qi, ci, clen, p1, frag=frag)
            qi += 1
        if i % 500_000 == 0:
            sys.stderr.write(f"  synth {i}/{n_pairs}\r")
    w.close()
    sys.stderr.write(f"  synth done: {qi} templates, "
                     f"{os.path.getsize(path)/1e6:.0f} MB\n")


if __name__ == "__main__":
    # python -m genrich_tpu_torch.tools.perf_synth N_PAIRS OUT.bam
    n = int(sys.argv[1])
    out = sys.argv[2]
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    synth_bam(out, n)
