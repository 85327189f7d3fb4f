"""Frozen writers of the benchmark's inputs: BGZF BAM with its BAI index,
and FASTA.

The counterparts of the program's ``io/bam.py::BamWriter`` and
``build_bai`` (the same record layout, bins and 16 kb linear index), kept
here so that a later change to the program's writer cannot change the
inputs.  The index is made from the virtual offsets recorded while the
records are laid out, not by parsing the file back; blocks are compressed
on a few threads (zlib lets go of the interpreter lock).
"""

from __future__ import annotations

import struct
import zlib
from concurrent.futures import ThreadPoolExecutor

import numpy as np

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000")
BLOCK = 65_280                 # uncompressed bytes a BGZF block
_CODE_TO_NIB = np.array([1, 2, 4, 8, 15], np.uint8)   # A C G T N
_LINE = np.frombuffer(b"ACGTN", np.uint8)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], bool)


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    for shift, base in ((14, 4681), (17, 585), (20, 73), (23, 9), (26, 1)):
        if beg >> shift == end >> shift:
            return base + (beg >> shift)
    return 0


def _block(data: bytes, level: int) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    header = struct.pack("<4BI2BH2B2H", 0x1F, 0x8B, 0x08, 0x04, 0, 0, 0xFF,
                         6, 0x42, 0x43, 2, len(comp) + 25)
    return header + comp + struct.pack("<II", zlib.crc32(data), len(data))


def ref_end(pos: int, cigar: np.ndarray) -> int:
    return pos + int(cigar[CONSUMES_REF[cigar[:, 0]], 1].sum())


def encode(ref_id: int, name: str, pos: int, cigar: np.ndarray,
           seq: np.ndarray, end: int) -> bytes:
    """One BAM record: flag 0, MAPQ 60, qualities 40, no tags."""
    nb = name.encode("ascii") + b"\x00"
    cig = ((cigar[:, 1].astype(np.uint32) << 4)
           | cigar[:, 0].astype(np.uint32)).astype("<u4")
    n = len(seq)
    nib = _CODE_TO_NIB[seq]
    if n % 2:
        nib = np.concatenate([nib, np.zeros(1, np.uint8)])
    packed = (nib[0::2] << 4) | nib[1::2]
    body = struct.pack("<iiBBHHHiiii", ref_id, pos, len(nb), 60,
                       reg2bin(pos, max(end, pos + 1)), len(cig), 0, n,
                       -1, -1, 0)
    body += nb + cig.tobytes() + packed.tobytes() + b"\x28" * n
    return struct.pack("<i", len(body)) + body


def write_bam(path: str, chroms: list[tuple[str, int]], records,
              level: int = 6, threads: int = 4) -> int:
    """``records``: (ref_id, name, pos, cigar, seq) in coordinate order.
    Writes ``path`` and ``path + ".bai"``; returns the BAM's bytes."""
    text = ("@HD\tVN:1.6\tSO:coordinate\n"
            + "".join(f"@SQ\tSN:{n}\tLN:{l}\n" for n, l in chroms)).encode()
    buf = bytearray(b"BAM\x01" + struct.pack("<i", len(text)) + text
                    + struct.pack("<i", len(chroms)))
    for n, l in chroms:
        nb = n.encode() + b"\x00"
        buf += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
    spans = []                                   # ref_id, beg, end, u0, u1
    for ref_id, name, pos, cigar, seq in records:
        end = ref_end(pos, cigar)
        u0 = len(buf)
        buf += encode(ref_id, name, pos, cigar, seq, end)
        spans.append((ref_id, pos, max(end, pos + 1), u0, len(buf)))
    data = bytes(buf)
    del buf
    pieces = [data[i:i + BLOCK] for i in range(0, len(data), BLOCK)]
    with ThreadPoolExecutor(threads) as ex:
        blocks = list(ex.map(lambda p: _block(p, level), pieces))
    coff = np.concatenate([[0], np.cumsum([len(b) for b in blocks])])
    with open(path, "wb") as f:
        for b in blocks:
            f.write(b)
        f.write(BGZF_EOF)

    def voff(u: int) -> int:
        k = u // BLOCK
        if k == len(blocks):          # the end of the last block
            return int(coff[k - 1]) << 16 | (u - (k - 1) * BLOCK)
        return int(coff[k]) << 16 | (u - k * BLOCK)

    _write_bai(path + ".bai", chroms, [(r, b, e, voff(u0), voff(u1))
                                       for r, b, e, u0, u1 in spans])
    return int(coff[-1]) + len(BGZF_EOF)


def _write_bai(path: str, chroms, recs) -> None:
    """Bins with one chunk per run of consecutive records in a bin, and the
    16 kb linear index (the least offset of a record over each window,
    gaps filled from the left), as ``build_bai`` lays them out."""
    out = bytearray(b"BAI\x01" + struct.pack("<i", len(chroms)))
    for rid, (_, length) in enumerate(chroms):
        bins: dict[int, list[list[int]]] = {}
        n_intv = (length >> 14) + 1
        ioff = [0] * n_intv
        for r, beg, end, v0, v1 in recs:
            if r != rid:
                continue
            ch = bins.setdefault(reg2bin(beg, end), [])
            if ch and ch[-1][1] == v0:
                ch[-1][1] = v1
            else:
                ch.append([v0, v1])
            for w in range(beg >> 14, min(((end - 1) >> 14) + 1, n_intv)):
                if ioff[w] == 0 or v0 < ioff[w]:
                    ioff[w] = v0
        last = 0
        for w in range(n_intv):
            if ioff[w] == 0:
                ioff[w] = last
            else:
                last = ioff[w]
        out += struct.pack("<i", len(bins))
        for b, chunks in sorted(bins.items()):
            out += struct.pack("<Ii", b, len(chunks))
            for c0, c1 in chunks:
                out += struct.pack("<QQ", c0, c1)
        out += struct.pack("<i", n_intv) + struct.pack(f"<{n_intv}Q", *ioff)
    with open(path, "wb") as f:
        f.write(bytes(out))


def write_fasta(path: str, seqs: list[tuple[str, np.ndarray]],
                width: int = 60) -> None:
    with open(path, "wb") as f:
        for name, codes in seqs:
            f.write(f">{name}\n".encode())
            s = _LINE[codes]
            full = len(s) // width * width
            if full:
                lines = np.concatenate(
                    [s[:full].reshape(-1, width),
                     np.full((full // width, 1), ord("\n"), np.uint8)], 1)
                f.write(lines.tobytes())
            if len(s) > full:
                f.write(s[full:].tobytes() + b"\n")
