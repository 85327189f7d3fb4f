"""Self-contained BAM/BGZF/BAI reader-writer (no pysam, no htslib).

Replaces the reference's samtools/pysam plumbing (`1_crop_bam.py:90-91` region
cropping, pysam fetch loops in the signature extractors) with an in-process
decoder that yields numpy-backed alignment records ready for uint8 device
tiling.  Supports:

- BGZF block (de)compression incl. the EOF marker block
- BAM header + reference dictionary
- full record parse: flag/pos/mapq/CIGAR/4-bit seq/qual/tags (incl. SA, HP, PS)
- BAI random access (binning + linear index) with linear-scan fallback
- BAM writing (used by the test-data simulator and the region cropper)
"""

from __future__ import annotations

import os
import struct
import zlib
from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu_torch.ops import encode as enc

# BAM CIGAR op codes
CMATCH, CINS, CDEL, CREF_SKIP, CSOFT_CLIP, CHARD_CLIP, CPAD, CEQUAL, CDIFF = range(9)
_CIGAR_CHARS = "MIDNSHP=X"
_CIGAR_CODE = {c: i for i, c in enumerate(_CIGAR_CHARS)}
CONSUMES_QUERY = np.array([1, 1, 0, 0, 1, 0, 0, 1, 1], dtype=bool)
CONSUMES_REF = np.array([1, 0, 1, 1, 0, 0, 0, 1, 1], dtype=bool)

# flags
FLAG_PAIRED = 0x1
FLAG_UNMAPPED = 0x4
FLAG_REVERSE = 0x10
FLAG_SECONDARY = 0x100
FLAG_DUP = 0x400
FLAG_SUPPLEMENTARY = 0x800

_SEQ_NT16 = "=ACMGRSVTWYHKDBN"
# map 4-bit nibble -> our uint8 code (A0 C1 G2 T3 else N)
_NIB_TO_CODE = np.full(16, enc.N, dtype=np.uint8)
for _i, _ch in enumerate(_SEQ_NT16):
    if _ch in "ACGT":
        _NIB_TO_CODE[_i] = "ACGT".index(_ch)
_CODE_TO_NIB = np.array([1, 2, 4, 8, 15, 15], dtype=np.uint8)  # A C G T N PAD->N


# ---------------------------------------------------------------------------
# BGZF
# ---------------------------------------------------------------------------

BGZF_EOF = bytes.fromhex(
    "1f8b08040000000000ff0600424302001b0003000000000000000000"
)


def _bgzf_compress_block(data: bytes, level: int = 6) -> bytes:
    co = zlib.compressobj(level, zlib.DEFLATED, -15)
    comp = co.compress(data) + co.flush()
    # total block size = header(18) + comp + footer(8); field stores total - 1
    bsize = len(comp) + 25
    header = struct.pack(
        "<4BI2BH2B2H",
        0x1F, 0x8B, 0x08, 0x04,  # gzip magic + FLG.FEXTRA
        0,                        # MTIME
        0, 0xFF,                  # XFL, OS
        6,                        # XLEN
        0x42, 0x43,               # 'BC'
        2,                        # SLEN
        bsize,                    # BSIZE - 1
    )
    footer = struct.pack("<II", zlib.crc32(data) & 0xFFFFFFFF, len(data))
    return header + comp + footer


class BgzfReader:
    """Decompress a BGZF file with virtual-offset addressing."""

    def __init__(self, path: str):
        self.path = path
        import mmap
        self._f = open(path, "rb")
        try:
            # mmap keeps resident memory proportional to the touched pages,
            # not the whole compressed BAM (WGS BAMs are tens of GB)
            self.raw = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        except (ValueError, OSError):   # empty file or mmap-less FS
            self.raw = self._f.read()
        self._block_cache: dict[int, bytes] = {}

    def block_at(self, coffset: int) -> tuple[bytes, int]:
        """Decompress block starting at compressed offset; returns (data, next_coffset)."""
        raw = self.raw
        if coffset >= len(raw):
            return b"", coffset
        cached = self._block_cache.get(coffset)
        xlen = struct.unpack_from("<H", raw, coffset + 10)[0]
        # scan extra subfields for BC
        p = coffset + 12
        bsize = None
        end_extra = p + xlen
        while p < end_extra:
            si1, si2, slen = struct.unpack_from("<BBH", raw, p)
            if si1 == 0x42 and si2 == 0x43:
                bsize = struct.unpack_from("<H", raw, p + 4)[0] + 1
            p += 4 + slen
        if bsize is None:
            raise ValueError("not a BGZF block (missing BC subfield)")
        next_off = coffset + bsize
        if cached is not None:
            return cached, next_off
        cdata_start = coffset + 12 + xlen
        cdata_end = next_off - 8
        data = zlib.decompress(raw[cdata_start:cdata_end], -15)
        if len(self._block_cache) < 512:
            self._block_cache[coffset] = data
        return data, next_off

    def read_all(self) -> bytes:
        chunks = []
        off = 0
        while off < len(self.raw):
            data, off = self.block_at(off)
            chunks.append(data)
        return b"".join(chunks)

    def stream_from(self, voffset: int):
        """Generator of decompressed bytes starting at a BGZF virtual offset."""
        coffset = voffset >> 16
        uoffset = voffset & 0xFFFF
        off = coffset
        first = True
        while off < len(self.raw):
            data, off = self.block_at(off)
            if first:
                data = data[uoffset:]
                first = False
            if data:
                yield data


class BgzfWriter:
    def __init__(self, path: str, level: int = 6):
        self.f = open(path, "wb")
        self.level = level
        self.buf = bytearray()

    def write(self, data: bytes):
        self.buf += data
        while len(self.buf) >= 65000:
            self._flush_block(self.buf[:65000])
            del self.buf[:65000]

    def _flush_block(self, data):
        self.f.write(_bgzf_compress_block(bytes(data), self.level))

    def close(self):
        if self.buf:
            self._flush_block(self.buf)
            self.buf = bytearray()
        self.f.write(BGZF_EOF)
        self.f.close()


# ---------------------------------------------------------------------------
# records
# ---------------------------------------------------------------------------


@dataclass
class BamRecord:
    name: str
    flag: int
    ref_id: int
    pos: int                      # 0-based leftmost ref coordinate
    mapq: int
    cigar: np.ndarray             # (n_ops, 2) int32 [op_code, length]
    seq: np.ndarray               # uint8 codes, query order (as stored: fwd strand of ref)
    qual: np.ndarray              # uint8 phred, 0xFF if absent
    tags: dict = field(default_factory=dict)
    next_ref_id: int = -1
    next_pos: int = -1
    tlen: int = 0
    # reference_end memo: (cigar array ref, ref_len) -- the STRONG
    # reference makes the `is` identity check safe (an id()-keyed memo
    # could false-hit when a reassigned cigar's freed address is reused
    # by a later allocation); independent of pos, correct under
    # dataclasses.replace and cigar reassignment
    _refend_memo: tuple = field(default=(None, 0), repr=False, compare=False)

    @property
    def is_unmapped(self) -> bool:
        return bool(self.flag & FLAG_UNMAPPED)

    @property
    def is_reverse(self) -> bool:
        return bool(self.flag & FLAG_REVERSE)

    @property
    def is_secondary(self) -> bool:
        return bool(self.flag & FLAG_SECONDARY)

    @property
    def is_supplementary(self) -> bool:
        return bool(self.flag & FLAG_SUPPLEMENTARY)

    @property
    def query_length(self) -> int:
        return int(self.seq.shape[0])

    @property
    def reference_end(self) -> int:
        if self.cigar.shape[0] == 0:
            return self.pos
        if self._refend_memo[0] is not self.cigar:
            ref_len = int(self.cigar[CONSUMES_REF[self.cigar[:, 0]], 1].sum())
            self._refend_memo = (self.cigar, ref_len)
        return self.pos + self._refend_memo[1]

    def cigar_string(self) -> str:
        return "".join(f"{int(l)}{_CIGAR_CHARS[int(op)]}" for op, l in self.cigar)


def parse_cigar_string(s: str) -> np.ndarray:
    if s in ("*", ""):
        return np.zeros((0, 2), np.int32)
    ops = []
    n = 0
    for ch in s:
        if ch.isdigit():
            n = n * 10 + int(ch)
        else:
            ops.append((_CIGAR_CODE[ch], n))
            n = 0
    return np.array(ops, dtype=np.int32).reshape(-1, 2)


def _parse_tags(buf: bytes) -> dict:
    tags: dict = {}
    p = 0
    n = len(buf)
    while p + 3 <= n:
        tag = buf[p : p + 2].decode("ascii")
        typ = chr(buf[p + 2])
        p += 3
        if typ == "A":
            tags[tag] = chr(buf[p]); p += 1
        elif typ in "cC":
            tags[tag] = struct.unpack_from("<b" if typ == "c" else "<B", buf, p)[0]; p += 1
        elif typ in "sS":
            tags[tag] = struct.unpack_from("<h" if typ == "s" else "<H", buf, p)[0]; p += 2
        elif typ in "iI":
            tags[tag] = struct.unpack_from("<i" if typ == "i" else "<I", buf, p)[0]; p += 4
        elif typ == "f":
            tags[tag] = struct.unpack_from("<f", buf, p)[0]; p += 4
        elif typ in "ZH":
            end = buf.index(b"\x00", p)
            tags[tag] = buf[p:end].decode("ascii", "replace")
            p = end + 1
        elif typ == "B":
            sub = chr(buf[p]); cnt = struct.unpack_from("<I", buf, p + 1)[0]
            p += 5
            size = {"c": 1, "C": 1, "s": 2, "S": 2, "i": 4, "I": 4, "f": 4}[sub]
            fmt_char = {"c": "b", "C": "B", "s": "h", "S": "H",
                        "i": "i", "I": "I", "f": "f"}[sub]
            tags[tag] = list(struct.unpack_from("<" + fmt_char * cnt, buf, p))
            p += cnt * size
        else:
            break
    return tags


def _encode_tags(tags: dict) -> bytes:
    out = bytearray()
    for tag, val in tags.items():
        t = tag.encode("ascii")
        if isinstance(val, bool):
            out += t + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, (int, np.integer)):
            out += t + b"i" + struct.pack("<i", int(val))
        elif isinstance(val, float):
            out += t + b"f" + struct.pack("<f", val)
        elif isinstance(val, str):
            out += t + b"Z" + val.encode("ascii") + b"\x00"
        else:
            raise TypeError(f"unsupported tag type for {tag}: {type(val)}")
    return bytes(out)


class LazyTagsBamRecord(BamRecord):
    """BamRecord whose tags (and name) decode on first access from raw
    byte slices.

    The batch parser (native/bamparse.cpp) leaves tags as a byte slice;
    most consumers never read them (tags matter only for SA splits and
    HP/PS phasing artifacts), so the ~per-tag Python decode loop is paid
    only where it's used.  Names likewise stay as buffer views until a
    consumer (FP-filter qname pairing, artifact writers) asks."""

    @property
    def tags(self) -> dict:
        t = self.__dict__.get("_tags")
        if isinstance(t, (bytes, memoryview, np.ndarray)):
            t = _parse_tags(bytes(t))
            self.__dict__["_tags"] = t
        return t if t is not None else {}

    @tags.setter
    def tags(self, v):
        self.__dict__["_tags"] = v

    @property
    def name(self) -> str:
        n = self.__dict__.get("_name")
        if not isinstance(n, str):
            n = bytes(n).decode("ascii", "replace")
            self.__dict__["_name"] = n
        return n

    @name.setter
    def name(self, v):
        self.__dict__["_name"] = v


def records_from_batch(data, parsed) -> list[BamRecord]:
    """Materialize LazyTagsBamRecords from native batch-parse columns."""
    fixed, spans, cig_out, seq_out, qual_out, _consumed = parsed
    name_off, name_len = spans["name"]
    cig_off, n_cig = spans["cig"]
    seq_off, l_seq = spans["seq"]
    tags_off, tags_len = spans["tags"]
    rid, pos, mapq, flag = (fixed["ref_id"], fixed["pos"], fixed["mapq"],
                            fixed["flag"])
    nref, npos, tl = fixed["next_ref"], fixed["next_pos"], fixed["tlen"]
    # batch reference_end: one vectorized pass over the shared cigar
    # columns fills every record's memo (the per-record fancy-index sum in
    # BamRecord.reference_end is a finish-path hotspot otherwise)
    ref_contrib = np.where(CONSUMES_REF[cig_out[:, 0]],
                           cig_out[:, 1].astype(np.int64), 0)
    cum = np.zeros(len(ref_contrib) + 1, np.int64)
    np.cumsum(ref_contrib, out=cum[1:])
    ref_lens = cum[cig_off + n_cig] - cum[cig_off]
    out = []
    for i in range(len(pos)):
        co, nc = cig_off[i], n_cig[i]
        so, ls = seq_off[i], l_seq[i]
        to, tn = tags_off[i], tags_len[i]
        cig = cig_out[co: co + nc]
        rec = LazyTagsBamRecord(
            name=data[name_off[i]: name_off[i] + name_len[i]],
            flag=int(flag[i]), ref_id=int(rid[i]), pos=int(pos[i]),
            mapq=int(mapq[i]),
            cigar=cig, seq=seq_out[so: so + ls],
            qual=qual_out[so: so + ls],
            tags=data[to: to + tn] if tn else {},
            next_ref_id=int(nref[i]), next_pos=int(npos[i]),
            tlen=int(tl[i]))
        rec._refend_memo = (cig, int(ref_lens[i]))
        out.append(rec)
    return out


def parse_record(buf: bytes, ref_names: list[str] | None = None) -> BamRecord:
    (ref_id, pos, l_read_name, mapq, _bin, n_cigar, flag, l_seq,
     next_ref, next_pos, tlen) = struct.unpack_from("<iiBBHHHiiii", buf, 0)
    p = 32
    name = buf[p : p + l_read_name - 1].decode("ascii")
    p += l_read_name
    cig_raw = np.frombuffer(buf, dtype="<u4", count=n_cigar, offset=p)
    cigar = np.stack([(cig_raw & 0xF).astype(np.int32), (cig_raw >> 4).astype(np.int32)], axis=1) \
        if n_cigar else np.zeros((0, 2), np.int32)
    p += 4 * n_cigar
    n_seq_bytes = (l_seq + 1) // 2
    packed = np.frombuffer(buf, dtype=np.uint8, count=n_seq_bytes, offset=p)
    nibs = np.empty(n_seq_bytes * 2, dtype=np.uint8)
    nibs[0::2] = packed >> 4
    nibs[1::2] = packed & 0xF
    seq = _NIB_TO_CODE[nibs[:l_seq]]
    p += n_seq_bytes
    qual = np.frombuffer(buf, dtype=np.uint8, count=l_seq, offset=p).copy()
    p += l_seq
    tags = _parse_tags(buf[p:])
    return BamRecord(
        name=name, flag=flag, ref_id=ref_id, pos=pos, mapq=mapq,
        cigar=cigar, seq=seq, qual=qual, tags=tags,
        next_ref_id=next_ref, next_pos=next_pos, tlen=tlen,
    )


def encode_record(rec: BamRecord, n_ref: int) -> bytes:
    name_b = rec.name.encode("ascii") + b"\x00"
    cig = (rec.cigar[:, 1].astype(np.uint32) << 4) | rec.cigar[:, 0].astype(np.uint32)
    l_seq = int(rec.seq.shape[0])
    nibs = _CODE_TO_NIB[rec.seq]
    if l_seq % 2:
        nibs = np.concatenate([nibs, np.zeros(1, np.uint8)])
    packed = ((nibs[0::2] << 4) | nibs[1::2]).astype(np.uint8)
    qual = rec.qual if rec.qual.shape[0] == l_seq else np.full(l_seq, 0xFF, np.uint8)
    body = struct.pack(
        "<iiBBHHHiiii",
        rec.ref_id, rec.pos, len(name_b), rec.mapq,
        reg2bin(rec.pos, max(rec.reference_end, rec.pos + 1)),
        cig.shape[0], rec.flag, l_seq, rec.next_ref_id, rec.next_pos, rec.tlen,
    )
    body += name_b + cig.astype("<u4").tobytes() + packed.tobytes() + qual.tobytes()
    body += _encode_tags(rec.tags)
    return struct.pack("<i", len(body)) + body


# ---------------------------------------------------------------------------
# BAI binning index
# ---------------------------------------------------------------------------


def reg2bin(beg: int, end: int) -> int:
    end -= 1
    if beg >> 14 == end >> 14:
        return ((1 << 15) - 1) // 7 + (beg >> 14)
    if beg >> 17 == end >> 17:
        return ((1 << 12) - 1) // 7 + (beg >> 17)
    if beg >> 20 == end >> 20:
        return ((1 << 9) - 1) // 7 + (beg >> 20)
    if beg >> 23 == end >> 23:
        return ((1 << 6) - 1) // 7 + (beg >> 23)
    if beg >> 26 == end >> 26:
        return ((1 << 3) - 1) // 7 + (beg >> 26)
    return 0


def reg2bins(beg: int, end: int) -> list[int]:
    bins = [0]
    end -= 1
    for shift, base in ((26, 1), (23, 9), (20, 73), (17, 585), (14, 4681)):
        bins.extend(range(base + (beg >> shift), base + (end >> shift) + 1))
    return bins


SLAB_MAX = 4 << 20      # decompressed bytes the native parser takes at once
# the slab of fetch: a region's records lie in a few hundred kB of the stream,
# and a whole-chromosome scan is no slower in slabs of this size
FETCH_SLAB = 256 << 10


class BaiIndex:
    def __init__(self, path: str):
        with open(path, "rb") as f:
            data = f.read()
        if data[:4] != b"BAI\x01":
            raise ValueError("not a BAI file")
        p = 4
        (n_ref,) = struct.unpack_from("<i", data, p); p += 4
        self.refs = []
        for _ in range(n_ref):
            (n_bin,) = struct.unpack_from("<i", data, p); p += 4
            bins: dict[int, list[tuple[int, int]]] = {}
            for _ in range(n_bin):
                bin_id, n_chunk = struct.unpack_from("<Ii", data, p); p += 8
                chunks = []
                for _ in range(n_chunk):
                    beg, end = struct.unpack_from("<QQ", data, p); p += 16
                    chunks.append((beg, end))
                bins[bin_id] = chunks
            (n_intv,) = struct.unpack_from("<i", data, p); p += 4
            ioffs = list(struct.unpack_from(f"<{n_intv}Q", data, p)); p += 8 * n_intv
            self.refs.append((bins, ioffs))

    def chunks_for(self, ref_id: int, beg: int, end: int) -> list[tuple[int, int]]:
        if ref_id < 0 or ref_id >= len(self.refs):
            return []
        bins, ioffs = self.refs[ref_id]
        min_off = 0
        widx = beg >> 14
        if widx < len(ioffs):
            min_off = ioffs[widx]
        chunks = []
        for b in reg2bins(beg, end):
            for c in bins.get(b, ()):
                if c[1] > min_off:
                    chunks.append(c)
        chunks.sort()
        # merge adjacent
        merged: list[list[int]] = []
        for c in chunks:
            if merged and c[0] <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], c[1])
            else:
                merged.append([c[0], c[1]])
        return [(a, b) for a, b in merged]


# ---------------------------------------------------------------------------
# reader / writer
# ---------------------------------------------------------------------------


class BamReader:
    def __init__(self, path: str):
        self.bgzf = BgzfReader(path)
        stream = self.bgzf.stream_from(0)
        buf = bytearray()
        def need(n):
            while len(buf) < n:
                buf.extend(next(stream))
        need(12)
        if bytes(buf[:4]) != b"BAM\x01":
            raise ValueError("not a BAM file")
        (l_text,) = struct.unpack_from("<i", buf, 4)
        need(8 + l_text + 4)
        self.header_text = bytes(buf[8 : 8 + l_text]).rstrip(b"\x00").decode("ascii", "replace")
        p = 8 + l_text
        (n_ref,) = struct.unpack_from("<i", buf, p)
        p += 4
        self.ref_names: list[str] = []
        self.ref_lens: list[int] = []
        for _ in range(n_ref):
            need(p + 4)
            (l_name,) = struct.unpack_from("<i", buf, p); p += 4
            need(p + l_name + 4)
            self.ref_names.append(bytes(buf[p : p + l_name - 1]).decode()); p += l_name
            (l_ref,) = struct.unpack_from("<i", buf, p); p += 4
            self.ref_lens.append(l_ref)
        self._data_start_ubytes = p  # uncompressed offset where records begin
        self.bai: BaiIndex | None = None
        bai_path = path + ".bai"
        if os.path.exists(bai_path):
            self.bai = BaiIndex(bai_path)
        self._rid = {n: i for i, n in enumerate(self.ref_names)}

    def _records_from_stream(self, stream, skip: int = 0, stop=None,
                             slab: int = SLAB_MAX):
        """Yield records from a decompressed-bytes generator.

        Slab-batched through the native parser when available (~8x faster
        than the per-record Python decode; generator semantics -- and thus
        bounded memory + early termination on fetch -- are preserved),
        falling back to the pure-Python loop otherwise.  ``slab``: the
        decompressed bytes parsed at a time."""
        from focalsv_tpu_torch import native
        if native.get_parse_lib() is not None:
            yield from self._records_from_stream_native(stream, skip, slab)
            return
        yield from self._records_from_stream_py(stream, skip)

    def _records_from_stream_native(self, stream, skip: int = 0,
                                    slab: int = SLAB_MAX):
        from focalsv_tpu_torch import native
        buf = bytearray()
        exhausted = False
        while not exhausted and len(buf) < skip + 4:
            try:
                buf.extend(next(stream))
            except StopIteration:
                exhausted = True
        if skip:
            del buf[:skip]
        while buf or not exhausted:
            while len(buf) < slab and not exhausted:
                try:
                    buf.extend(next(stream))
                except StopIteration:
                    exhausted = True
            if not buf:
                return
            data = bytes(buf)
            parsed = native.parse_records_batch(data)
            if parsed is None:
                # distinguish "first record larger than the slab" from
                # CORRUPTION: an invalid length prefix, or inner fields
                # that don't fit the block (the native parser's
                # rec_fields_fit refusal) -- either would otherwise be
                # misread as an incomplete record, silently truncating
                # the stream (or doubling the slab to the 1 GiB cap)
                (sz,) = struct.unpack_from("<i", data, 0) \
                    if len(data) >= 4 else (0,)
                if sz < 32 or sz > (1 << 29):
                    raise ValueError(
                        f"corrupt BAM record length prefix: {sz}")
                if len(data) >= 4 + sz:
                    # the full record is buffered yet the parser refused
                    # it: the variable-length fields are corrupt
                    raise ValueError(
                        "corrupt BAM record: fields exceed block_size")
                if exhausted:
                    return      # trailing partial record
                slab = max(slab * 2, len(buf) * 2)   # record bigger than slab
                if slab > (1 << 30):
                    raise ValueError(
                        "BAM record exceeds the 1 GiB slab cap")
                continue        # need more bytes for the first record
            yield from records_from_batch(data, parsed)
            consumed = parsed[-1]
            del buf[:consumed]
            if exhausted and not buf:
                return

    def _records_from_stream_py(self, stream, skip: int = 0):
        buf = bytearray()
        exhausted = False
        def need(n):
            nonlocal exhausted
            while len(buf) < n and not exhausted:
                try:
                    buf.extend(next(stream))
                except StopIteration:
                    exhausted = True
            return len(buf) >= n
        if skip and not need(skip):
            return
        p = skip
        while True:
            if not need(p + 4):
                return
            (sz,) = struct.unpack_from("<i", buf, p)
            if not need(p + 4 + sz):
                return
            rec = parse_record(bytes(buf[p + 4 : p + 4 + sz]), self.ref_names)
            yield rec
            p += 4 + sz
            if p > 1 << 20:
                del buf[:p]
                p = 0

    def __iter__(self):
        recs = self._iter_native_whole()
        if recs is not None:
            return iter(recs)
        return self._records_from_stream(self.bgzf.stream_from(0), skip=self._data_start_ubytes)

    def _iter_native_whole(self) -> list[BamRecord] | None:
        """Whole-file fast path: native block-parallel BGZF inflate + one
        native record-batch parse (no per-block Python zlib loop).  Returns
        None when unavailable (no compiler, file too large to hold
        uncompressed, or anything malformed -- the streaming path then
        reproduces the exact error semantics)."""
        from focalsv_tpu_torch import native
        raw = self.bgzf.raw
        if native.get_parse_lib() is None or len(raw) > (64 << 20):
            return None
        data = native.bgzf_inflate(raw)
        if data is None:
            return None
        data = data[self._data_start_ubytes:]
        if data.size == 0:
            return []
        parsed = native.parse_records_batch(data)
        if parsed is None or parsed[-1] != data.size:
            return None    # partial/corrupt tail: let the stream path report
        return records_from_batch(data, parsed)

    def fetch(self, chrom: str, start: int = 0, end: int | None = None):
        """Yield mapped records overlapping [start, end) on chrom.

        With an index: ONE forward scan from the start of the first merged
        index chunk, to the first record past the region.  In a
        coordinate-sorted BAM every later chunk starts inside that scan, so
        a scan restarted there (as focalsv_tpu.io.bam does, once per chunk)
        finds only records this one has already yielded; the records and
        their order are the same."""
        rid = self._rid.get(chrom)
        if rid is None:
            return
        if end is None:
            end = self.ref_lens[rid]
        if self.bai is not None:
            chunks = self.bai.chunks_for(rid, start, end)
            if not chunks:
                return
            seen = set()
            stream = self.bgzf.stream_from(chunks[0][0])
            for rec in self._records_from_stream(
                    stream, slab=FETCH_SLAB):
                if rec.ref_id != rid:
                    if rec.ref_id > rid:
                        break
                    continue
                if rec.pos >= end:
                    break
                if rec.reference_end <= start:
                    continue
                key = (rec.name, rec.flag, rec.pos)
                if key in seen:
                    continue
                seen.add(key)
                yield rec
            return
        for rec in self:
            if rec.ref_id == rid and rec.pos < end and rec.reference_end > start:
                yield rec


def ensure_indexed(path: str) -> "BamReader":
    """Open a BAM, building the .bai first if missing (replaces the implicit
    `samtools index` step; avoids O(regions x whole-file) linear fallbacks)."""
    reader = BamReader(path)
    if reader.bai is None:
        try:
            build_bai(path)
            reader = BamReader(path)
        except Exception:
            pass   # unsorted/edge-case BAM: linear-scan fallback still works
    return reader


class BamWriter:
    def __init__(self, path: str, ref_names: list[str], ref_lens: list[int],
                 header_text: str | None = None):
        self.path = path
        self.ref_names = list(ref_names)
        self.ref_lens = list(ref_lens)
        self.w = BgzfWriter(path)
        if header_text is None:
            lines = ["@HD\tVN:1.6\tSO:coordinate"]
            lines += [f"@SQ\tSN:{n}\tLN:{l}" for n, l in zip(ref_names, ref_lens)]
            header_text = "\n".join(lines) + "\n"
        text = header_text.encode("ascii")
        out = b"BAM\x01" + struct.pack("<i", len(text)) + text
        out += struct.pack("<i", len(ref_names))
        for n, l in zip(ref_names, ref_lens):
            nb = n.encode("ascii") + b"\x00"
            out += struct.pack("<i", len(nb)) + nb + struct.pack("<i", l)
        self.w.write(out)

    def write(self, rec: BamRecord):
        self.w.write(encode_record(rec, len(self.ref_names)))

    def close(self):
        self.w.close()


def build_bai(bam_path: str, out_path: str | None = None) -> str:
    """Build a .bai index by scanning the BAM (replaces `samtools index`)."""
    out_path = out_path or bam_path + ".bai"
    bgzf = BgzfReader(bam_path)
    # walk blocks while tracking virtual offsets of each record
    reader = BamReader(bam_path)
    # Recompute record virtual offsets: iterate blocks manually.
    records: list[tuple[int, int, int, int]] = []  # (ref_id, beg, end, voff)
    coffs = [0]
    datas = []
    off = 0
    while off < len(bgzf.raw):
        data, off2 = bgzf.block_at(off)
        datas.append(data)
        coffs.append(off2)
        off = off2
    # mapping from uncompressed global offset -> virtual offset
    blob = b"".join(datas)
    block_starts_u = np.cumsum([0] + [len(d) for d in datas])

    def voff_of(uoff: int) -> int:
        bi = int(np.searchsorted(block_starts_u, uoff, side="right") - 1)
        return (coffs[bi] << 16) | (uoff - int(block_starts_u[bi]))

    p = reader._data_start_ubytes
    while p + 4 <= len(blob):
        (sz,) = struct.unpack_from("<i", blob, p)
        rec = parse_record(blob[p + 4 : p + 4 + sz], reader.ref_names)
        records.append((rec.ref_id, rec.pos, max(rec.reference_end, rec.pos + 1),
                        voff_of(p)))
        p += 4 + sz
    end_voff = voff_of(p)

    # build per-ref bins + linear index
    out = bytearray(b"BAI\x01")
    out += struct.pack("<i", len(reader.ref_names))
    for rid in range(len(reader.ref_names)):
        recs = [r for r in records if r[0] == rid]
        bins: dict[int, list[tuple[int, int]]] = {}
        n_intv = (reader.ref_lens[rid] >> 14) + 1
        ioff = [0] * n_intv
        for i, (_, beg, rend, voff) in enumerate(recs):
            b = reg2bin(beg, rend)
            nxt = recs[i + 1][3] if i + 1 < len(recs) else end_voff
            bins.setdefault(b, []).append((voff, nxt))
            for w in range(beg >> 14, ((rend - 1) >> 14) + 1):
                if w < n_intv and (ioff[w] == 0 or voff < ioff[w]):
                    ioff[w] = voff
        # fill linear index gaps
        last = 0
        for w in range(n_intv):
            if ioff[w] == 0:
                ioff[w] = last
            else:
                last = ioff[w]
        out += struct.pack("<i", len(bins))
        for b, chunks in sorted(bins.items()):
            out += struct.pack("<Ii", b, len(chunks))
            for cb, ce in chunks:
                out += struct.pack("<QQ", cb, ce)
        out += struct.pack("<i", n_intv)
        out += struct.pack(f"<{n_intv}Q", *ioff)
    with open(out_path, "wb") as f:
        f.write(bytes(out))
    return out_path
