"""Native (C++) runtime components, loaded through ctypes.

The libraries are built lazily with g++ at first use into
``build/focalsv_tpu_torch/native/`` at the root of the checkout, never beside
the sources.  A library's name carries a hash of its source and of the
machine that built it (host name, machine id, g++ and C library versions),
so a changed source or a library built on another machine is rebuilt, not
loaded.  Every caller keeps
a pure-Python fallback, so the framework still works where no compiler
exists.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import platform
import subprocess
import threading

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_DIR)), "build",
                         "focalsv_tpu_torch", "native")


@functools.lru_cache(maxsize=None)
def _toolchain() -> bytes:
    """What a built library depends on besides its source: the machine
    (a library links against what that machine has installed) and its
    compiler."""
    try:
        gxx = subprocess.run(["g++", "--version"], capture_output=True,
                             timeout=30).stdout
    except Exception:
        gxx = b"no g++"
    try:
        with open("/etc/machine-id", "rb") as f:
            machine_id = f.read()
    except OSError:
        machine_id = b""
    return gxx + machine_id + repr(
        (platform.node(), platform.machine(), platform.libc_ver())).encode()


def _so_path(stem: str, src: str) -> str:
    digest = hashlib.sha256(_toolchain())
    with open(src, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


def _compile(cmd: list[str], so: str, timeout: int) -> None:
    """Run the g++ command with its output at a private name, then move the
    finished library into place (threads and processes may race here)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so}.{os.getpid()}.tmp"
    try:
        subprocess.run(cmd + ["-o", tmp], check=True, capture_output=True,
                       timeout=timeout)
        os.replace(tmp, so)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


_SRC = os.path.join(_DIR, "chain.cpp")
_SO = _so_path("libfocalsv_native", _SRC)
_SCAN_SRC = os.path.join(_DIR, "bamscan.cpp")
_SCAN_SO = _so_path("libfocalsv_bamscan", _SCAN_SRC)

_lib = None
_tried = False
_scan_lib = None
_scan_tried = False


def _build() -> bool:
    try:
        _compile(["g++", "-O3", "-shared", "-fPIC", _SRC], _SO, 120)
        return True
    except Exception:
        return False


def get_scan_lib():
    """The native BAM scanner library, or None."""
    global _scan_lib, _scan_tried
    if _scan_lib is not None or _scan_tried:
        return _scan_lib
    _scan_tried = True
    if not os.path.exists(_SCAN_SO):
        try:
            _compile(["g++", "-O3", "-shared", "-fPIC", _SCAN_SRC, "-lz"],
                     _SCAN_SO, 180)
        except Exception:
            return None
    try:
        lib = ctypes.CDLL(_SCAN_SO)
        lib.bamscan_run.restype = ctypes.c_int
        lib.bamscan_run.argtypes = [ctypes.c_char_p] + [ctypes.c_int] * 5
        lib.bamscan_n_records.restype = ctypes.c_int64
        lib.bamscan_n_sigs.restype = ctypes.c_int64
        lib.bamscan_seq_blob_len.restype = ctypes.c_int64
        _scan_lib = lib
    except OSError:
        _scan_lib = None
    return _scan_lib


_PARSE_SRC = os.path.join(_DIR, "bamparse.cpp")
_PARSE_SO = _so_path("libfocalsv_bamparse", _PARSE_SRC)
_parse_lib = None
_parse_tried = False


def get_parse_lib():
    """The native batch BAM record parser library, or None."""
    global _parse_lib, _parse_tried
    if _parse_lib is not None or _parse_tried:
        return _parse_lib
    _parse_tried = True
    if not os.path.exists(_PARSE_SO):
        base = ["g++", "-O3", "-shared", "-fPIC", "-pthread", _PARSE_SRC]
        try:   # libdeflate inflate is 2-3x zlib's; fall back when absent
            _compile(base + ["-DHAVE_LIBDEFLATE", "-lz", "-ldeflate"],
                     _PARSE_SO, 120)
        except Exception:
            try:
                _compile(base + ["-lz"], _PARSE_SO, 120)
            except Exception:
                return None
    try:
        lib = ctypes.CDLL(_PARSE_SO)
        u8p = ctypes.POINTER(ctypes.c_uint8)
        i32p = ctypes.POINTER(ctypes.c_int32)
        i64p = ctypes.POINTER(ctypes.c_int64)
        lib.bamparse_count.restype = ctypes.c_int64
        lib.bamparse_count.argtypes = [u8p, ctypes.c_int64,
                                       i64p, i64p, i64p]
        lib.bamparse_fill.restype = ctypes.c_int64
        lib.bamparse_fill.argtypes = (
            [u8p, ctypes.c_int64]
            + [i32p] * 7                       # fixed fields
            + [i64p, i32p] * 4                 # name/cig/seq/tags off+len
            + [i32p, u8p, u8p])                # cig_out, seq_out, qual_out
        lib.tile_spans.restype = ctypes.c_int64
        lib.tile_spans.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                                   ctypes.c_int64, ctypes.c_int64,
                                   i32p, i32p, i64p]
        lib.tile_fill.restype = ctypes.c_int64
        lib.tile_fill.argtypes = [i64p, i32p, i64p, i32p,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, ctypes.c_int64,
                                  ctypes.c_int64, i32p, i32p, u8p,
                                  i32p, i32p, i64p, i32p, u8p]
        lib.tile_delta_count.restype = None
        lib.tile_delta_count.argtypes = [i64p, i32p, i64p, u8p, i32p,
                                         ctypes.c_int64, ctypes.c_int64,
                                         ctypes.c_int64,
                                         i32p, i32p,
                                         i64p, i64p, i64p, i64p]
        lib.tile_delta_fill.restype = None
        lib.tile_delta_fill.argtypes = [i64p, i32p, i64p, u8p, i32p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64,
                                        i32p, i32p,
                                        i32p, i32p, u8p,
                                        i32p, i32p, i32p,
                                        i32p, i32p, i64p, i32p, u8p]
        i8p = ctypes.POINTER(ctypes.c_int8)
        lib.aln_geometry_batch.restype = None
        lib.aln_geometry_batch.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                                           i64p, i64p, i64p, i64p, u8p, u8p]
        lib.cigar_sigs_count.restype = ctypes.c_int64
        lib.cigar_sigs_count.argtypes = [i64p, i32p, i32p, ctypes.c_int64,
                                         ctypes.c_int64, ctypes.c_int64]
        lib.stitch_segments.restype = ctypes.c_int64
        lib.stitch_segments.argtypes = [
            u8p, u8p, ctypes.c_int64,               # sym, covpos, L
            i64p, i64p, i64p, ctypes.c_int64, u8p,  # cuts, ins off/len/seq
            ctypes.c_int64,                         # max_gap
            u8p, ctypes.c_int64,                    # contig_out, cap
            i32p, ctypes.c_int64,                   # ops_out, cap
            i64p, i64p, i64p, ctypes.c_int64,       # seg arrays, cap
            i64p, i64p]                             # out lens
        lib.bgzf_usize.restype = ctypes.c_int64
        lib.bgzf_usize.argtypes = [u8p, ctypes.c_int64]
        lib.bgzf_inflate_all.restype = ctypes.c_int64
        lib.bgzf_inflate_all.argtypes = [u8p, ctypes.c_int64, u8p,
                                         ctypes.c_int64, ctypes.c_int64]
        lib.cigar_sigs_fill.restype = ctypes.c_int64
        lib.cigar_sigs_fill.argtypes = [i64p, i32p, i32p, i32p, i32p, u8p,
                                        ctypes.c_int64, ctypes.c_int64,
                                        ctypes.c_int64,
                                        i8p, i64p, i64p, i32p, i64p, i64p,
                                        i8p, i32p]
        _parse_lib = lib
    except OSError:
        _parse_lib = None
    return _parse_lib


_WRITE_SRC = os.path.join(_DIR, "bamwrite.cpp")
_WRITE_SO = _so_path("libfocalsv_bamwrite", _WRITE_SRC)
_write_lib = None
_write_tried = False
_write_lock = threading.Lock()


def get_write_lib():
    """The native BAM writer library (bamwrite.cpp), or None."""
    global _write_lib, _write_tried
    with _write_lock:    # the region writers of a pool ask at once
        if _write_tried:
            return _write_lib
        _write_tried = True
        if not os.path.exists(_WRITE_SO):
            try:
                _compile(["g++", "-O3", "-shared", "-fPIC", _WRITE_SRC,
                          "-lz"], _WRITE_SO, 120)
            except Exception:
                return None
        try:
            lib = ctypes.CDLL(_WRITE_SO, use_errno=True)
            u8p = ctypes.POINTER(ctypes.c_uint8)
            i32p = ctypes.POINTER(ctypes.c_int32)
            i64p = ctypes.POINTER(ctypes.c_int64)
            lib.bamwrite_records.restype = ctypes.c_int64
            lib.bamwrite_records.argtypes = (
                [ctypes.c_int, u8p, ctypes.c_int64, ctypes.c_int64, i64p]
                + [u8p, i64p, i32p, i64p, u8p, i64p, u8p, i64p, u8p, i64p]
                + [i64p, i64p, ctypes.c_int])
            _write_lib = lib
        except OSError:
            _write_lib = None
        return _write_lib


_BAMWRITE_REFUSED, _BAMWRITE_DEFLATE = -1, -2


def write_bam_records(fd: int, prefix: bytes, fixed, names, name_off,
                      cigar, cig_off, seq, seq_off, qual, qual_off, tags,
                      tag_off, hp, ps, level: int) -> bool | None:
    """bamwrite.cpp's ``bamwrite_records`` on the columns (see there):
    True when the file is written, False when a record was refused and
    nothing written, None when the library is unavailable.  Raises
    RuntimeError when zlib fails (nothing written) and OSError when the
    write fails (part of the file may be written)."""
    lib = get_write_lib()
    if lib is None:
        return None
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    pre = np.frombuffer(prefix, np.uint8)
    P = lambda a, t: a.ctypes.data_as(t)        # noqa: E731
    rc = int(lib.bamwrite_records(
        fd, P(pre, u8p), pre.size, fixed.shape[0], P(fixed, i64p),
        P(names, u8p), P(name_off, i64p), P(cigar, i32p), P(cig_off, i64p),
        P(seq, u8p), P(seq_off, i64p), P(qual, u8p), P(qual_off, i64p),
        P(tags, u8p), P(tag_off, i64p), P(hp, i64p), P(ps, i64p), level))
    if rc == _BAMWRITE_REFUSED:
        return False
    if rc == _BAMWRITE_DEFLATE:
        raise RuntimeError("bamwrite: zlib failed to deflate a block")
    if rc != 0:
        err = ctypes.get_errno()
        raise OSError(err, f"bamwrite: write failed: {os.strerror(err)}")
    return True


def parse_records_batch(data) -> tuple | None:
    """Batch-parse concatenated BAM records -> column arrays, or None.

    Returns (fixed, spans, cig_out, seq_out, qual_out, consumed) where
    fixed is a dict of int32 arrays (ref_id/pos/mapq/flag/next_ref/
    next_pos/tlen), spans a dict of (off, len) arrays for
    name/cigar/seq/tags, and consumed the byte length of the parsed
    complete-record prefix."""
    lib = get_parse_lib()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    n = ctypes.c_int64(buf.size)
    bp = buf.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    tot_cig = ctypes.c_int64(0)
    tot_seq = ctypes.c_int64(0)
    consumed = ctypes.c_int64(0)
    nrec = lib.bamparse_count(bp, n, ctypes.byref(tot_cig),
                              ctypes.byref(tot_seq), ctypes.byref(consumed))
    if nrec <= 0:
        return None
    i32 = lambda: np.empty(nrec, np.int32)        # noqa: E731
    i64 = lambda: np.empty(nrec, np.int64)        # noqa: E731
    fixed = {k: i32() for k in ("ref_id", "pos", "mapq", "flag",
                                "next_ref", "next_pos", "tlen")}
    spans = {k: (i64(), i32()) for k in ("name", "cig", "seq", "tags")}
    cig_out = np.empty((int(tot_cig.value), 2), np.int32)
    seq_out = np.empty(int(tot_seq.value), np.uint8)
    qual_out = np.empty(int(tot_seq.value), np.uint8)
    P = lambda a, t: a.ctypes.data_as(ctypes.POINTER(t))   # noqa: E731
    got = lib.bamparse_fill(
        bp, n,
        *[P(fixed[k], ctypes.c_int32) for k in
          ("ref_id", "pos", "mapq", "flag", "next_ref", "next_pos", "tlen")],
        *[p for k in ("name", "cig", "seq", "tags")
          for p in (P(spans[k][0], ctypes.c_int64),
                    P(spans[k][1], ctypes.c_int32))],
        P(cig_out, ctypes.c_int32), P(seq_out, ctypes.c_uint8),
        P(qual_out, ctypes.c_uint8))
    if got != nrec:
        return None
    return fixed, spans, cig_out, seq_out, qual_out, int(consumed.value)


def bgzf_inflate(raw, n_threads: int = 2) -> np.ndarray | None:
    """Inflate a whole BGZF buffer natively (GIL-free, block-parallel).

    ``raw`` is any buffer of the complete compressed file (bytes / mmap /
    ndarray).  Returns the uncompressed bytes as a uint8 array, or None if
    the native lib is unavailable or the buffer is not clean BGZF (caller
    falls back to the Python block reader)."""
    lib = get_parse_lib()
    if lib is None:
        return None
    buf = np.frombuffer(raw, np.uint8)
    if buf.size < (8 << 20):
        # small files (per-region BAMs): spawning inflate threads would
        # oversubscribe the host when many readers run concurrently
        n_threads = 1
    u8p = ctypes.POINTER(ctypes.c_uint8)
    bp = buf.ctypes.data_as(u8p)
    n = ctypes.c_int64(buf.size)
    usize = lib.bgzf_usize(bp, n)
    if usize < 0:
        return None
    out = np.empty(int(usize), np.uint8)
    got = lib.bgzf_inflate_all(bp, n, out.ctypes.data_as(u8p),
                               ctypes.c_int64(out.size),
                               ctypes.c_int64(n_threads))
    if got != usize:
        return None
    return out


def stitch_segments(sym: np.ndarray, cov: np.ndarray, ins_at: dict,
                    max_gap: int):
    """Native consensus stitch: bit-parity with the Python
    assembly/consensus.py::stitch_contig_segments.  Returns
    (contig, segments) or None when the native lib is unavailable."""
    lib = get_parse_lib()
    if lib is None:
        return None
    sym = np.ascontiguousarray(sym, np.uint8)
    covpos = (np.asarray(cov) > 0).astype(np.uint8)
    L = sym.size
    cuts = sorted(ins_at)
    n_cut = len(cuts)
    cut_pos = np.array(cuts, np.int64)
    seqs = [np.asarray(ins_at[c], np.uint8) for c in cuts]
    ins_len = np.array([s.size for s in seqs], np.int64)
    ins_off = np.zeros(n_cut, np.int64)
    if n_cut:
        np.cumsum(ins_len[:-1], out=ins_off[1:])
    ins_seq = (np.concatenate(seqs) if n_cut else
               np.zeros(0, np.uint8)).astype(np.uint8)
    emit = (sym < 4) & (covpos > 0)
    contig_cap = int(np.count_nonzero(emit)) + int(ins_len.sum()) + 1
    n_runs = int(np.count_nonzero(emit[1:] & ~emit[:-1])) + int(emit[0]) \
        if L else 0
    seg_cap = n_runs + n_cut + 2
    ops_cap = 2 * (n_runs + 1) + 3 * (n_cut + 2) + 2 * seg_cap
    contig_out = np.empty(contig_cap, np.uint8)
    ops_out = np.empty((ops_cap, 2), np.int32)
    seg_t0 = np.empty(seg_cap, np.int64)
    seg_off = np.empty(seg_cap, np.int64)
    seg_n = np.empty(seg_cap, np.int64)
    out_len = ctypes.c_int64(0)
    out_segs = ctypes.c_int64(0)
    u8p = ctypes.POINTER(ctypes.c_uint8)
    i32p = ctypes.POINTER(ctypes.c_int32)
    i64p = ctypes.POINTER(ctypes.c_int64)
    P = lambda a, t: a.ctypes.data_as(t)        # noqa: E731
    rc = lib.stitch_segments(
        P(sym, u8p), P(covpos, u8p), ctypes.c_int64(L),
        P(cut_pos, i64p), P(ins_off, i64p), P(ins_len, i64p),
        ctypes.c_int64(n_cut), P(ins_seq, u8p), ctypes.c_int64(max_gap),
        P(contig_out, u8p), ctypes.c_int64(contig_cap),
        P(ops_out, i32p), ctypes.c_int64(ops_cap),
        P(seg_t0, i64p), P(seg_off, i64p), P(seg_n, i64p),
        ctypes.c_int64(seg_cap),
        ctypes.byref(out_len), ctypes.byref(out_segs))
    if rc != 0:
        return None      # caps exceeded (shouldn't happen): Python fallback
    cl = int(out_len.value)
    if cl == 0:
        return None, []
    contig = contig_out[:cl].copy()
    segments = []
    for s in range(int(out_segs.value)):
        o, k = int(seg_off[s]), int(seg_n[s])
        ops = [(int(ops_out[j, 0]), int(ops_out[j, 1]))
               for j in range(o, o + k)]
        segments.append((int(seg_t0[s]), ops))
    return contig, segments


def build_tile_rows(recs, region_start: int, region_len: int,
                    wbucket, block: int, spans=None):
    """Native compact pileup rows + split-half nibble pack in one pass.

    Bit-identical to assembly/consensus.py::compact_pileup_rows followed
    by region_step.pack_row_tile.  Returns (nib (R, W_pad/2) u8, starts
    (R,) i32, lens (R,) i32, inss [(rpos, read_idx, seq u8)], W_pad), or
    None when the native library is unavailable.

    ``spans``: optional (r0, r1, n_ins, ins_seq_total) from a prior count
    pass (build_tile_delta's dense verdict hands its own through) --
    skips the tile_spans CIGAR walk."""
    lib = get_parse_lib()
    if lib is None or not recs:
        return None
    R = len(recs)
    cig_ptrs, seq_ptrs, n_cigs, poss, keep = _delta_ptr_arrays(recs)
    P32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    P64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    P8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))   # noqa: E731
    if spans is not None:
        r0, r1, n_ins, st = spans
        r0 = np.ascontiguousarray(r0, np.int32)
        r1 = np.ascontiguousarray(r1, np.int32)
        seq_total = ctypes.c_int64(int(st))
    else:
        r0 = np.empty(R, np.int32)
        r1 = np.empty(R, np.int32)
        seq_total = ctypes.c_int64(0)
        n_ins = int(lib.tile_spans(P64(cig_ptrs), P32(n_cigs), P32(poss), R,
                                   region_start, region_len,
                                   P32(r0), P32(r1),
                                   ctypes.byref(seq_total)))
    lens = r1 - r0
    offs = r0 % block
    W_pad = wbucket(int((lens + offs).max()) if R else 1)
    nib = np.full((R, W_pad // 2), 0xFF, np.uint8)
    ins_rpos = np.empty(n_ins, np.int32)
    ins_read = np.empty(n_ins, np.int32)
    ins_off = np.empty(n_ins, np.int64)
    ins_len = np.empty(n_ins, np.int32)
    ins_seq = np.empty(int(seq_total.value), np.uint8)
    got = int(lib.tile_fill(
        P64(cig_ptrs), P32(n_cigs), P64(seq_ptrs), P32(poss),
        R, region_start, region_len, W_pad, block, P32(r0), P32(r1),
        P8(nib), P32(ins_rpos), P32(ins_read), P64(ins_off), P32(ins_len),
        P8(ins_seq)))
    inss = [(int(ins_rpos[k]), int(ins_read[k]),
             ins_seq[ins_off[k]: ins_off[k] + ins_len[k]])
            for k in range(got)]
    return nib, r0, lens, inss, W_pad


def _delta_ptr_arrays(recs):
    """(cig_ptrs, seq_ptrs, n_cigs, poss, keep) for the tile_delta calls."""
    R = len(recs)
    cig_ptrs = np.empty(R, np.int64)
    seq_ptrs = np.empty(R, np.int64)
    n_cigs = np.empty(R, np.int32)
    poss = np.empty(R, np.int32)
    keep = []
    for i, r in enumerate(recs):
        cig = r.cigar
        if not cig.flags.c_contiguous or cig.dtype != np.int32:
            cig = np.ascontiguousarray(cig, np.int32)
        seq = r.seq
        if not seq.flags.c_contiguous or seq.dtype != np.uint8:
            seq = np.ascontiguousarray(seq, np.uint8)
        keep.append((cig, seq))
        cig_ptrs[i] = cig.ctypes.data
        n_cigs[i] = cig.shape[0]
        seq_ptrs[i] = seq.ctypes.data
        poss[i] = r.pos
    return cig_ptrs, seq_ptrs, n_cigs, poss, keep


def build_tile_delta(recs, ref_codes: np.ndarray, region_start: int,
                     region_len: int, dense_if_over: int | None = None):
    """Native reference-delta tile extraction in one pass over the CIGARs.

    Returns (r0 (R,) i32, r1 (R,) i32, subs (pos, read, sym), dels
    (read, a, b), inss [(rpos, read_idx, seq u8)]), or None when the
    native library is unavailable.  Span/deviation semantics bit-match
    compact_pileup_rows (assembly/consensus.py) -- the device kernel
    reconstructs identical column counts from these arrays.

    ``dense_if_over``: byte threshold, or a callable (r0, r1) -> threshold
    (the dense wire size depends on the spans, known only after the count
    pass).  When the deviation wire size (9 B/sub + 12 B/del run +
    8 B/read) exceeds it, the fill pass is SKIPPED and ("dense", r0, r1)
    is returned -- high-noise tiles choose the dense encoding without
    materializing deltas they would discard."""
    lib = get_parse_lib()
    if lib is None or not recs:
        return None
    R = len(recs)
    cig_ptrs, seq_ptrs, n_cigs, poss, keep = _delta_ptr_arrays(recs)
    ref8 = np.ascontiguousarray(ref_codes, np.uint8)
    P32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    P64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    P8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))   # noqa: E731
    r0 = np.empty(R, np.int32)
    r1 = np.empty(R, np.int32)
    cnt = [ctypes.c_int64(0) for _ in range(4)]
    lib.tile_delta_count(P64(cig_ptrs), P32(n_cigs), P64(seq_ptrs), P8(ref8),
                         P32(poss), R, region_start, region_len,
                         P32(r0), P32(r1), *[ctypes.byref(c) for c in cnt])
    n_subs, n_dels, n_ins, seq_total = (int(c.value) for c in cnt)
    if dense_if_over is not None:
        cap = dense_if_over(r0, r1) if callable(dense_if_over) \
            else dense_if_over
        if 9 * n_subs + 12 * n_dels + 8 * R > cap:
            # hand the count pass's spans + insertion totals to the dense
            # builder so it can skip its own tile_spans walk
            return ("dense", r0, r1, n_ins, seq_total)
    sub_pos = np.empty(n_subs, np.int32)
    sub_read = np.empty(n_subs, np.int32)
    sub_sym = np.empty(n_subs, np.uint8)
    del_read = np.empty(n_dels, np.int32)
    del_a = np.empty(n_dels, np.int32)
    del_b = np.empty(n_dels, np.int32)
    ins_rpos = np.empty(n_ins, np.int32)
    ins_read = np.empty(n_ins, np.int32)
    ins_off = np.empty(n_ins, np.int64)
    ins_len = np.empty(n_ins, np.int32)
    ins_seq = np.empty(seq_total, np.uint8)
    lib.tile_delta_fill(P64(cig_ptrs), P32(n_cigs), P64(seq_ptrs), P8(ref8),
                        P32(poss), R, region_start, region_len,
                        P32(r0), P32(r1),
                        P32(sub_pos), P32(sub_read), P8(sub_sym),
                        P32(del_read), P32(del_a), P32(del_b),
                        P32(ins_rpos), P32(ins_read), P64(ins_off),
                        P32(ins_len), P8(ins_seq))
    inss = [(int(ins_rpos[k]), int(ins_read[k]),
             ins_seq[ins_off[k]: ins_off[k] + ins_len[k]])
            for k in range(n_ins)]
    return ("delta", r0, r1, (sub_pos, sub_read, sub_sym),
            (del_read, del_a, del_b), inss)


def _rec_ptr_arrays(recs):
    """(cig_ptrs, n_cigs, keep) pointer arrays for a record list."""
    R = len(recs)
    cig_ptrs = np.empty(R, np.int64)
    n_cigs = np.empty(R, np.int32)
    keep = []
    for i, r in enumerate(recs):
        cig = r.cigar
        if not cig.flags.c_contiguous or cig.dtype != np.int32:
            cig = np.ascontiguousarray(cig, np.int32)
        keep.append(cig)
        cig_ptrs[i] = cig.ctypes.data
        n_cigs[i] = cig.shape[0]
    return cig_ptrs, n_cigs, keep


def read_sig_arrays(recs, cids, min_mapq: int, min_svlen: int):
    """Native CIGAR-signature + geometry extraction over a record list.

    Returns (sig dict of struct-of-arrays, geom dict of per-read arrays)
    or None when the native library is unavailable.  Bit-parity with
    signatures/contig.py::sigs_from_cigar / _aln_geometry."""
    lib = get_parse_lib()
    if lib is None or not recs:
        return None
    R = len(recs)
    cig_ptrs, n_cigs, keep = _rec_ptr_arrays(recs)
    poss = np.fromiter((r.pos for r in recs), np.int32, R)
    mapqs = np.fromiter((r.mapq for r in recs), np.int32, R)
    strands = np.fromiter((r.is_reverse for r in recs), np.uint8, R)
    cids = np.asarray(cids, np.int32)
    P32 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int32))  # noqa: E731
    P64 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int64))  # noqa: E731
    P8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))   # noqa: E731
    PS8 = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_int8))   # noqa: E731
    geom = {k: np.empty(R, np.int64)
            for k in ("ref_end", "read_start", "read_end", "read_len")}
    geom["clip_head"] = np.empty(R, np.uint8)
    geom["clip_tail"] = np.empty(R, np.uint8)
    lib.aln_geometry_batch(P64(cig_ptrs), P32(n_cigs), P32(poss), R,
                           P64(geom["ref_end"]), P64(geom["read_start"]),
                           P64(geom["read_end"]), P64(geom["read_len"]),
                           P8(geom["clip_head"]), P8(geom["clip_tail"]))
    n = int(lib.cigar_sigs_count(P64(cig_ptrs), P32(n_cigs), P32(mapqs), R,
                                 min_mapq, min_svlen))
    sig = dict(svtype=np.empty(n, np.int8), pos=np.empty(n, np.int64),
               svlen=np.empty(n, np.int64), contig=np.empty(n, np.int32),
               rstart=np.empty(n, np.int64), rend=np.empty(n, np.int64),
               strand=np.empty(n, np.int8), mapq=np.empty(n, np.int32))
    got = int(lib.cigar_sigs_fill(
        P64(cig_ptrs), P32(n_cigs), P32(poss), P32(mapqs), P32(cids),
        P8(strands), R, min_mapq, min_svlen,
        PS8(sig["svtype"]), P64(sig["pos"]), P64(sig["svlen"]),
        P32(sig["contig"]), P64(sig["rstart"]), P64(sig["rend"]),
        PS8(sig["strand"]), P32(sig["mapq"])))
    if got != n:
        return None
    return sig, geom


def get_lib():
    """The loaded native library, or None if unavailable."""
    global _lib, _tried
    if _lib is not None or _tried:
        return _lib
    _tried = True
    if not os.path.exists(_SO):
        if not _build():
            return None
    try:
        lib = ctypes.CDLL(_SO)
        lib.chain_dp.restype = None
        lib.chain_dp.argtypes = [
            ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.POINTER(ctypes.c_double), ctypes.POINTER(ctypes.c_int64),
        ]
        lib.banded_edit_distance.restype = ctypes.c_int64
        lib.banded_edit_distance.argtypes = [
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64, ctypes.c_int64,
        ]
        try:  # absent in a stale prebuilt library: callers fall back
            lib.space_anchors.restype = ctypes.c_int64
            lib.space_anchors.argtypes = [
                ctypes.POINTER(ctypes.c_int64), ctypes.POINTER(ctypes.c_int64),
                ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_int64),
            ]
        except AttributeError:
            pass
        try:  # absent in a stale prebuilt library: callers fall back
            lib.affine_banded_align.restype = ctypes.c_int64
            lib.affine_banded_align.argtypes = [
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8), ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64,
                ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
                ctypes.POINTER(ctypes.c_uint8),
            ]
        except AttributeError:
            pass
        _lib = lib
    except OSError:
        _lib = None
    return _lib


def chain_dp(t: np.ndarray, q: np.ndarray, k: int, max_pred: int,
             max_gap: int):
    """Native chain DP; returns (f float64, pred int64) or None if no lib."""
    lib = get_lib()
    if lib is None:
        return None
    n = t.shape[0]
    t64 = np.ascontiguousarray(t, np.int64)
    q64 = np.ascontiguousarray(q, np.int64)
    f = np.zeros(n, np.float64)
    pred = np.zeros(n, np.int64)
    lib.chain_dp(
        t64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        q64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, k, max_pred, max_gap,
        f.ctypes.data_as(ctypes.POINTER(ctypes.c_double)),
        pred.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return f, pred


def space_anchors(t: np.ndarray, q: np.ndarray, k: int):
    """Indices of greedily k-spaced anchors, or None if no lib."""
    lib = get_lib()
    if lib is None or not hasattr(lib, "space_anchors"):
        return None
    n = t.shape[0]
    t64 = np.ascontiguousarray(t, np.int64)
    q64 = np.ascontiguousarray(q, np.int64)
    out = np.empty(n, np.int64)
    m = lib.space_anchors(
        t64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        q64.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        n, k, out.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    return out[:m]


def affine_banded_align(q: np.ndarray, t: np.ndarray, d_lo: int, band: int,
                        match: int, mismatch: int, gap_open: int,
                        gap_extend: int):
    """Host banded affine DP with direction bits (ops/align.py semantics).

    Returns (score, dirs (len(q), band) uint8) for ops/align.py::traceback,
    or None if the native library is unavailable.
    """
    lib = get_lib()
    if lib is None or not hasattr(lib, "affine_banded_align"):
        return None
    q8 = np.ascontiguousarray(q, np.uint8)
    t8 = np.ascontiguousarray(t, np.uint8)
    dirs = np.zeros((max(len(q8), 1), band), np.uint8)
    score = int(lib.affine_banded_align(
        q8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(q8),
        t8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(t8),
        d_lo, band, match, mismatch, gap_open, gap_extend,
        dirs.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))))
    return score, dirs


def banded_edit_distance(a: np.ndarray, b: np.ndarray, band: int):
    lib = get_lib()
    if lib is None:
        return None
    a8 = np.ascontiguousarray(a, np.uint8)
    b8 = np.ascontiguousarray(b, np.uint8)
    return int(lib.banded_edit_distance(
        a8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(a8),
        b8.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)), len(b8),
        band))
