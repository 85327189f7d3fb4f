"""Indel left-alignment (VCF normalization).

Inside tandem repeats an indel's placement is ambiguous; the contig aligner,
the read aligner, and the truth set may each pick a different (equivalent)
position, defeating shift-bounded matching (FP filter max_shift 500, GT
correction, dedup).  Left-aligning both calls and read signatures puts every
equivalent representation at the canonical leftmost position.
"""

from __future__ import annotations

import numpy as np


def left_align_del(ref: np.ndarray, pos: int, length: int,
                   max_shift: int = 10_000) -> int:
    """Leftmost equivalent start of a deletion of ref[pos : pos+length]."""
    p = int(pos)
    lo = max(1, p - max_shift)
    while p > lo and ref[p - 1] == ref[p + length - 1]:
        p -= 1
    return p


def left_align_ins(ref: np.ndarray, pos: int, seq: np.ndarray,
                   max_shift: int = 10_000) -> tuple[int, np.ndarray]:
    """Leftmost equivalent (pos, sequence) of an insertion before ref[pos]."""
    p = int(pos)
    s = np.asarray(seq, np.uint8).copy()
    lo = max(1, p - max_shift)
    n = len(s)
    if n == 0:
        return p, s
    while p > lo and s[n - 1] == ref[p - 1]:
        s = np.concatenate([s[-1:], s[:-1]])
        p -= 1
    return p, s


def left_align_ins_approx(ref: np.ndarray, pos: int, seq: np.ndarray,
                          max_shift: int = 10_000,
                          min_dup_sim: float = 0.7) -> tuple[int, np.ndarray]:
    """Noise-tolerant left-alignment for duplication-type insertions.

    The exact rotation (left_align_ins) stops at the FIRST base where the
    inserted sequence disagrees with the upstream reference -- one
    residual consensus error in a noisy-read contig strands a tandem-array
    expansion mid-array, hundreds of bases from the canonical position
    every other representation (truth, read signatures, the other
    haplotype) reaches, and shift-bounded matching then breaks.

    When the insertion is a near-copy of the adjacent reference (edit
    similarity >= min_dup_sim -- the tandem-expansion signature), its
    equivalent placements are exactly the positions where the REFERENCE
    is locally len(seq)-periodic, so the walk can continue on ref-only
    comparisons, which the sequencing noise cannot touch.  Reduces to
    left_align_ins for clean sequences (the exact rotation already
    reaches the array start) and leaves non-duplication insertions
    untouched.  The returned sequence is rotated THROUGH THE REFERENCE
    for the approx-shifted span (X' = ref[p_new:p_old] + X[:n-k], the
    exact-equivalence rotation under the duplication assumption), so the
    (POS, ALT) pair stays a self-consistent representation at the
    canonical position.
    """
    p, s = left_align_ins(ref, pos, seq, max_shift)
    n = len(s)
    a = p - n
    if n == 0 or a < 0 or p + n > len(ref):
        return p, s
    from focalsv_tpu_torch.ops.align import edit_similarity
    if edit_similarity(s, ref[a:p]) < min_dup_sim:
        return p, s
    lo = max(1, p - max_shift)
    p0 = p
    while p > lo and ref[p - 1] == ref[p + n - 1]:
        p -= 1
    k = p0 - p
    if k:
        s = (np.concatenate([ref[p:p0], s[: n - k]]).astype(np.uint8)
             if k < n else np.asarray(ref[p : p + n], np.uint8).copy())
    return p, s


def ref_period(ref: np.ndarray, pos: int, length: int,
               max_period: int = 200, min_sim: float = 0.92) -> int:
    """Smallest period p (2..max_period) such that the reference around
    the event -- window [pos - 2p, pos + length + 2p], i.e. the event
    plus two unit copies of margin each side -- is p-periodic; 0 when
    aperiodic.

    The margin scales WITH the candidate period: a fixed window dilutes
    agreement with non-array flank whenever the event sits near an array
    boundary (exactly where noisy calls land).  Candidate periods come
    from one FFT autocorrelation over event-anchored windows (a 200-lag
    exact scan per call would cost ~0.6 ms on every non-array record);
    each candidate is then exact-verified with its own scaled window."""
    n = len(ref)
    W = min(length + 240, 2000)
    cands: set[int] = set()
    for lo, hi in ((pos, pos + W), (pos - W, pos)):
        lo = max(0, lo)
        hi = min(n, hi)
        if hi - lo < 12:
            continue
        win = np.asarray(ref[lo:hi])
        m = win.shape[0]
        oh = (win[:, None] == np.arange(4, dtype=win.dtype)).astype(
            np.float32)
        f = np.fft.rfft(oh, 2 * m, axis=0)
        ac = np.fft.irfft(f * np.conj(f), 2 * m, axis=0)[:m].sum(1)
        frac = ac / np.maximum(m - np.arange(m), 1)
        top = min(max_period, m // 3) + 1
        if top > 2:
            cands.update(int(p) for p in
                         np.nonzero(frac[2:top] >= min_sim * 0.95)[0] + 2)
    for p in sorted(cands):
        lo = max(0, pos - 2 * p)
        hi = min(n, pos + length + 2 * p)
        w = hi - lo
        if w < 3 * p or w <= p:
            continue
        win = np.asarray(ref[lo:hi])
        if float((win[: w - p] == win[p:]).mean()) >= min_sim:
            return p
    return 0


def snap_indel_to_unit(ref: np.ndarray, pos: int, svlen: int,
                       max_unit: int = 200) -> int:
    """Snap an indel length to the nearest whole multiple of the local
    tandem-repeat unit, when the flanking reference is strongly periodic.

    Inside a tandem array a true indel is (almost always) a whole-unit
    expansion/contraction; a noisy consensus measures the length a
    fraction of a unit off, which (a) breaks rotation left-alignment
    (non-multiple lengths aren't shift-invariant, so the call strands
    mid-array) and (b) can fail size-similarity against the truth.
    Snapping applies ONLY when the event's p-scaled flank window is
    u-periodic (ref_period) and the correction is under half a unit --
    outside arrays this is a no-op.  Returns the (possibly snapped)
    |length|."""
    return snap_indel_with_unit(ref, pos, svlen, max_unit)[0]


def snap_indel_with_unit(ref: np.ndarray, pos: int, svlen: int,
                         max_unit: int = 200) -> tuple[int, int]:
    """snap_indel_to_unit plus the detected unit period (0 = aperiodic).

    The unit lets callers canonicalize the POSITION too: inside an array
    every unit boundary is an equivalent placement, and two haplotypes'
    observations of one event can sit whole units apart -- beyond any
    shift-bounded pairing gate (left_align_del(ref, pos, unit) walks to
    the array start)."""
    L = abs(int(svlen))
    if L < 20:
        return L, 0
    # cheap aperiodicity prefilter: a u<=max_unit array repeats its 8-mers
    # every unit, so low 8-mer diversity is necessary for any snap; random
    # flank shows ~full diversity and skips the FFT period search
    # entirely (non-array records dominate every real callset)
    W = min(L + 240, 1200)
    a = max(0, pos - W // 4)
    win = np.asarray(ref[a : a + W], np.int64)
    if win.size >= 64:
        km = (win[:-7] * 1 + win[1:-6] * 4 + win[2:-5] * 16 + win[3:-4] * 64
              + win[4:-3] * 256 + win[5:-2] * 1024 + win[6:-1] * 4096
              + win[7:] * 16384)
        if np.unique(km).size > 0.7 * km.size:
            return L, 0
    u = ref_period(ref, pos, L, max_period=max_unit)
    if u < 3:
        return L, 0
    k = int(round(L / u))
    if k < 1:
        return L, u
    snapped = k * u
    if snapped != L and abs(L - snapped) <= max(6, int(0.45 * u)):
        return snapped, u
    return L, u
