"""Banded affine-gap alignment DP: the framework's most-reused primitive.

Replaces the reference's native DP cores -- hifiasm's ksw2_extz2_sse.c
(SSE-vectorized extension alignment), minimap2's extension stage, and edlib's
edit distance (`remove_redundancy.py:57-63`) -- with one batched
formulation: a hand-written CUDA kernel on the card (kernel B1,
ops/align_cuda.py + csrc/banded_align.cu) and a plain PyTorch row loop beside
it (banded_align_batch), which the CPU runs and the kernel is held to.

Design: the band is stored by diagonal offset, so each DP row is a
fixed-width W vector; the horizontal (gap-in-query) dependency is resolved
with a *cummax prefix scan* instead of a sequential inner loop, making every
row update a pure vector op.  Valid when gap_open <= gap_extend <= 0 (opening
a gap from inside another gap never wins), which holds for all presets.

Row recurrence in band coordinates (k indexes diagonal j - i - d_lo):

    diag[k] = H_prev[k]   + sub(q[i], t[j])          # both i,j advance
    F[k]    = max(H_prev[k+1] + open, F_prev[k+1] + ext)   # query gap  (I op)
    G[k]    = max(diag, F)
    E[k]    = cummax_{k'<k}(G[k'] - ext*k') + open + ext*(k-1)  # target gap (D)
    H[k]    = max(G, E)

Direction bits (4 per cell, packed uint8) are written to device memory and
traced back on host to produce BAM CIGAR ops.
"""

from __future__ import annotations

import numpy as np
import torch

from focalsv_tpu.io import bam as bamio
from focalsv_tpu_torch.device import resolve_device

NEG = -(1 << 28)

# banded DPs up to this many cells run in the native host kernel (dispatch
# latency to a -- possibly remote -- device exceeds the compute below this)
NATIVE_DP_MAX_CELLS = 1 << 24

# direction-bit layout
DIR_H_MASK = 0b11    # 0=diag, 1=E (target gap / D), 2=F (query gap / I), 3=start
DIR_E_EXT = 0b100    # E came from E (gap extension)
DIR_F_EXT = 0b1000   # F came from F


# ---------------------------------------------------------------------------
# numpy reference (full matrix, used as ground truth in tests)
# ---------------------------------------------------------------------------


def align_numpy(q, t, match=2, mismatch=-4, gap_open=-4, gap_extend=-2,
                free_t_flanks: bool = False):
    """Full-matrix affine global alignment; returns (score, cigar ops list).

    With ``free_t_flanks`` the target's leading/trailing gaps are free
    (glocal / fit alignment of q inside t).
    """
    q = np.asarray(q); t = np.asarray(t)
    M, N = len(q), len(t)
    H = np.full((M + 1, N + 1), NEG, np.int64)
    E = np.full_like(H, NEG)
    F = np.full_like(H, NEG)
    ptr = np.zeros((M + 1, N + 1), np.uint8)
    H[0, 0] = 0
    for j in range(1, N + 1):
        E[0, j] = 0 if free_t_flanks else gap_open + gap_extend * (j - 1)
        H[0, j] = E[0, j]
        ptr[0, j] = 1
    for i in range(1, M + 1):
        F[i, 0] = gap_open + gap_extend * (i - 1)
        H[i, 0] = F[i, 0]
        ptr[i, 0] = 2
    for i in range(1, M + 1):
        for j in range(1, N + 1):
            s = match if (q[i - 1] == t[j - 1] and q[i - 1] < 4) else mismatch
            e_open, e_ext = H[i, j - 1] + gap_open, E[i, j - 1] + gap_extend
            E[i, j] = max(e_open, e_ext)
            f_open, f_ext = H[i - 1, j] + gap_open, F[i - 1, j] + gap_extend
            F[i, j] = max(f_open, f_ext)
            diag = H[i - 1, j - 1] + s
            H[i, j] = max(diag, E[i, j], F[i, j])
            p = 0 if H[i, j] == diag else (1 if H[i, j] == E[i, j] else 2)
            ptr[i, j] = p | (DIR_E_EXT if e_ext >= e_open else 0) | (
                DIR_F_EXT if f_ext >= f_open else 0)
    # endpoint
    if free_t_flanks:
        j_end = int(np.argmax(H[M, :]))
        score = int(H[M, j_end])
    else:
        j_end, score = N, int(H[M, N])
    # traceback
    ops = []
    i, j = M, j_end
    state = 0  # 0=H, 1=E, 2=F
    while i > 0 or j > 0:
        p = ptr[i, j]
        if state == 0:
            state = p & DIR_H_MASK
            if state == 0:
                ops.append(bamio.CMATCH)
                i, j = i - 1, j - 1
        elif state == 1:
            ops.append(bamio.CDEL)
            state = 1 if (p & DIR_E_EXT) else 0
            j -= 1
        else:
            ops.append(bamio.CINS)
            state = 2 if (p & DIR_F_EXT) else 0
            i -= 1
        if i == 0 and j > 0 and state == 0:
            state = 1
        if j == 0 and i > 0 and state == 0:
            state = 2
    ops.reverse()
    return score, _runlength(ops), j_end


def _runlength(ops):
    out = []
    for op in ops:
        if out and out[-1][0] == op:
            out[-1][1] += 1
        else:
            out.append([op, 1])
    return [(o, l) for o, l in out]


# ---------------------------------------------------------------------------
# plain PyTorch banded batch DP (the plain version of kernel B1)
# ---------------------------------------------------------------------------


def banded_align_batch(
    q: torch.Tensor,       # (B, Lq) uint8, PAD beyond length
    q_len: torch.Tensor,   # (B,) int32
    t: torch.Tensor,       # (B, Lt) uint8
    t_len: torch.Tensor,   # (B,) int32
    d_lo: torch.Tensor,    # (B,) int32 band low diagonal (j - i >= d_lo)
    band: int = 256,
    max_rows: int | None = None,
    match: int = 2,
    mismatch: int = -4,
    gap_open: int = -4,
    gap_extend: int = -2,
    store_dirs: bool = True,
):
    """Batched banded affine global alignment, one row at a time.

    Returns (score (B,) int32, dirs (B, max_rows, band) uint8 or None) on
    the tensors' device.  The band for row i covers target columns j in
    [i + d_lo, i + d_lo + band).  Alignment is global in both sequences;
    callers choose d_lo so that the (q_len, t_len) endpoint lies in-band
    (e.g. d_lo = (t_len - q_len - band//2)).  The batch axis is written
    out where the reference vmaps, and the row loop replaces its lax.scan.
    """
    dev = q.device
    i32 = torch.int32
    B, Lq = q.shape
    Lt = t.shape[1]
    M = max_rows if max_rows is not None else Lq
    W = band
    ks = torch.arange(W, dtype=i32, device=dev)[None, :]
    qn = q_len.to(device=dev, dtype=i32)[:, None]
    tn = t_len.to(device=dev, dtype=i32)[:, None]
    dlo = d_lo.to(device=dev, dtype=i32)[:, None]
    neg = torch.full((B, 1), NEG, dtype=i32, device=dev)
    ext_ks = gap_extend * ks
    e_off = (gap_open - gap_extend) + ext_ks
    ext_left = gap_extend * (ks - 1)

    j0 = dlo + ks
    h = torch.where(j0 == 0, 0,
                    torch.where(j0 > 0, gap_open + gap_extend * (j0 - 1),
                                NEG)).to(i32)
    h = torch.where((j0 >= 0) & (j0 <= tn), h, NEG)
    f = torch.full((B, W), NEG, dtype=i32, device=dev)
    h_end = torch.where(qn == 0, h, NEG)
    dirs = (torch.zeros((B, M, W), dtype=torch.uint8, device=dev)
            if store_dirs else None)
    # t[j - 1] of every row: row i reads tshift[:, i-1 : i-1+W]; an index
    # below 0 clamps to t[0] and one past the target reads the pad 255
    t_pad = torch.cat([t, torch.full((B, W + 1), 255, dtype=t.dtype,
                                     device=dev)], dim=1)
    xs = torch.arange(M + W, dtype=i32, device=dev)[None, :] + dlo
    tshift = torch.gather(t_pad, 1, xs.clamp(0, Lt + W).long()).to(i32)
    qi = q.to(i32)
    q_acgt = qi < 4
    # rows past every q_len are off the band: no state to carry, dirs 0
    rows = min(M, int(qn.max())) if B else 0
    for i in range(1, rows + 1):
        r = min(max(i - 1, 0), Lq - 1)
        qc = qi[:, r : r + 1]
        j = (i + dlo) + ks
        live = i <= qn
        jv = (j >= 1) & (j <= tn) & live
        # the j==0 column (pure leading query insertions) is F-only
        jz = (j == 0) & live
        tc = tshift[:, i - 1 : i - 1 + W]
        sub = torch.where((qc == tc) & q_acgt[:, r : r + 1], match, mismatch)
        diag = h + sub
        f_open = torch.cat([h[:, 1:], neg], dim=1) + gap_open
        f_ext = torch.cat([f[:, 1:], neg], dim=1) + gap_extend
        f_new = torch.maximum(f_open, f_ext)
        g = torch.maximum(diag, f_new)
        a = torch.cummax(g - ext_ks, dim=1).values
        a_shift = torch.cat([neg, a[:, :-1]], dim=1)
        # gap of length g costs open + ext*(g-1): the -ext corrects the scan
        e = a_shift + e_off
        h_new = torch.where(jv, torch.maximum(g, e),
                            torch.where(jz, f_new, NEG))
        if store_dirs:
            f_bit = torch.where(f_ext >= f_open, DIR_F_EXT, 0)
            d = torch.where(h_new == diag, 0,
                            torch.where(h_new == e, 1, 2)) | f_bit
            g_left = torch.cat([neg, g[:, :-1]], dim=1)
            d = d | torch.where(a_shift > g_left - ext_left, DIR_E_EXT, 0)
            d = torch.where(jv, d, torch.where(jz, 2 | f_bit, 0))
            dirs[:, i - 1] = d
        h_end = torch.where(qn == i, h_new, h_end)
        h = h_new
        f = torch.where(jv | jz, f_new, NEG)
    k_end = tn - qn - dlo
    in_band = (k_end >= 0) & (k_end < W)
    score = torch.where(
        in_band, torch.gather(h_end, 1, k_end.clamp(0, W - 1).long()),
        NEG)[:, 0]
    return score, dirs


def traceback(
    dirs: np.ndarray,        # (M, W) uint8, row r is DP row r+1
    q_len: int,
    t_len: int,
    d_lo: int,
) -> list[tuple[int, int]]:
    """Host traceback from direction bits to run-length CIGAR (op, len)."""
    W = dirs.shape[1]
    ops: list[int] = []
    i, j = int(q_len), int(t_len)
    state = 0
    while i > 0 or j > 0:
        if i == 0:
            ops.extend([bamio.CDEL] * j)
            break
        if j <= i + d_lo:  # left band edge or j==0: only query gaps possible
            if j == 0:
                ops.extend([bamio.CINS] * i)
                break
        k = j - i - d_lo
        p = int(dirs[i - 1, k]) if 0 <= k < W else 0
        if state == 0:
            state = p & DIR_H_MASK
            if state == 0:
                ops.append(bamio.CMATCH)
                i -= 1
                j -= 1
        elif state == 1:
            ops.append(bamio.CDEL)
            state = 1 if (p & DIR_E_EXT) else 0
            j -= 1
        else:
            ops.append(bamio.CINS)
            state = 2 if (p & DIR_F_EXT) else 0
            i -= 1
    ops.reverse()
    return _runlength(ops)


def banded_align(q, q_len, t, t_len, d_lo, band=256, store_dirs=True, **scoring):
    """Device-dispatching banded DP: kernel B1 (ops/align_cuda.py) for CUDA
    tensors, at every band width and with or without dirs; the plain
    version for CPU tensors."""
    if q.is_cuda:
        from focalsv_tpu_torch.ops.align_cuda import banded_align_batch_cuda
        return banded_align_batch_cuda(q, q_len, t, t_len, d_lo, band=band,
                                       store_dirs=store_dirs, **scoring)
    return banded_align_batch(q, q_len, t, t_len, d_lo, band=band,
                              store_dirs=store_dirs, **scoring)


def to_device(dev, *arrays):
    """numpy arrays -> tensors on ``dev`` (the kernel takes contiguous
    uint8 sequences and int32 lengths)."""
    return [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
            for a in arrays]


def _pad_bucket(x: np.ndarray, lo: int = 64) -> np.ndarray:
    """Pad a 1-D uint8 sequence to the next power-of-FOUR bucket.

    Coarse buckets keep the set of distinct jit shapes tiny -- essential on
    TPU where each new (Lq, Lt, band) combination is a fresh XLA compile.
    """
    n = lo
    while n < len(x):
        n *= 4
    if n == len(x):
        return x
    return np.concatenate([x, np.full(n - len(x), 5, np.uint8)])


def band_bucket(need: int, lo: int = 128) -> int:
    """Quantize band widths to {128, 512, 2048, 8192, ...} (x4 steps)."""
    b = lo
    while b < need:
        b *= 4
    return b


def ops_to_cigar(ops: np.ndarray, n: int) -> list[tuple[int, int]]:
    """Device op string (reverse order) -> run-length BAM CIGAR."""
    from focalsv_tpu.io import bam as bamio
    code_map = {0: bamio.CMATCH, 1: bamio.CDEL, 2: bamio.CINS}
    out: list[tuple[int, int]] = []
    for x in ops[:n][::-1]:
        op = code_map[int(x)]
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + 1)
        else:
            out.append((op, 1))
    return out


def banded_align_pair(q, t, band=256, match=2, mismatch=-4, gap_open=-4,
                      gap_extend=-2):
    """Convenience single-pair wrapper: returns (score, cigar).

    When a DPBatcher is active (parallel/batch_executor.dp_batching), the job
    routes through the cross-thread batching service so concurrent pairs run
    as one device batch."""
    q = np.asarray(q, np.uint8)
    t = np.asarray(t, np.uint8)
    # a band narrower than the length difference cannot contain the global
    # endpoint -- widen it instead of silently returning garbage
    if abs(len(t) - len(q)) + 8 > band:
        band = band_bucket(abs(len(t) - len(q)) + 32, lo=band)
    d_lo = (len(t) - len(q)) // 2 - band // 2
    # ensure k_end in range and diagonal start reachable
    d_lo = int(np.clip(d_lo, len(t) - len(q) - band + 1, 0))
    from focalsv_tpu_torch.parallel import batch_executor
    batcher = batch_executor.get_active()
    if batcher is not None and not batcher.route_native(len(q) * band):
        score, dirs = batcher.align(q, t, band, match, mismatch,
                                    gap_open, gap_extend, d_lo)
        cig = traceback(np.asarray(dirs), len(q), len(t), d_lo)
        return score, cig
    # host fast path: small DPs are latency-bound on a device round-trip
    # (remote-TPU dispatch ~10s of ms), not FLOP-bound -- run them in the
    # native C++ kernel (bit-identical band semantics), exactly the role
    # ksw2 plays inside minimap2.  Large DPs stay on the TPU kernel.
    if len(q) * band <= NATIVE_DP_MAX_CELLS:
        from focalsv_tpu import native
        res = native.affine_banded_align(q, t, d_lo, band, match, mismatch,
                                         gap_open, gap_extend)
        if res is not None:
            score, dirs = res
            cig = traceback(dirs, len(q), len(t), d_lo)
            return score, cig
    qp, tp = _pad_bucket(q), _pad_bucket(t)
    qd, qnd, td, tnd, dld = to_device(
        resolve_device(), qp[None], np.array([len(q)], np.int32), tp[None],
        np.array([len(t)], np.int32), np.array([d_lo], np.int32))
    scores, dirs = banded_align(
        qd, qnd, td, tnd, dld, band=band, match=match, mismatch=mismatch,
        gap_open=gap_open, gap_extend=gap_extend)
    cig = traceback(dirs[0].cpu().numpy(), len(q), len(t), d_lo)
    return int(scores[0]), cig


# ---------------------------------------------------------------------------
# score-only edit similarity (replaces edlib in dedup)
# ---------------------------------------------------------------------------


def edit_similarity(a: np.ndarray, b: np.ndarray, band: int = 128) -> float:
    """1 - dist/max(len) as used by remove_redundancy.edit_sim (:57-63)."""
    la, lb = len(a), len(b)
    if max(la, lb) == 0:
        return 1.0
    # host-native path: score-only O(n*band) with a small working set -- a
    # 30 kb INS-seq pair at band ~100 is ~3M cells, fractions of a ms.  The
    # previous 20 kb length cap pushed long low-divergence pairs onto a
    # fresh wide-band XLA compile (a >4 min stall per new shape on CPU)
    if max(la, lb) * (abs(la - lb) + 64) <= NATIVE_DP_MAX_CELLS * 16:
        from focalsv_tpu import native
        dist = native.banded_edit_distance(
            np.asarray(a, np.uint8), np.asarray(b, np.uint8),
            band=abs(la - lb) + 64)
        if dist is not None:
            return 1.0 - dist / max(la, lb)
    band = max(band, band_bucket(abs(la - lb) + 16))
    d_lo = (lb - la) // 2 - band // 2
    d_lo = int(np.clip(d_lo, lb - la - band + 1, 0))
    args = to_device(
        resolve_device(), _pad_bucket(np.asarray(a, np.uint8))[None],
        np.array([la], np.int32), _pad_bucket(np.asarray(b, np.uint8))[None],
        np.array([lb], np.int32), np.array([d_lo], np.int32))
    scores, _ = banded_align(
        *args, band=band, match=0, mismatch=-1, gap_open=-1, gap_extend=-1,
        store_dirs=False)
    dist = -int(scores[0])
    return 1.0 - dist / max(la, lb)
