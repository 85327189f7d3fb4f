"""Seeded banded-DP inputs at the shapes the main path sends to kernel B1,
noisy pairs, and crafted direction bytes for the traceback (kernel B4),
shared by chip_smoke.py, testing/kernel_sweep.py and the tests."""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.ops import align as talign

OLC_SCORING = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
ALIGNER_SCORING = dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2)
UNIT_COSTS = dict(match=0, mismatch=-1, gap_open=-1, gap_extend=-1)


def dp_pairs(rng, B, Lq, W, q_lo, leading_ins=False, edge=False):
    """HiFi-like pairs at the main path's padded shapes: queries of
    q_lo..Lq-64 bases, targets the query's source with indels and
    substitutions, d_lo as banded_align_pair places the band.

    ``leading_ins`` puts 20 extra bases in front of every query and keeps
    the j == 0 column in the band.  ``edge`` makes pair 0 run along the
    band's lower edge (d_lo at its upper limit, 0), empties the query of
    pair 1 and the target of pair 2 (where the batch has them)."""
    q = np.full((B, Lq), 5, np.uint8)
    qs, ts = [], []
    for _ in range(B):
        n = int(rng.integers(q_lo, Lq - 64))
        src = rng.integers(0, 4, n + 200).astype(np.uint8)
        read = src.copy()
        for _ in range(max(1, n // 1000)):      # indels of a few bases
            at = int(rng.integers(100, len(read) - 100))
            if rng.random() < 0.5:
                read = np.delete(read, slice(at, at + int(rng.integers(1, 6))))
            else:
                read = np.insert(read, at, rng.integers(0, 4, 3))
        flip = rng.random(len(read)) < 0.002
        read[flip] = (read[flip] + 1) % 4
        if leading_ins:
            read = np.concatenate([rng.integers(0, 4, 20), read]
                                  ).astype(np.uint8)
        read = read[: Lq - 64]
        qs.append(read)
        ts.append(src[: len(read) + int(rng.integers(0, 32))])
    if edge:
        if B > 1:
            qs[1] = qs[1][:0]
        if B > 2:
            ts[2] = ts[2][:0]
    Lt = talign._pad_bucket(np.zeros(max(map(len, ts)), np.uint8)).shape[0]
    t = np.full((B, Lt), 5, np.uint8)
    q_len = np.zeros(B, np.int32)
    t_len = np.zeros(B, np.int32)
    d_lo = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(zip(qs, ts)):
        q[b, : len(qq)] = qq
        t[b, : len(tt)] = tt
        q_len[b], t_len[b] = len(qq), len(tt)
        lo = (len(tt) - len(qq)) // 2 - W // 2
        d_lo[b] = int(np.clip(lo, len(tt) - len(qq) - W + 1, 0))
        if leading_ins:
            d_lo[b] = -W // 4          # keeps the j == 0 column in the band
    if edge:
        d_lo[0] = 0
    return q, q_len, t, t_len, d_lo


def noisy_pairs(rng, B, Lq, W, q_lo, sub=0.05, ins=0.06, dele=0.04):
    """CLR-like pairs (about 15 % error, most of it indels of one base):
    their walks change state every few ops, so runs are near length 1."""
    q = np.full((B, Lq), 5, np.uint8)
    qs, ts = [], []
    for _ in range(B):
        n = int(rng.integers(q_lo, Lq - 64))
        src = rng.integers(0, 4, n).astype(np.uint8)
        u = rng.random(n)
        keep = u >= dele
        flip = (u >= dele) & (u < dele + sub)
        read = src.copy()
        read[flip] = (read[flip] + 1 + rng.integers(0, 3, int(flip.sum()))) % 4
        extra = rng.random(n) < ins
        parts = np.stack([read, rng.integers(0, 4, n).astype(np.uint8)], 1)
        take = np.stack([keep, extra], 1)
        read = parts[take][: Lq - 64]
        qs.append(read)
        ts.append(src)
    Lt = talign._pad_bucket(np.zeros(max(map(len, ts)), np.uint8)).shape[0]
    t = np.full((B, Lt), 5, np.uint8)
    q_len = np.zeros(B, np.int32)
    t_len = np.zeros(B, np.int32)
    d_lo = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(zip(qs, ts)):
        q[b, : len(qq)] = qq
        t[b, : len(tt)] = tt
        q_len[b], t_len[b] = len(qq), len(tt)
        lo = (len(tt) - len(qq)) // 2 - W // 2
        d_lo[b] = int(np.clip(lo, len(tt) - len(qq) - W + 1, 0))
    return q, q_len, t, t_len, d_lo


def carve_dirs(M, W, q_len, t_len, d_lo, runs):
    """Direction bytes (M, W) of one pair, all diagonal but for the gap runs
    of ``runs``: (op, length) pairs from the alignment's end backwards, op 0
    = M, 1 = D, 2 = I.  A run's cells off the band are left out, as the DP
    leaves them."""
    dirs = np.zeros((M, W), np.uint8)
    i, j = q_len, t_len
    for op, length in runs:
        for s in range(length):
            if i <= 0 or j <= 0:
                return dirs
            k = j - i - d_lo
            if op and 0 <= k < W and i <= M:
                first = op if s == 0 else 0
                more = (talign.DIR_E_EXT if op == 1 else talign.DIR_F_EXT)
                dirs[i - 1, k] |= first | (more if s < length - 1 else 0)
            i -= op != 1
            j -= op != 2
    return dirs


def walk_cases(seed=0, with_stop=False):
    """Direction bytes whose walks hold what a traceback must get right:
    (name, dirs (B, M, W), q_len, t_len, d_lo, W, M), with gap runs longer
    than 32 ops, than 64 rows and than 128 columns, runs of 31, 32 and 33,
    runs that end on the band's edge or leave it, an op string filled to its
    last byte, a band width that is no multiple of 16, and random bytes.

    No cell of the DP holds an H source of 3, and the JAX package's
    traceback_device does not end on one; ``with_stop`` adds random bytes
    that do hold it, for the port's kernel against its plain version (both
    stop there)."""
    rng = np.random.default_rng(seed)
    cases = []

    def add(name, M, W, pairs):
        dirs = np.stack([carve_dirs(M, W, ql, tl, dl, runs)
                         for ql, tl, dl, runs in pairs])
        cases.append((name, dirs,
                      np.array([p[0] for p in pairs], np.int32),
                      np.array([p[1] for p in pairs], np.int32),
                      np.array([p[2] for p in pairs], np.int32), W, M))

    # D runs along a row: 200 columns (past a tile's 128), 33, 32 and 31
    add("long_e_runs", 96, 320, [
        (90, 300, -20, [(0, 20), (1, 200), (0, 70)]),
        (90, 190, -20, [(0, 7), (1, 33), (0, 9), (1, 32), (0, 3), (1, 31),
                        (0, 71)]),
        (64, 264, -10, [(1, 200), (0, 64)])])
    # I runs up the anti-diagonal: 150 rows (past a tile's 64), 80, 33, 32
    add("long_f_runs", 256, 320, [
        (250, 110, -200, [(0, 30), (2, 150), (0, 70)]),
        (250, 180, -100, [(0, 5), (2, 33), (0, 40), (2, 32), (0, 60),
                          (2, 80)]),
        (200, 100, -150, [(2, 100), (0, 100)])])
    # gap runs that end on the band's edge (k = 0, k = W - 1) or leave it
    add("band_edge_runs", 128, 64, [
        (100, 130, 0, [(0, 10), (1, 30), (0, 90)]),       # D run to k = 0
        (100, 130, 10, [(0, 10), (1, 30), (0, 90)]),      # D run off the band
        (100, 60, -80, [(0, 10), (2, 23), (0, 67)]),      # I run to k = W - 1
        (100, 60, -70, [(0, 10), (2, 40), (0, 50)]),      # I run off the band
        (100, 180, 0, [(0, 100)])])                       # starts off the band
    # 2 * M + W + 8 ops and more: the op string is full
    add("full_op_string", 32, 16, [
        (3, 120, 110, [(0, 3)]), (3, 88, 80, [(0, 3)]), (32, 0, 0, []),
        (30, 87, 50, [(1, 10), (0, 30)])])
    # the band is no multiple of 16: the kernel copies its tiles by bytes
    add("odd_band", 160, 100, [
        (150, 170, -30, [(0, 40), (1, 45), (0, 20), (2, 70), (0, 20)]),
        (150, 150, -50, [(2, 34), (0, 116)])])
    for W, M in ((48, 200), (160, 100), (300, 40)):
        noise = rng.integers(0, 16, (6, M, W)).astype(np.uint8)
        rest = (rng.integers(0, M + 1, 6).astype(np.int32),
                rng.integers(0, M + W, 6).astype(np.int32),
                rng.integers(-W, W // 2 + 1, 6).astype(np.int32), W, M)
        gaps = rng.choice(np.array([0, 5, 10, 13, 14, 1, 2], np.uint8),
                          (6, M, W), p=[.5, .2, .2, .03, .03, .02, .02])
        if with_stop:
            cases.append((f"random_stop_w{W}", noise.copy()) + rest)
        noise[noise & 3 == 3] &= 0b1110
        cases.append((f"random_bytes_w{W}", noise) + rest)
        cases.append((f"random_gaps_w{W}", gaps) + rest)
    return cases


def walk_decisions(ops: np.ndarray, n: int) -> int:
    """Dependent decisions of one walk: one per 32 ops of each run."""
    codes = np.asarray(ops[:n])
    if codes.size == 0:
        return 0
    starts = np.concatenate([[0], np.flatnonzero(codes[1:] != codes[:-1]) + 1])
    lens = np.diff(np.concatenate([starts, [codes.size]]))
    return int(((lens + 31) // 32).sum())
