"""Inputs of kernel B6 (the pair-HMM forward pass), made by numpy from a seed.

Each case is a batch of read windows against one or two haplotype windows,
as ``ops/pairhmm.py::site_allele_loglik`` hands them to the kernel.  The CPU
tests run B6's own source on them (``testing/host_kernel.py::pairhmm``), the
card tests and ``chip_smoke.py`` phase 9 run the kernel; both hold it to
the plain version, ``pairhmm_forward_batch_plain``.

    case = pairhmm_cases.build("realign")
    case["reads"], case["read_lens"], case["quals"], case["haps"]
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.ops.pairhmm import (pairhmm_forward_batch_plain,
                                           pairhmm_forward_kernel)

N_CODE, PAD = 4, 5


def windows(seed: int, B: int, M: int, N: int, quals: bool = True,
            kinds: int = 7) -> dict:
    """B read windows of up to M bases cut from haplotype windows of up to
    N bases: exact, one substitution, a deletion, an insertion, an N base,
    a read of 0 to 3 bases, low qualities (by b % kinds), padded with code
    5 beyond each length; the alt haplotype differs from the ref at its
    middle base, as a het site's windows do."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, M), PAD, np.uint8)
    ref = np.full((B, N), PAD, np.uint8)
    q = np.full((B, M), 30, np.int32)
    rl = np.zeros(B, np.int32)
    hl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(max(2, N // 2), N + 1))
        hap = rng.integers(0, 4, n).astype(np.uint8)
        lo = int(rng.integers(0, max(1, n - M) + 1))
        read = hap[lo: lo + M].copy()
        kind = b % kinds
        if kind == 1 and len(read):
            k = int(rng.integers(0, len(read)))
            read[k] = (read[k] + 1) % 4
        elif kind == 2 and len(read) > 2:
            read = np.delete(read, int(rng.integers(1, len(read) - 1)))
        elif kind == 3 and len(read) > 2:
            k = int(rng.integers(1, len(read) - 1))
            read = np.insert(read, k, rng.integers(0, 4))[:M]
        elif kind == 4 and len(read):
            read[int(rng.integers(0, len(read)))] = N_CODE
        elif kind == 5:
            read = read[: int(rng.integers(0, 4))]
        elif kind == 6:
            q[b] = rng.integers(2, 41, M)
        reads[b, : len(read)] = read
        ref[b, :n] = hap
        rl[b], hl[b] = len(read), n
    alt = ref.copy()
    mid = np.maximum(hl // 2, 0)
    has = hl > 0
    alt[has, mid[has]] = (alt[has, mid[has]] + 1) % 4
    return dict(reads=reads, read_lens=rl, quals=q if quals else None,
                haps=[(ref, hl), (alt, hl.copy())], max_read=M,
                gaps=dict(gap_open=1e-3, gap_extend=0.1))


def _read_lens(seed: int) -> dict:
    """read_len 0, 1, M - 1 and M beside ordinary ones."""
    c = windows(seed, 16, 29, 29)
    c["read_lens"][:4] = [0, 1, 28, 29]
    c["reads"][2:4, :] = c["haps"][0][0][2:4, :29]
    c["haps"][0][1][:4] = c["haps"][1][1][:4] = 29
    return c


def _short_haps(seed: int) -> dict:
    """Haplotype windows shorter than the read, and of length 0."""
    c = windows(seed, 16, 29, 29)
    rng = np.random.default_rng(seed)
    for hap, hl in c["haps"]:
        hl[:] = np.minimum(hl, c["read_lens"] - rng.integers(1, 8, 16))
        hl[::5] = 0
        np.maximum(hl, 0, out=hl)
    return c


def _codes(seed: int) -> dict:
    """N and pad codes inside the reads and the windows, quals absent."""
    c = windows(seed, 16, 29, 29, quals=False)
    rng = np.random.default_rng(seed)
    for arr in (c["reads"], c["haps"][0][0], c["haps"][1][0]):
        mask = rng.random(arr.shape) < 0.15
        arr[mask] = rng.choice([N_CODE, PAD], mask.sum())
    return c


def _end_inf(seed: int) -> dict:
    """Empty reads: row 0 is the end cell and lse2(LOG0, LOG0) is -inf, so
    every diagonal's term reads LOG0 and the result is -inf; empty
    haplotype windows: no valid cell at all."""
    c = windows(seed, 8, 29, 29)
    c["read_lens"][::2] = 0
    c["haps"][1][1][1::4] = 0
    return c


def _odd_lens(seed: int) -> dict:
    """Lengths past the arrays: a read_len above M and below 0, hap_lens
    above N (the haplotype index clamps to N - 1 and only the diagonals up
    to M + N exist) and below 0, five pairs a warp."""
    c = windows(seed, 12, 40, 36)
    rl = c["read_lens"]
    (_, hl0), (_, hl1) = c["haps"]
    rl[:3] = [43, -2, 40]
    hl0[2] = hl1[2] = 100
    hl0[3], hl1[3], hl0[4], hl1[5] = 50, 80, -5, 1000
    return _warp(c, 5)


def _gaps(seed: int) -> dict:
    """Gap costs other than the defaults (the reference's jit takes only
    the defaults; the port takes any)."""
    c = windows(seed, 16, 29, 29)
    c["gaps"] = dict(gap_open=0.01, gap_extend=0.3)
    return c


def _warp(c: dict, pairs_per_warp: int) -> dict:
    """B6's warps take this many (read, window) pairs each (the wrapper's
    choice for a batch of the size would be one)."""
    c["pairs_per_warp"] = pairs_per_warp
    return c


# the CPU tests' cases (small B): name -> the case made from a seed
CASES = {
    "realign": lambda s: windows(s, 24, 29, 29),
    # both windows of a read in a warp, then the next read's
    "realign_4_a_warp": lambda s: _warp(windows(s, 24, 29, 29), 4),
    # three pairs a warp: a warp's first or last read has one window
    "wide_48x64": lambda s: _warp(_widen(windows(s, 12, 48, 64)), 3),
    # reads of up to 95 bases: three strips of 32 rows
    "wide_95x96": lambda s: _warp(windows(s, 8, 95, 96), 4),
    "wide_100x120": lambda s: windows(s, 8, 100, 120),
    "wide_127x140": lambda s: windows(s, 6, 127, 140),
    # past 128 bases: five strips of 32 rows and a sixth for the reads
    # that reach 160 with row 0; the workspaces in shared memory
    "wide_160x180": lambda s: windows(s, 4, 160, 180),
    # ten strips, the workspaces in device scratch
    "wide_300x320": lambda s: windows(s, 4, 300, 320),
    "read_lens": _read_lens,
    "short_haps": lambda s: _warp(_short_haps(s), 2),
    "codes_no_quals": _codes,
    "end_inf": lambda s: _warp(_end_inf(s), 6),
    "odd_lens": _odd_lens,
    "gaps": _gaps,
}


def _widen(c: dict) -> dict:
    """The alt window narrower than the ref one (N 40 against 64): the two
    haplotypes of one launch may differ in width."""
    alt, hl = c["haps"][1]
    c["haps"][1] = (np.ascontiguousarray(alt[:, :40]), np.minimum(hl, 40))
    return c


def build(name: str, seed: int = 0) -> dict:
    return CASES[name](seed)


# chip_smoke.py phase 9a's synthetic shapes on the card (lengths random as
# ``windows`` makes them): 4,000 windows padded to 29 bases as the
# realignment pads them; 15,000, a stress size that no measured region
# reaches; a wide one.  The path's own traffic is timed from the inputs
# that the realignment hands the kernel (phase 9c).
CARD_SHAPES = {
    "realign_B4000": lambda s: windows(s, 4000, 29, 29),
    "stress_B15000": lambda s: windows(s, 15000, 29, 29),
    "wide_48x64_B4000": lambda s: _widen(windows(s, 4000, 48, 64)),
}


def path_like(seed: int, B: int) -> dict:
    """B windows shaped as the realignment hands them to B6
    (phasing/realign.py, flank 10): reads of 21 bases against ref and alt
    windows of 25, all padded to 29 with code 5; the alt window differs
    from the ref at the site (column 12); each read is cut at column 2 from
    one of the two windows, one read in ten with a substitution; HiFi-like
    qualities (20 to 40)."""
    rng = np.random.default_rng(seed)
    L, R, W = 29, 21, 25
    ref = np.full((B, L), PAD, np.uint8)
    ref[:, :W] = rng.integers(0, 4, (B, W))
    alt = ref.copy()
    alt[:, 12] = (alt[:, 12] + rng.integers(1, 4, B)) % 4
    src = np.where(rng.random(B)[:, None] < 0.5, ref, alt)
    reads = np.full((B, L), PAD, np.uint8)
    reads[:, :R] = src[:, 2: 2 + R]
    sub = np.nonzero(rng.random(B) < 0.1)[0]
    k = rng.integers(0, R, len(sub))
    reads[sub, k] = (reads[sub, k] + 1) % 4
    quals = rng.integers(20, 41, (B, L)).astype(np.int32)
    lens = np.full(B, W, np.int32)
    return dict(reads=reads, read_lens=np.full(B, R, np.int32), quals=quals,
                haps=[(ref, lens), (alt, lens.copy())], max_read=L,
                gaps=dict(gap_open=1e-3, gap_extend=0.1))


def plain(case: dict, device) -> tuple:
    """The plain version on ``device``, a call a haplotype: results (n_haps,
    B) and the terms of each haplotype."""
    runs = [pairhmm_forward_batch_plain(
        case["reads"], case["read_lens"], hap, hl, case["quals"],
        max_read=case["max_read"], max_hap=hap.shape[1], device=device,
        return_terms=True, **case["gaps"]) for hap, hl in case["haps"]]
    return np.stack([r[0] for r in runs]), [r[1] for r in runs]


def kernel(case: dict, device) -> tuple:
    """B6 on the CUDA ``device``, one launch: as ``plain`` returns them."""
    return pairhmm_forward_kernel(
        case["reads"], case["read_lens"],
        [(hap, hl, hap.shape[1]) for hap, hl in case["haps"]],
        case["quals"], case["max_read"], device, want_terms=True,
        pairs_per_warp=case.get("pairs_per_warp"), **case["gaps"])


def host(case: dict, **kw) -> tuple:
    """B6's own source built for the CPU, one launch: as ``plain``.
    ``kw`` goes to ``host_kernel.pairhmm`` (``smem_bytes``)."""
    from focalsv_tpu_torch.testing import host_kernel
    return host_kernel.pairhmm(case["reads"], case["read_lens"],
                               case["haps"], case["quals"],
                               case["max_read"],
                               pairs_per_warp=case.get("pairs_per_warp"),
                               **case["gaps"], **kw)


def lane_steps(read_lens, hap_lens, max_read: int, widths,
               pairs_per_warp: int) -> int:
    """The lane-steps B6 takes for these windows (32 lanes times each warp's
    steps, as csrc/pairhmm.cu lists a warp's groups), idle lanes
    included."""
    rl = np.asarray(read_lens, np.int64)
    M, B, H, K = int(max_read), len(rl), len(widths), int(pairs_per_warp)
    ok = (rl >= 1) & (rl <= M)
    w = np.stack([np.where(ok & (np.asarray(hl, np.int64) >= 1),
                           np.minimum(np.asarray(hl, np.int64),
                                      M + int(n) - rl), 0)
                  for hl, n in zip(hap_lens, widths)], axis=1)
    total = 0
    for q0 in range(0, B * H, K):
        q1 = min(q0 + K, B * H)
        start = steps = 0
        for b in range(q0 // H, (q1 - 1) // H + 1):
            cols = sum(int(w[b, h]) for h in range(H)
                       if q0 <= b * H + h < q1)
            if cols == 0:
                continue
            S = (int(rl[b]) + 31) // 32
            for s in range(S):
                rows = min(32, int(rl[b]) - 32 * s)
                steps = max(steps, start + cols + rows - 1)
                start += cols if s == S - 1 else max(cols, 32)
        total += 32 * steps
    return total


def differences(got: tuple, want: tuple) -> dict:
    """How two (results, terms) differ: the largest absolute difference of
    the finite results and of the terms, whether -inf sits at the same
    places in both, and whether the terms are the same bytes."""
    (out, terms), (out_w, terms_w) = got, want
    same_inf = bool(np.array_equal(np.isinf(out), np.isinf(out_w)) and all(
        np.array_equal(np.isinf(t), np.isinf(w))
        for t, w in zip(terms, terms_w)))
    fin = np.isfinite(out) & np.isfinite(out_w)
    return dict(
        out_err=float(np.abs(out[fin] - out_w[fin]).max(initial=0.0)),
        terms_err=max(float(np.abs(t - w)[np.isfinite(w)].max(initial=0.0))
                      for t, w in zip(terms, terms_w)),
        same_inf=same_inf and not np.isnan(out).any(),
        terms_bytes_equal=all(t.tobytes() == w.tobytes()
                              for t, w in zip(terms, terms_w)))
