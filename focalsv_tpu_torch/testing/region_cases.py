"""Seeded delta chunks for the region step (kernel B2 and its plain
version), shared by chip_smoke.py and the tests.

Each case is a chunk buffer packed by ``wire.pack_delta_chunk`` with the
step's arguments.  The tiles keep the host encoder's invariants: reads lie
in the region, a read has at most one substitution a column, and its
substitutions and deletion runs are disjoint and inside its span.  The
cases cover padded tail regions, regions with 0 and 1 het sites, more het
columns than strips and tied balances, true lengths below S, not a multiple
of S and equal to L, sites exactly on the allele-fraction bands, N
substitutions, deletion runs over sites, reads that cover no site or whose
first site lies in a later block, several blocks, MECs that settle in
round 0 and in round 1 and one whose single round changes h, R 1024 with S 512 and with S 1024 (the
bitplanes in device memory), L 2^18, and the RLE result at its bucket, the
dense result, an overflowing track and a run that ends on the last column.

    from focalsv_tpu_torch.testing.region_cases import CASES, build
    buf, args = build("hifi_blocks")   # args: G, R, L, Ds, Dd, Drle, knobs
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.parallel.wire import pack_delta_chunk


class Tile:
    """The wire attributes of one region (``pack_delta_chunk`` reads)."""

    def __init__(self, ref, starts, ends, subs: dict, dels: list):
        self.ref_codes = np.asarray(ref, np.uint8)
        self.row_starts = np.asarray(starts, np.int32)
        self.row_lens = np.asarray(ends, np.int32) - self.row_starts
        # the encoder's invariants: one substitution a (read, column),
        # none inside a deletion run of its read, all inside the read's span
        spans = list(zip(starts, ends))
        cut = {(r, c) for r, a, b in dels for c in range(a, b)}
        keep = sorted((c, r, s) for (r, c), s in subs.items()
                      if (r, c) not in cut and spans[r][0] <= c < spans[r][1])
        self.subs = (np.array([k[0] for k in keep], np.int32),
                     np.array([k[1] for k in keep], np.int32),
                     np.array([k[2] for k in keep], np.uint8))
        assert all(spans[r][0] <= a < b <= spans[r][1] for r, a, b in dels)
        self.dels = tuple(np.array([d[i] for d in dels], np.int32)
                          for i in range(3))

    @property
    def region_len(self) -> int:
        return len(self.ref_codes)


def _alt(ref_base: int, k: int = 1) -> int:
    return (int(ref_base) + k) % 4


def haplotype_tile(rng, L_true, n_reads, read_len, n_sites, *, gap=None,
                   site_span=1.0, err=0.002, del_frac=0.0, n_frac=0.0,
                   tail=0):
    """Reads of two haplotypes: hap-1 reads carry the alternative base at
    each het site.  ``gap`` (a, b): no read overlaps it, so the sites on
    either side form separate blocks.  Sites lie in the first
    ``site_span`` of the region; the last ``tail`` columns are covered by no
    read.  ``del_frac``: share of hap-0 reads that get a deletion run over a
    site; ``n_frac``: share of reads with N substitutions (some at sites)."""
    ref = rng.integers(0, 4, L_true).astype(np.uint8)
    hi = L_true - tail
    starts, ends, haps = [], [], []
    while len(starts) < n_reads:
        s = int(rng.integers(0, max(hi - read_len, 1)))
        e = min(s + read_len + int(rng.integers(-read_len // 4,
                                                read_len // 4 + 1)), hi)
        if gap and s < gap[1] and e > gap[0]:
            continue
        starts.append(s)
        ends.append(max(e, s + 1))
        haps.append(int(rng.integers(0, 2)))
    site_hi = max(int(L_true * site_span) - 1, 1)
    sites = np.sort(rng.choice(np.arange(1, site_hi), min(n_sites, site_hi - 1),
                               replace=False)) if n_sites else np.zeros(0, int)
    subs, dels = {}, []
    for r in range(n_reads):
        s, e = starts[r], ends[r]
        for c in np.nonzero(rng.random(e - s) < err)[0] + s:
            subs[(r, int(c))] = _alt(ref[c], int(rng.integers(1, 4)))
        for c in sites[(sites >= s) & (sites < e)]:
            if haps[r] == 1:
                subs[(r, int(c))] = _alt(ref[c])
            elif rng.random() < del_frac and c + 3 < e:
                dels.append((r, int(c) - 1 if c - 1 >= s else int(c),
                             int(c) + 3))
        if rng.random() < n_frac:
            for c in rng.integers(s, e, 3):
                subs[(r, int(c))] = 4
            hit = sites[(sites >= s) & (sites < e)]
            if hit.size:
                subs[(r, int(hit[0]))] = 4
    # deletion runs of one read must not overlap
    dels.sort()
    merged = []
    for r, a, b in dels:
        if merged and merged[-1][0] == r and a <= merged[-1][2]:
            merged[-1] = (r, merged[-1][1], max(b, merged[-1][2]))
        else:
            merged.append((r, a, b))
    return Tile(ref, starts, ends, subs, merged)


def band_tile(rng, segments):
    """One segment of 64 columns for each (depth, minor): ``depth`` reads
    span the segment and ``minor`` of them carry another base at its middle
    column, so the column's counts are exactly (depth - minor, minor)."""
    L_true = 64 * len(segments)
    ref = rng.integers(0, 4, L_true).astype(np.uint8)
    starts, ends, subs = [], [], {}
    for k, (depth, minor) in enumerate(segments):
        a, mid = 64 * k, 64 * k + 32
        for i in range(depth):
            r = len(starts)
            starts.append(a)
            ends.append(a + 64)
            if i < minor:
                subs[(r, mid)] = _alt(ref[mid])
    return Tile(ref, starts, ends, subs, [])


def mec_tile(rng):
    """Three sites in one block whose chained parity start is wrong: 10
    reads over sites 1-2 alone flip their phase, 4 reads over all three and
    8 over sites 0 and 2 (N at site 1) keep it.  The first MEC round changes
    h at site 2, the second leaves it: the MEC settles in round 1."""
    L_true = 4096
    ref = rng.integers(0, 4, L_true).astype(np.uint8)
    sites = (1000, 1500, 2000)
    groups = [((900, 1600), [(0, 0)] * 4 + [(1, 1)] * 4),
              ((1400, 2100), [(0, 1)] * 5 + [(1, 0)] * 5),
              ((900, 2100), [(0, 0, 0)] * 3 + [(1, 1, 1)]),
              ((900, 2100), [(0, None, 0)] * 8)]
    starts, ends, subs = [], [], {}
    for (a, b), patterns in groups:
        cols = [c for c in sites if a <= c < b]
        for pat in patterns:
            r = len(starts)
            starts.append(a)
            ends.append(b)
            for c, v in zip(cols, pat):
                if v is None:
                    subs[(r, c)] = 4            # N: neither allele
                elif v == 1:
                    subs[(r, c)] = _alt(ref[c])
    return Tile(ref, starts, ends, subs, [])


def _pow2(n: int, lo: int) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def chunk(tiles, *, L=None, Drle="bucket", R=None, **knobs):
    """Pack tiles (None = a padded slot) into one delta chunk at buckets
    like the pipeline's: R, Ds and Dd powers of two, L a power of two from
    4096 up.  Returns (buf, args)."""
    real = [t for t in tiles if t is not None]
    R = R or _pow2(max(len(t.row_starts) for t in real), 8)
    L = L or _pow2(max(t.region_len for t in real), 4096)
    Ds = _pow2(max(max(t.subs[0].size for t in real), 1), 8)
    Dd = _pow2(max(max(t.dels[0].size for t in real), 1), 8)
    if Drle == "bucket":
        Drle = max(128, L // 512)
    G = len(tiles)
    buf = pack_delta_chunk(tiles, list(range(G)), G, R, L, Ds, Dd)
    return buf, dict(G=G, R=R, L=L, Ds=Ds, Dd=Dd, Drle=Drle, **knobs)


def _hifi(seed, **kw):
    rng = np.random.default_rng(seed)
    return rng, [haplotype_tile(rng, 12000, 48, 2500, 40, gap=(6000, 6400),
                                site_span=0.65, tail=300, del_frac=0.1,
                                n_frac=0.1),
                 haplotype_tile(rng, 9000, 40, 3000, 25), None, None]


def _bands(seed, **knobs):
    rng = np.random.default_rng(seed)
    segs = [(8, 2), (4, 2), (7, 2), (9, 2), (3, 2), (4, 1), (8, 4), (6, 3),
            (12, 3), (5, 2)]
    return chunk([band_tile(rng, segs), band_tile(rng, segs[::-1])],
                 **knobs)


def _case_hifi_blocks():
    return chunk(_hifi(1)[1])


def _case_hifi_dense():
    return chunk(_hifi(1)[1], Drle=0)


def _case_hifi_overflow():
    return chunk(_hifi(1)[1], Drle=2)


def _case_zero_and_one_het():
    rng = np.random.default_rng(2)
    return chunk([haplotype_tile(rng, 5000, 30, 2000, 0),
                  haplotype_tile(rng, 5000, 30, 2000, 1)])


def _case_crowded_strips():
    # 16 strips of 250 columns, 120 het columns with equal balances
    rng = np.random.default_rng(3)
    t = haplotype_tile(rng, 4000, 24, 4000, 120, err=0.0)
    return chunk([t], max_sites=16)


def _case_lengths():
    # true lengths below S, not a multiple of S, and equal to L
    rng = np.random.default_rng(4)
    return chunk([haplotype_tile(rng, 300, 16, 200, 6),
                  haplotype_tile(rng, 5000, 40, 2000, 30),
                  haplotype_tile(rng, 8192, 40, 3000, 30, tail=50)])


def _case_bands():
    return _bands(5)


def _case_bands_half():
    # the upper band at 1/2: minor counts exactly half the depth are on it
    return _bands(6, hi_num=1, hi_den=2, min_minor_count=1)


def _case_mec_settles_late():
    return chunk([mec_tile(np.random.default_rng(7))])


def _case_mec_one_round():
    # one round, and it changes h: the loop ends on its count
    return chunk([mec_tile(np.random.default_rng(7))], mec_iters=1)


def _case_r1024_s512():
    rng = np.random.default_rng(8)
    return chunk([haplotype_tile(rng, 60000, 1024, 2000, 700, err=0.001)])


def _case_r1024_s1024():
    rng = np.random.default_rng(8)
    return chunk([haplotype_tile(rng, 60000, 1024, 2000, 700, err=0.001)],
                 max_sites=1024)


def _case_l262144():
    rng = np.random.default_rng(9)
    return chunk([haplotype_tile(rng, 1 << 18, 256, 20000, 300, tail=700,
                                 err=0.0005)])


CASES = {
    "hifi_blocks": _case_hifi_blocks,
    "hifi_dense": _case_hifi_dense,
    "hifi_overflow": _case_hifi_overflow,
    "zero_and_one_het": _case_zero_and_one_het,
    "crowded_strips": _case_crowded_strips,
    "lengths": _case_lengths,
    "bands": _case_bands,
    "bands_half": _case_bands_half,
    "mec_settles_late": _case_mec_settles_late,
    "mec_one_round": _case_mec_one_round,
    "r1024_s512": _case_r1024_s512,
    "r1024_s1024": _case_r1024_s1024,
    "l262144": _case_l262144,
}


def build(name: str):
    """(buf, args) of one case: the chunk's uint8 buffer and the step's
    keyword arguments (G, R, L, Ds, Dd, Drle and any knob it sets)."""
    return CASES[name]()
