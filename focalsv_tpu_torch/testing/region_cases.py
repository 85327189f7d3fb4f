"""Seeded delta chunks for the region step (kernel B2 and its plain
version) and dense chunks (kernel B3 and its plain version), shared by
chip_smoke.py and the tests.

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
dense result, an overflowing track and a run that ends on the last column;
runs that meet and cross the column ranges that 2 or 4 CTAs of the kernel
take, true lengths ending inside the last range, deletion runs over a whole
range, and a chunk of 51 regions.

    from focalsv_tpu_torch.testing.region_cases import CASES, build
    buf, args = build("hifi_blocks")   # args: G, R, L, Ds, Dd, Drle, knobs

The dense cases (``ROWS_CASES``, ``build_rows``) are chunks packed by
``wire.pack_rows_chunk``: each read a row of symbols from its first column
on, in a row W columns wide that starts on a block of 128.  They cover N and
DEL symbols at sites, no-coverage codes inside a row, rows that cross many
blocks, rows that run past the true length and past L, W below L and W
equal to L, padded regions, 0 and 1 het sites, crowded strips with tied
balances, a MEC that settles late, R 1024 with S 1024 (the bitplanes in
device memory), a chunk of 51 regions, sites on both sides of the
column-tile edges at 4096, 8192 (half of L, where B3's CTAs split) and
12288, reads in a few windows of a long region (tiles and CTA ranges that
no read meets), and rows whose W/2 nibble boundary falls at many places of
a tile.

    buf, args = build_rows("rows_symbols")   # args: G, R, L, W, knobs
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.parallel.wire import (BLOCK, DEL_SYM, NOCOV,
                                             pack_delta_chunk,
                                             pack_row_tile, pack_rows_chunk)


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


def edges_tile(rng):
    """A region of 16,384 columns (four tiles of the kernel) whose runs meet
    the edges of the column ranges that 2 or 4 CTAs take (4096, 8192,
    12288): a homozygous deletion ending at 4096 with substitutions from
    4096 on, a homozygous deletion across 8192, one starting at 12288 and a
    hole in the coverage after it; het sites elsewhere phase the reads."""
    L_true = 16384
    ref = rng.integers(0, 4, L_true).astype(np.uint8)
    hole = (12500, 12700)
    starts, ends = [], []
    for s in range(0, L_true - 1500, 350):
        e = min(s + 3000 + int(rng.integers(0, 800)), L_true)
        if s < hole[1] and e > hole[0]:
            e = hole[0] if s < hole[0] else e
            if s < hole[1] and s >= hole[0]:
                s = hole[1]
        if e - s > 200:
            starts.append(s)
            ends.append(e)
    haps = rng.integers(0, 2, len(starts))
    pinned = set(range(4080, 4102)) | set(range(8150, 8230)) | set(
        range(12288, 12296))
    sites = [c for c in np.sort(rng.choice(np.arange(200, L_true - 200), 40,
                                           replace=False))
             if int(c) not in pinned and not hole[0] <= c < hole[1]]
    subs, dels = {}, []
    for r, (s, e) in enumerate(zip(starts, ends)):
        for a, b in ((4080, 4096), (8150, 8230), (12288, 12296)):
            if max(a, s) < min(b, e):
                dels.append((r, max(a, s), min(b, e)))
        for c in range(4096, 4102):
            if s <= c < e:
                subs[(r, c)] = _alt(ref[c], 1 + c % 3)
        for c in sites:
            if s <= c < e and haps[r]:
                subs[(r, int(c))] = _alt(ref[c])
    return Tile(ref, starts, ends, subs, dels)


def _case_range_edges():
    rng = np.random.default_rng(10)
    return chunk([edges_tile(rng), None])


def _case_ltrue_in_last_range():
    # true lengths past the last range's start (12288 of 16384, and one
    # column past it) with their uncovered tails
    rng = np.random.default_rng(11)
    return chunk([haplotype_tile(rng, 14000, 40, 3000, 20, tail=200),
                  haplotype_tile(rng, 12289, 30, 2500, 10, tail=90)])


def _case_del_spans_range():
    # deletion runs over a whole range of 4 CTAs ([4096, 8192)) and of 2
    # ([0, 8192)), in the hap-0 reads
    rng = np.random.default_rng(12)
    t = haplotype_tile(rng, 16384, 48, 3000, 30)
    starts = list(t.row_starts) + [2000] * 6 + [0] * 6
    ends = list(t.row_starts + t.row_lens) + [10000] * 6 + [9000] * 6
    subs = {(int(r), int(c)): int(v) for c, r, v in zip(*t.subs)}
    n = len(t.row_starts)
    dels = [tuple(int(x) for x in d) for d in zip(*t.dels)]
    dels += [(n + i, 3000, 8300) for i in range(0, 6, 2)]
    dels += [(n + 6 + i, 100, 8400) for i in range(0, 6, 2)]
    return chunk([Tile(t.ref_codes, starts, ends, subs, dels)])


def _case_g51():
    # the batch of the L 131072 chunk: 51 regions, 3 of them padded slots
    rng = np.random.default_rng(13)
    tiles = [haplotype_tile(rng, int(rng.integers(3000, 8192)), 16, 1500, 4)
             for _ in range(48)]
    return chunk(tiles + [None] * 3)


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
    "range_edges": _case_range_edges,
    "ltrue_in_last_range": _case_ltrue_in_last_range,
    "del_spans_range": _case_del_spans_range,
    "g51": _case_g51,
}


def pipeline_delta_chunks(n_regions: int = 8, seed0: int = 1000):
    """The delta chunks of chip_smoke.py's phase 4: simulated HiFi regions
    of bench.py's sizes (15, 30, 50, 100 kb, cycling) at 30x from seeds
    seed0 + i, tiled by the pipeline's build_tile and packed one chunk a
    bucket at the pipeline's batch size for one device.  Returns
    [(key, buf, args)] in bucket order, args as build() gives them."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.testing import simulate as sim
    cfg = preset("HIFI")
    sizes = (15_000, 30_000, 50_000, 100_000)
    tiles = []
    for i in range(n_regions):
        L = sizes[i % len(sizes)]
        rg = sim.simulate_region(seed=seed0 + i, ref_len=L, coverage=30.0,
                                 n_snps=max(10, L // 1200))
        tiles.append(dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg))
    buckets: dict = {}
    for i, t in enumerate(tiles):
        key = dx._bucket_key(t, cfg)
        if key is not None and key[0] == "delta":
            buckets.setdefault(key, []).append(i)
    out = []
    for key, idxs in sorted(buckets.items()):
        G = dx._batch_size(key, cfg, 1)
        chunk_ = idxs + [len(tiles)] * (G - len(idxs))
        _, R, L, Ds, Dd = key
        out.append((key, dx.pack_chunk(tiles + [None], chunk_, key, G),
                    dict(rs.phase_consensus_kwargs(cfg.phasing), G=G, R=R,
                         L=L, Ds=Ds, Dd=Dd, Drle=dx.drle_of(key))))
    return out


def build(name: str):
    """(buf, args) of one case: the chunk's uint8 buffer and the step's
    keyword arguments (G, R, L, Ds, Dd, Drle and any knob it sets)."""
    return CASES[name]()


# -- dense (rows) chunks ------------------------------------------------------

class RowsTile:
    """The wire attributes of one dense region (``pack_rows_chunk`` reads):
    each read's symbols (0-4, DEL_SYM, NOCOV) from region column starts[i]
    on, placed at starts[i] % BLOCK of a row W columns wide."""

    def __init__(self, rows, starts, region_len: int, W: int):
        starts = np.asarray(starts, np.int64)
        offs = starts % BLOCK
        assert all(o + len(r) <= W for o, r in zip(offs, rows)), W
        self.nib = pack_row_tile([np.asarray(r, np.uint8) for r in rows], W,
                                 offsets=offs)
        self.q_starts = (starts // BLOCK).astype(np.int32)
        self.region_len = int(region_len)


def rows_from_delta(t: Tile, W: int) -> RowsTile:
    """A delta tile's reads as dense rows: the reference over each span, its
    substitutions, DEL over its deletion runs."""
    rows = []
    for r, (s, n) in enumerate(zip(t.row_starts, t.row_lens)):
        row = t.ref_codes[s:s + n].copy()
        pos, read, sym = t.subs
        mine = read == r
        row[pos[mine] - s] = sym[mine]
        dr, da, db = t.dels
        for a, b in zip(da[dr == r], db[dr == r]):
            row[a - s:b - s] = DEL_SYM
        rows.append(row)
    return RowsTile(rows, t.row_starts, t.region_len, W)


def noisy_rows_tile(rng, L_true, n_reads, read_len, n_sites, W,
                    **kw) -> RowsTile:
    """Noisy reads of two haplotypes as dense rows (noisy_rows)."""
    rows, starts = noisy_rows(rng, L_true, n_reads, read_len, n_sites, **kw)
    return RowsTile(rows, starts, L_true, W)


def noisy_rows(rng, L_true, n_reads, read_len, n_sites, *, sites=None,
               err=0.05, del_rate=0.02, n_rate=0.01, site_del=0.0,
               site_n=0.0, hole_frac=0.0, over=0, full=False):
    """Noisy reads of two haplotypes as rows of symbols and their first
    columns: hap-1 reads carry
    another base at each het site (``sites``, or n_sites drawn); every
    column of a read takes a substitution (err), a DEL (del_rate) or an N
    (n_rate); at a site a read shows DEL with chance site_del and N with
    chance site_n; hole_frac of the reads hold a run of no-coverage codes
    inside their row; reads may run ``over`` columns past L_true.
    ``full``: every read spans the region and half are hap-1 (tied
    balances)."""
    span = L_true + over
    ref = rng.integers(0, 4, span).astype(np.uint8)
    if sites is None:
        sites = np.sort(rng.choice(np.arange(1, L_true - 1), n_sites,
                                   replace=False))
    sites = np.asarray(sites, np.int64)
    alt = ((ref[sites] + rng.integers(1, 4, len(sites))) % 4).astype(
        np.uint8)
    rows, starts = [], []
    for i in range(n_reads):
        if full:
            s, e, hap = 0, L_true, i % 2
        else:
            n = read_len + int(rng.integers(-read_len // 4, read_len // 4 + 1))
            s = int(rng.integers(0, max(span - n, 1)))
            e, hap = min(s + n, span), int(rng.integers(0, 2))
        row = ref[s:e].copy()
        u = rng.random(e - s)
        sub = u < err
        row[sub] = (row[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        row[(u >= err) & (u < err + del_rate)] = DEL_SYM
        row[(u >= err + del_rate) & (u < err + del_rate + n_rate)] = 4
        inside = (sites >= s) & (sites < e)
        for c, a in zip(sites[inside], alt[inside]):
            v = rng.random()
            row[c - s] = (DEL_SYM if v < site_del else
                          4 if v < site_del + site_n else
                          a if hap else ref[c])
        if rng.random() < hole_frac and e - s > 60:
            a = int(rng.integers(0, e - s - 50))
            row[a:a + int(rng.integers(5, 50))] = NOCOV
        rows.append(row)
        starts.append(s)
    return rows, starts


def windowed_rows_tile(rng, windows, L_true, W) -> RowsTile:
    """Noisy reads in windows of a region only: ``windows`` holds (first
    column, span, reads, read length, het sites) for each."""
    rows, starts = [], []
    for at, span, n_reads, read_len, n_sites in windows:
        r, s = noisy_rows(rng, span, n_reads, read_len, n_sites)
        rows += r
        starts += [at + x for x in s]
    return RowsTile(rows, starts, L_true, W)


def rows_chunk(tiles, *, R, L, W, **knobs):
    """Pack dense tiles (None = a padded slot) into one chunk
    (wire.rows_flat_layout).  Returns (buf, args)."""
    G = len(tiles)
    buf = pack_rows_chunk(tiles, list(range(G)), G, R, W)
    return buf, dict(G=G, R=R, L=L, W=W, **knobs)


# most dense cases share one shape (and one compile of the JAX function)
_STD = dict(R=64, L=8192, W=4096)


def _rows_symbols():
    # N and DEL at sites, no-coverage runs inside rows, and a padded slot
    rng = np.random.default_rng(20)
    return rows_chunk([noisy_rows_tile(rng, 8000, 60, 3000, 30, 4096,
                                       site_del=0.15, site_n=0.1,
                                       hole_frac=0.3),
                       noisy_rows_tile(rng, 6000, 40, 2500, 12, 4096,
                                       err=0.1, del_rate=0.03,
                                       site_del=0.3),
                       None,
                       noisy_rows_tile(rng, 7000, 48, 3000, 20, 4096,
                                       n_rate=0.05, hole_frac=0.6)], **_STD)


def _rows_past_ltrue_and_l():
    # reads that run past the true length and past L (their rows' ends
    # hold columns the region does not have), and true lengths below S
    rng = np.random.default_rng(21)
    return rows_chunk([noisy_rows_tile(rng, 7600, 50, 3000, 20, 4096,
                                       over=1500),
                       noisy_rows_tile(rng, 300, 12, 200, 6, 4096, over=80),
                       noisy_rows_tile(rng, 8192, 60, 3000, 25, 4096,
                                       over=1800),
                       noisy_rows_tile(rng, 5000, 30, 2500, 10, 4096,
                                       over=3000)], **_STD)


def _rows_zero_and_one_het():
    # low noise, so that no column but the one site is het
    rng = np.random.default_rng(22)
    clean = dict(err=0.002, del_rate=0.0, n_rate=0.0)
    return rows_chunk([noisy_rows_tile(rng, 5000, 30, 2000, 0, 4096, **clean),
                       noisy_rows_tile(rng, 5000, 30, 2000, 0, 4096,
                                       sites=[2500], **clean),
                       None, None], **_STD)


def _rows_mec_settles_late():
    return rows_chunk([rows_from_delta(mec_tile(np.random.default_rng(7)),
                                       4096), None, None, None], **_STD)


def _rows_w_equals_l():
    rng = np.random.default_rng(23)
    return rows_chunk([noisy_rows_tile(rng, 4096, 30, 0, 12, 4096,
                                       full=True, err=0.08),
                       noisy_rows_tile(rng, 3900, 30, 2500, 10, 4096)],
                      R=32, L=4096, W=4096)


def _rows_crowded_strips():
    # 16 strips of 250 columns, 120 het columns with equal balances
    rng = np.random.default_rng(24)
    return rows_chunk([noisy_rows_tile(rng, 4000, 24, 0, 120, 4096,
                                       full=True, err=0.0, del_rate=0.0,
                                       n_rate=0.0)],
                      R=32, L=4096, W=4096, max_sites=16)


def _rows_r1024_s1024():
    rng = np.random.default_rng(8)
    t = haplotype_tile(rng, 16000, 1024, 2000, 700, err=0.001)
    return rows_chunk([rows_from_delta(t, 2688)], R=1024, L=16384, W=2688,
                      max_sites=1024)


def _rows_g51():
    rng = np.random.default_rng(25)
    tiles = [noisy_rows_tile(rng, int(rng.integers(2000, 5000)), 16, 1500,
                             4, 2048) for _ in range(48)]
    return rows_chunk(tiles + [None] * 3, R=16, L=8192, W=2048)


def _rows_tile_edges():
    # sites on both sides of the tile edges 4096 and 12288 and of 8192, the
    # middle of L, where each of B3's CTAs takes a share of both halves
    rng = np.random.default_rng(26)
    edges = [4095, 4096, 8191, 8192, 12287, 12288]
    extra = [1000, 2500, 6000, 10000, 14000, 15500]
    return rows_chunk([noisy_rows_tile(rng, 16384, 60, 3000, 0, 4096,
                                       sites=sorted(edges + extra)),
                       noisy_rows_tile(rng, 16000, 60, 3000, 0, 4096,
                                       sites=edges, site_del=0.2)],
                      R=64, L=16384, W=4096)


def _rows_sparse_long():
    # L 65536 with rows of 8192 columns in a few windows: tiles that no read
    # meets, and CTAs (of 2 and 4 a region) whose two ranges meet none
    rng = np.random.default_rng(27)
    return rows_chunk([windowed_rows_tile(rng, [(2000, 15000, 24, 4000, 12),
                                                (45000, 9000, 20, 4000, 8)],
                                          60000, 8192),
                       windowed_rows_tile(rng, [(33000, 6000, 24, 3000, 8)],
                                          65536, 8192)],
                      R=64, L=65536, W=8192)


def _rows_straddle_half():
    # rows of 8192 columns starting on every kind of block and offset, so
    # that their W/2 nibble boundary falls at many places of a tile and of
    # each CTA's range, and reads that fill their row to its last column
    rng = np.random.default_rng(28)
    full_w = noisy_rows_tile(rng, 8192, 16, 0, 6, 8192, full=True)
    return rows_chunk([noisy_rows_tile(rng, 16000, 60, 6000, 20, 8192),
                       noisy_rows_tile(rng, 16384, 60, 6400, 16, 8192,
                                       site_del=0.1),
                       full_w],
                      R=64, L=16384, W=8192)


ROWS_CASES = {
    "rows_symbols": _rows_symbols,
    "rows_past_ltrue_and_l": _rows_past_ltrue_and_l,
    "rows_zero_and_one_het": _rows_zero_and_one_het,
    "rows_mec_settles_late": _rows_mec_settles_late,
    "rows_w_equals_l": _rows_w_equals_l,
    "rows_crowded_strips": _rows_crowded_strips,
    "rows_r1024_s1024": _rows_r1024_s1024,
    "rows_g51": _rows_g51,
    "rows_tile_edges": _rows_tile_edges,
    "rows_sparse_long": _rows_sparse_long,
    "rows_straddle_half": _rows_straddle_half,
}


# noisy reads whose tiles take the dense encoding on their own: 10 %
# substitutions, 3 % insertions, 3 % deletions (chip_smoke.py's phase 6b)
NOISY_READS = dict(sub_rate=0.10, ins_rate=0.03, del_rate=0.03)
NOISY_SIZES = (15_000, 30_000, 50_000, 100_000)   # bench.py's region sizes


def noisy_regions(n: int, seed0: int, sizes=NOISY_SIZES):
    """n simulated noisy regions at 30x cycling ``sizes``, seeds seed0 + i
    (testing/simulate.py, one SNP a 1,200 bases)."""
    from focalsv_tpu_torch.testing import simulate as sim
    return [sim.simulate_region(seed=seed0 + i,
                                ref_len=sizes[i % len(sizes)],
                                coverage=30.0,
                                n_snps=max(10, sizes[i % len(sizes)] // 1200),
                                **NOISY_READS) for i in range(n)]


def _rows_chunks(regions):
    """The regions tiled under the ONT preset and packed one dense chunk a
    bucket at the pipeline's batch size for one device: [(key, real
    regions, buf, args)] in bucket order, args as build_rows gives them."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg = preset("ONT")
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in regions]
    buckets: dict = {}
    for i, t in enumerate(tiles):
        buckets.setdefault(dx._bucket_key(t, cfg), []).append(i)
    out = []
    for key, idxs in sorted(buckets.items(), key=lambda kv: str(kv[0])):
        if key is None or key[0] != "dense":
            raise ValueError(f"a noisy tile took the bucket {key}")
        G = dx._batch_size(key, cfg, 1)
        for c0 in range(0, len(idxs), G):
            part = idxs[c0:c0 + G]
            _, R, L, W = key
            out.append((key, len(part),
                        dx.pack_chunk(tiles + [None],
                                      part + [len(tiles)] * (G - len(part)),
                                      key, G),
                        dict(rs.phase_consensus_kwargs(cfg.phasing), G=G,
                             R=R, L=L, W=W)))
    return out


def pipeline_rows_chunks(n_regions: int = 8, seed0: int = 3000):
    """The dense chunks of chip_smoke.py's phase 6b: noisy regions cycling
    bench.py's sizes, seeds seed0 + i, as the pipeline packs them (one or
    two real regions a chunk).  [(key, real regions, buf, args)]."""
    return _rows_chunks(noisy_regions(n_regions, seed0))


def full_rows_chunk(key: tuple, seed0: int = 4000):
    """One chunk of the dense bucket ``key`` whose every slot is a real
    noisy region of the size in NOISY_SIZES that the bucket takes (seeds
    seed0 + i): (key, real regions, buf, args)."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.pipeline import device_exec as dx
    G = dx._batch_size(key, preset("ONT"), 1)
    size = next(s for s in NOISY_SIZES if dx._len_bucket(s) == key[2])
    chunks = _rows_chunks(noisy_regions(G, seed0, (size,)))
    if len(chunks) != 1 or chunks[0][0] != key or chunks[0][1] != G:
        raise ValueError(f"{G} noisy regions of {size} bases did not fill "
                         f"one {key} chunk: "
                         f"{[(k, n) for k, n, _b, _a in chunks]}")
    return chunks[0]


# the buckets of phase 6b's noisy regions at the smallest and the largest
# size (chip_smoke.py times B3 on a full chunk of each)
FULL_ROWS_KEYS = (("dense", 64, 16384, 16384), ("dense", 256, 131072, 20480))


def build_rows(name: str):
    """(buf, args) of one dense case: the chunk's uint8 buffer and the
    step's keyword arguments (G, R, L, W and any knob it sets)."""
    return ROWS_CASES[name]()
