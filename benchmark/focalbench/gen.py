"""The benchmark's inputs: simulated HiFi reads with exact alignment truth.

A frozen counterpart of the program's simulator (``testing/simulate.py``,
``testing/fetch_timing.py::write_chromosome``, ``testing/auto_cases.py``),
written so that the seed changes no amount of work:

- every parameter that sets the work comes from the traffic file: region
  widths and order, coverage, the SV list (kind, size, zygosity), the SNP
  count, the multiset of read lengths;
- the seed chooses only bases, read placement and errors, the order of the
  read lengths, and positions jittered inside fixed slots.

A *segment* is one stretch of reference simulated on its own (one target
region, or one whole chromosome of a genome).  ``plan`` lays out the
segments of a traffic mix; ``simulate`` makes one segment's reference,
haplotypes and reads.  Nothing here imports the program.
"""

from __future__ import annotations

import bisect
import statistics
from dataclasses import dataclass, field

import numpy as np

CMATCH, CINS, CDEL, CSOFT = 0, 1, 2, 4


@dataclass
class SV:
    kind: str            # "DEL" | "INS"
    pos: int             # 0-based, in the segment: the base before the event
    length: int
    gt: str              # "0/1" | "1/1"
    seq: np.ndarray | None = None

    def on_hap(self, h: int) -> bool:
        return self.gt == "1/1" or (self.gt == "0/1" and h == 0)


@dataclass
class Segment:
    """One stretch of reference simulated on its own."""
    chrom: str
    offset: int          # where it starts on its chromosome
    width: int
    seed: int
    svs: list[SV]
    n_snps: int
    n_reads: int
    bed: tuple[int, int] | None = None   # (start, end) on the chromosome


@dataclass
class Plan:
    """A traffic mix's inputs before any base is drawn."""
    kind: str
    chroms: list[tuple[str, int]]          # (name, length)
    segments: list[Segment]

    @property
    def bed(self) -> list[tuple[str, int, int]]:
        return [(s.chrom, s.bed[0], s.bed[1]) for s in self.segments
                if s.bed is not None]


@dataclass
class SimSegment:
    seg: Segment
    ref: np.ndarray                        # uint8 codes A0 C1 G2 T3
    haps: tuple[np.ndarray, np.ndarray]
    # each haplotype's (hap_start, hap_end, ref_start, kind) pieces
    hap_segments: tuple[list, list]
    svs: list[SV]
    snps: np.ndarray                       # (n, 4): pos, ref, alt, hap (0/1)
    reads: list = field(default_factory=list)   # Read
    spans: np.ndarray | None = None        # (n, 3): pos, end, hap a read

    def reads_in(self, s: int, e: int) -> int:
        """How many reads overlap [s, e) on the chromosome."""
        sp = self.spans
        return int(((sp[:, 0] < e) & (sp[:, 1] > s)).sum())


@dataclass
class Read:
    name: str
    hap: int
    pos: int             # on the chromosome
    cigar: np.ndarray    # (n, 2): op, length
    seq: np.ndarray
    n_sub: int           # substitutions drawn into it


def segment_seed(seed: int, index: int) -> int:
    """Segment ``index``'s generator seed: the only thing the run's seed
    sets."""
    return int(np.random.SeedSequence([int(seed) & (2**63 - 1),
                                       index]).generate_state(1)[0])


def read_lengths(n: int, mean: int, sd: int, lo: int) -> np.ndarray:
    """The fixed multiset of read lengths: the normal quantiles at
    (k + 1/2) / n, clipped below; the seed only orders them."""
    nd = statistics.NormalDist(mean, sd)
    q = np.array([nd.inv_cdf((k + 0.5) / n) for k in range(n)])
    return np.maximum(np.rint(q), lo).astype(np.int64)


def n_reads(coverage: float, width: int, read_len_mean: int) -> int:
    """The simulator's read count: coverage x width / mean read length."""
    return max(int(coverage * width / read_len_mean), 4)


def plan(traffic: dict, seed: int) -> Plan:
    kind = traffic["kind"]
    if kind == "target_tiles":
        return _plan_target(traffic, seed)
    if kind == "genome":
        return _plan_genome(traffic, seed)
    raise ValueError(f"unknown traffic kind {kind!r}")


def _plan_target(t: dict, seed: int) -> Plan:
    """Regions of fixed widths laid end to end on one chromosome, each with
    the simulator's default content (``svs``: a fraction of the width, a
    size and a zygosity each) and max(min_snps, width / snp_every) SNPs."""
    widths = [t["widths"][i % len(t["widths"])] for i in range(t["n_regions"])]
    segs, off = [], 0
    for i, w in enumerate(widths):
        svs = [SV(s["kind"], w * s["at"][0] // s["at"][1], s["length"],
                  s["gt"]) for s in t["svs"]]
        trim = t["bed_trim"]
        segs.append(Segment(t["chrom"], off, w, segment_seed(seed, i), svs,
                            max(t["min_snps"], w // t["snp_every"]),
                            n_reads(t["coverage"], w, t["read_len_mean"]),
                            bed=(off + trim, off + w - trim)))
        off += w
    return Plan("target_tiles", [(t["chrom"], off)], segs)


def _plan_genome(t: dict, seed: int) -> Plan:
    """Chromosomes with one SV in each of ``svs_per_chrom`` equal slots,
    sizes cycled from a fixed list, kind and zygosity alternating; the seed
    jitters each SV by up to ``jitter`` around the middle of its slot."""
    n_sv, L = t["svs_per_chrom"], t["chrom_len"]
    slot = L // n_sv
    sizes, kinds, gts = t["sv_sizes"], t["sv_kinds"], t["sv_gts"]
    segs, chroms, k = [], [], 0
    for ci in range(t["chroms"]):
        name = f"chr{ci + 1}"
        rng = np.random.default_rng(segment_seed(seed, 10_000 + ci))
        jit = rng.integers(-t["jitter"], t["jitter"] + 1, n_sv)
        svs = []
        for j in range(n_sv):
            svs.append(SV(kinds[k % len(kinds)],
                          j * slot + slot // 2 + int(jit[j]),
                          sizes[k % len(sizes)],
                          gts[(k // len(kinds)) % len(gts)]))
            k += 1
        segs.append(Segment(name, 0, L, segment_seed(seed, ci), svs,
                            L // t["snp_every"],
                            n_reads(t["coverage"], L, t["read_len_mean"])))
        chroms.append((name, L))
    return Plan("genome", chroms, segs)


def _snp_positions(rng, width: int, svs: list[SV], n: int) -> np.ndarray:
    """n SNP positions, one in each of n equal slots of the stretch left
    free by the SVs (100 bp around each), jittered inside the middle third
    of its slot."""
    zones = sorted((max(50, s.pos - 100),
                    min(width - 50, s.pos + s.length + 100)) for s in svs)
    free, cur = [], 50
    for a, b in zones:
        if a > cur:
            free.append((cur, a))
        cur = max(cur, b)
    if width - 50 > cur:
        free.append((cur, width - 50))
    lens = np.array([b - a for a, b in free], np.int64)
    cum = np.concatenate([[0], np.cumsum(lens)])
    step = cum[-1] / n
    u = (np.arange(n) + 0.5) * step + rng.uniform(-step / 3, step / 3, n)
    u = np.clip(u.astype(np.int64), 0, cum[-1] - 1)
    idx = np.searchsorted(cum, u, side="right") - 1
    starts = np.array([a for a, _ in free], np.int64)
    return starts[idx] + (u - cum[idx])


def _apply(ref: np.ndarray, svs: list[SV], snps: np.ndarray, h: int):
    base = ref.copy()
    on = snps[:, 3] == h
    base[snps[on, 0]] = snps[on, 2]
    parts, segs, rpos, hpos = [], [], 0, 0
    for ev in sorted((s for s in svs if s.on_hap(h)), key=lambda s: s.pos):
        if ev.pos > rpos:
            parts.append(base[rpos:ev.pos])
            segs.append((hpos, hpos + ev.pos - rpos, rpos, "M"))
            hpos += ev.pos - rpos
            rpos = ev.pos
        if ev.kind == "DEL":
            rpos += ev.length
        else:
            parts.append(ev.seq)
            segs.append((hpos, hpos + ev.length, rpos, "I"))
            hpos += ev.length
    parts.append(base[rpos:])
    segs.append((hpos, hpos + len(ref) - rpos, rpos, "M"))
    return np.concatenate(parts), segs


def _true_cigar(segs: list, starts: list, hstart: int, hend: int):
    """Exact CIGAR of hap[hstart:hend) against the reference: (ref start,
    ops); leading and trailing insertions become soft clips."""
    ops, ref_start, prev_end = [], None, None
    for k in range(max(0, bisect.bisect_right(starts, hstart) - 1), len(segs)):
        hs, he, rs, kind = segs[k]
        if hs >= hend:
            break
        s, e = max(hs, hstart), min(he, hend)
        if s >= e:
            continue
        if kind == "M":
            r0 = rs + (s - hs)
            if ref_start is None:
                ref_start = r0
            if prev_end is not None and r0 > prev_end:
                ops.append([CDEL, r0 - prev_end])
            ops.append([CMATCH, e - s])
            prev_end = r0 + (e - s)
        else:
            ops.append([CINS, e - s])
            if ref_start is None:
                ref_start = prev_end = rs
    if ops and ops[0][0] == CINS:
        ops[0][0] = CSOFT
    if ops and ops[-1][0] == CINS:
        ops[-1][0] = CSOFT
    return int(ref_start or 0), np.array(ops, np.int32).reshape(-1, 2)


def simulate(seg: Segment, t: dict) -> SimSegment:
    """One segment: a random reference, its two haplotypes with the plan's
    SVs and het SNPs, and its reads (lengths from the fixed multiset,
    haplotypes alternating, placement and substitutions from the seed)."""
    rng = np.random.default_rng(seg.seed)
    w = seg.width
    ref = rng.integers(0, 4, w, dtype=np.uint8)
    svs = [SV(s.kind, s.pos, s.length, s.gt,
              rng.integers(0, 4, s.length, dtype=np.uint8)
              if s.kind == "INS" else None) for s in seg.svs]
    pos = _snp_positions(rng, w, svs, seg.n_snps)
    alt = (ref[pos] + rng.integers(1, 4, len(pos))) % 4
    hap = rng.integers(0, 2, len(pos))
    snps = np.stack([pos, ref[pos], alt, hap], 1).astype(np.int64)
    h0, s0 = _apply(ref, svs, snps, 0)
    h1, s1 = _apply(ref, svs, snps, 1)
    sim = SimSegment(seg, ref, (h0, h1), (s0, s1), svs, snps)
    lens = read_lengths(seg.n_reads, t["read_len_mean"], t["read_len_sd"],
                        t["read_len_min"])
    lens = lens[rng.permutation(len(lens))]
    starts_of = ([s[0] for s in s0], [s[0] for s in s1])
    sub = t["sub_rate"]
    tag = f"{seg.chrom}_{seg.offset}"
    for i, rl in enumerate(lens):
        h = i % 2
        hs = (h0, h1)[h]
        rl = int(min(rl, len(hs)))
        hstart = int(rng.integers(0, len(hs) - rl + 1))
        rstart, cigar = _true_cigar((s0, s1)[h], starts_of[h], hstart,
                                    hstart + rl)
        if not (cigar[:, 0] == CMATCH).any():
            continue
        seq = hs[hstart:hstart + rl].copy()
        n_sub = int(round(sub * rl))    # a fixed count, placed by the seed
        at = rng.integers(0, rl, n_sub)
        seq[at] = (seq[at] + rng.integers(1, 4, n_sub)) % 4
        sim.reads.append(Read(f"{tag}_r{i}_h{h + 1}", h,
                              seg.offset + rstart, cigar, seq, n_sub))
    sim.reads.sort(key=lambda r: r.pos)
    return sim


def read_bases(sim: SimSegment) -> int:
    return int(sum(len(r.seq) for r in sim.reads))
