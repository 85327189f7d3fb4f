"""Auto-mode TRA/INV/DUP calling from split-read geometry.

Port of `TRA_INV_DUP_call/Auto/` (define_region.py, process_dup.py,
process_tra_inv.py): reads with multiple aligned segments are classified as
INV- (same-chrom strand flip), DUP- (same-chrom same-strand) or TRA-relevant
(cross-chrom); segment pairs that abut in forward-read space with sufficient
read coverage yield candidate intervals/breakends (process_a_pair_{inv,dup,
tra} :174-322); candidates are clustered by start then end (cluster_sig :484)
and filtered by per-dtype support/mapq/size plus coverage-feature bands
(process_dup.py :45-137, process_tra_inv.py :47-67).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.io.vcf import VcfRecord
from focalsv_tpu_torch.signatures import contig as contig_sigs

# per-dtype knobs (Auto/define_region.py:691-707, process_dup.py:55-60)
AUTO_PARAMS = {
    "HIFI": dict(cluster_dist=100, min_read_cov_inv=0.2,
                 dup_min_sup_cov=0.1, dup_min_mapq=50, dup_min_size=200),
    "CLR": dict(cluster_dist=200, min_read_cov_inv=0.2,
                dup_min_sup_cov=0.14, dup_min_mapq=50, dup_min_size=500),
    "ONT": dict(cluster_dist=300, min_read_cov_inv=0.7,
                dup_min_sup_cov=0.1, dup_min_mapq=40, dup_min_size=500),
}
DIST_THRESH_READ = 1000
MIN_READ_COV_DUP = 0.9
MIN_READ_COV_BND = 0.9
MIN_MAPQ = 10
INV_CLUSTER_DIST = 3000


@dataclass
class Segment:
    """One aligned segment of a read, with forward-read-space coordinates."""

    qname: str
    chrom: str
    strand: int                  # 0 '+', 1 '-'
    read_start_fwd: int
    read_end_fwd: int
    ref_start_fwd: int           # ref coord at the segment's fwd-read start
    ref_end_fwd: int
    read_len: int
    mapq: int


def segment_from_record(rec: bamio.BamRecord, chrom: str) -> Segment | None:
    """Forward-read-space geometry (extract_coordinates :160-172)."""
    cig = rec.cigar
    if cig.shape[0] == 0:
        return None
    ops, lens = cig[:, 0], cig[:, 1]
    qa_start = int(lens[0]) if ops[0] in (bamio.CSOFT_CLIP, bamio.CHARD_CLIP) else 0
    tail = int(lens[-1]) if ops[-1] in (bamio.CSOFT_CLIP, bamio.CHARD_CLIP) else 0
    read_len = int(lens[contig_sigs._FULL_QUERY_OPS[ops]].sum())
    qa_end = read_len - tail
    if rec.is_reverse:
        rs_fwd, re_fwd = read_len - qa_end, read_len - qa_start
        ref_s, ref_e = rec.reference_end, rec.pos
    else:
        rs_fwd, re_fwd = qa_start, qa_end
        ref_s, ref_e = rec.pos, rec.reference_end
    return Segment(qname=rec.name, chrom=chrom, strand=int(rec.is_reverse),
                   read_start_fwd=rs_fwd, read_end_fwd=re_fwd,
                   ref_start_fwd=ref_s, ref_end_fwd=ref_e,
                   read_len=read_len, mapq=rec.mapq)


def _pair_geometry(s1: Segment, s2: Segment):
    """(max_start, min_end) endpoints by fwd-read coordinate + coverage."""
    starts = sorted([(s1.read_start_fwd, s1.ref_start_fwd, 0, s1),
                     (s2.read_start_fwd, s2.ref_start_fwd, 1, s2)],
                    key=lambda x: x[:3])
    ends = sorted([(s1.read_end_fwd, s1.ref_end_fwd, 0, s1),
                   (s2.read_end_fwd, s2.ref_end_fwd, 1, s2)],
                  key=lambda x: x[:3])
    max_start_read, max_start_ref, _, max_start_seg = starts[-1]
    min_end_read, min_end_ref, _, min_end_seg = ends[0]
    cov = (s1.read_end_fwd - s1.read_start_fwd) + \
          (s2.read_end_fwd - s2.read_start_fwd)
    return (max_start_read, max_start_ref, max_start_seg,
            min_end_read, min_end_ref, min_end_seg, cov)


def pair_inv(s1: Segment, s2: Segment, dist_thresh_read: int,
             min_read_cov: float):
    msr, msf, _, mer, mef, _, cov = _pair_geometry(s1, s2)
    est_size = abs(msf - mef)
    if (abs(msr - mer) <= max(dist_thresh_read, est_size * 0.15)
            and cov / s1.read_len >= min_read_cov):
        a, b = sorted([msf, mef])
        return (a, b, (s1.mapq + s2.mapq) / 2)
    return None


def pair_dup(s1: Segment, s2: Segment, dist_thresh_read: int,
             min_read_cov: float):
    msr, msf, _, mer, mef, _, cov = _pair_geometry(s1, s2)
    if (abs(msr - mer) <= dist_thresh_read
            and cov / s1.read_len >= min_read_cov):
        a, b = sorted([msf, mef])
        return (a, b, (s1.mapq + s2.mapq) / 2)
    return None


def _chrom_rank(chrom: str) -> int:
    c = chrom[3:] if chrom.startswith("chr") else chrom
    return int(c) if c.isdigit() else 10_000


def pair_tra(s1: Segment, s2: Segment, dist_thresh_read: int,
             min_read_cov: float):
    """BND-string construction per strand combination (:286-318)."""
    if s1.chrom == s2.chrom:
        return None
    starts = sorted([(s1.read_start_fwd, 0, s1), (s2.read_start_fwd, 1, s2)],
                    key=lambda x: x[:2])
    ends = sorted([(s1.read_end_fwd, 0, s1), (s2.read_end_fwd, 1, s2)],
                  key=lambda x: x[:2])
    max_start_read, _, seg_ms = starts[-1]
    min_end_read, _, seg_me = ends[0]
    cov = (s1.read_end_fwd - s1.read_start_fwd) + \
          (s2.read_end_fwd - s2.read_start_fwd)
    if seg_ms.chrom == seg_me.chrom:
        return None
    if abs(max_start_read - min_end_read) > dist_thresh_read:
        return None
    if cov / s1.read_len < min_read_cov:
        return None
    # min-side segment = earlier on the read; max-side = later
    min_seg, max_seg = seg_me, seg_ms
    min_chrom, max_chrom = min_seg.chrom, max_seg.chrom
    min_end_ref = min_seg.ref_end_fwd
    max_start_ref = max_seg.ref_start_fwd
    min_strand = "+" if min_seg.strand == 0 else "-"
    max_strand = "+" if max_seg.strand == 0 else "-"
    first = _chrom_rank(min_chrom) < _chrom_rank(max_chrom)
    if min_strand == "+" and max_strand == "+":
        bnd = ((min_chrom, min_end_ref, f"N[{max_chrom}:{max_start_ref}[")
               if first else
               (max_chrom, max_start_ref, f"]{min_chrom}:{min_end_ref}]N"))
    elif min_strand == "-" and max_strand == "-":
        bnd = ((min_chrom, min_end_ref, f"]{max_chrom}:{max_start_ref}]N")
               if first else
               (max_chrom, max_start_ref, f"N[{min_chrom}:{min_end_ref}["))
    elif min_strand == "+" and max_strand == "-":
        bnd = ((min_chrom, min_end_ref, f"N]{max_chrom}:{max_start_ref}]")
               if first else
               (max_chrom, max_start_ref, f"N]{min_chrom}:{min_end_ref}]"))
    else:
        bnd = ((min_chrom, min_end_ref, f"[{max_chrom}:{max_start_ref}[N")
               if first else
               (max_chrom, max_start_ref, f"[{min_chrom}:{min_end_ref}[N"))
    return (*bnd, (s1.mapq + s2.mapq) / 2)


@dataclass
class ClusteredSV:
    start: int
    end: int
    support: int
    mapq: float
    std_left: float
    std_right: float


def cluster_candidates(cands: list[tuple], dist: int,
                       min_support: int = 1) -> list[ClusteredSV]:
    """Two-level (start, then end) clustering (cluster_sig :484-510)."""
    if not cands:
        return []
    cands = sorted(cands, key=lambda x: x[0])
    groups: list[list[tuple]] = [[cands[0]]]
    for c in cands[1:]:
        if abs(groups[-1][-1][0] - c[0]) <= dist:
            groups[-1].append(c)
        else:
            groups.append([c])
    fine: list[list[tuple]] = []
    for g in groups:
        g = sorted(g, key=lambda x: x[1])
        sub = [[g[0]]]
        for c in g[1:]:
            if abs(sub[-1][-1][1] - c[1]) <= dist:
                sub[-1].append(c)
            else:
                sub.append([c])
        fine.extend(sub)
    out = []
    for g in fine:
        if len(g) < min_support:
            continue
        starts = np.array([c[0] for c in g], np.float64)
        ends = np.array([c[1] for c in g], np.float64)
        mq = np.mean([c[2] for c in g])
        out.append(ClusteredSV(
            start=int(starts.mean()), end=int(ends.mean()), support=len(g),
            mapq=round(float(mq), 1), std_left=round(float(starts.std()), 4),
            std_right=round(float(ends.std()), 4)))
    return out


@dataclass
class AutoComplexResult:
    invs: dict[str, list[ClusteredSV]] = field(default_factory=dict)
    dups: dict[str, list[ClusteredSV]] = field(default_factory=dict)
    tras: list[tuple] = field(default_factory=list)   # (chrom,pos,alt,sup,mapq)


def call_complex_auto(
    records_by_chrom: dict[str, list[bamio.BamRecord]],
    data_type: str = "HIFI",
) -> AutoComplexResult:
    """Classify split reads and call INV/DUP/TRA candidates genome-wide."""
    # group every read's segments across chromosomes
    segs_by_read: dict[str, list[Segment]] = {}
    for chrom, records in records_by_chrom.items():
        for rec in records:
            if rec.is_unmapped or rec.is_secondary or rec.mapq < MIN_MAPQ:
                continue
            seg = segment_from_record(rec, chrom)
            if seg is not None:
                segs_by_read.setdefault(rec.name, []).append(seg)
    return call_complex_from_segments(segs_by_read, data_type)


def stream_segments_and_spans(
    bam: bamio.BamReader, chroms: list[str] | None = None,
) -> tuple[dict[str, list[Segment]], dict]:
    """One streaming pass over the BAM: split-read segments (tiny tuples,
    kept genome-wide for cross-chromosome TRA joins) plus per-chromosome
    primary-read span arrays for coverage features.  Never holds a
    chromosome's records in memory (WGS discipline: a 30x BAM's reads do
    not fit; its segments and spans do)."""
    import numpy as np
    segs_by_read: dict[str, list[Segment]] = {}
    spans_by_chrom: dict = {}
    for chrom in chroms or bam.ref_names:
        ss: list[tuple[int, int]] = []
        for rec in bam.fetch(chrom):
            if (not rec.is_unmapped and not rec.is_secondary
                    and not rec.is_supplementary):
                ss.append((rec.pos, rec.reference_end))
            if rec.is_unmapped or rec.is_secondary or rec.mapq < MIN_MAPQ:
                continue
            seg = segment_from_record(rec, chrom)
            if seg is not None:
                segs_by_read.setdefault(rec.name, []).append(seg)
        spans_by_chrom[chrom] = np.array(ss, np.int64).reshape(-1, 2)
    return segs_by_read, spans_by_chrom


def call_complex_from_segments(
    segs_by_read: dict[str, list[Segment]],
    data_type: str = "HIFI",
) -> AutoComplexResult:
    """INV/DUP/TRA candidate calling from pre-collected read segments."""
    params = AUTO_PARAMS[data_type]
    res = AutoComplexResult()
    inv_cands: dict[str, list[tuple]] = {}
    dup_cands: dict[str, list[tuple]] = {}
    tra_cands: list[tuple] = []
    for qname, segs in segs_by_read.items():
        if len(segs) < 2:
            continue
        by_chrom: dict[str, list[Segment]] = {}
        for s in segs:
            by_chrom.setdefault(s.chrom, []).append(s)
        for chrom, ss in by_chrom.items():
            fwd = [s for s in ss if s.strand == 0]
            rev = [s for s in ss if s.strand == 1]
            # INV: strand-flip pairs
            for f in fwd:
                for r in rev:
                    got = pair_inv(f, r, DIST_THRESH_READ,
                                   params["min_read_cov_inv"])
                    if got:
                        inv_cands.setdefault(chrom, []).append(got)
            # DUP: same-strand pairs
            for group in (fwd, rev):
                for i in range(len(group)):
                    for j in range(i + 1, len(group)):
                        got = pair_dup(group[i], group[j], DIST_THRESH_READ,
                                       MIN_READ_COV_DUP)
                        if got:
                            dup_cands.setdefault(chrom, []).append(got)
        # TRA: cross-chrom pairs
        if len(by_chrom) > 1:
            for i in range(len(segs)):
                for j in range(i + 1, len(segs)):
                    if segs[i].chrom == segs[j].chrom:
                        continue
                    got = pair_tra(segs[i], segs[j], DIST_THRESH_READ,
                                   MIN_READ_COV_BND)
                    if got:
                        tra_cands.append(got)
    for chrom, cands in inv_cands.items():
        res.invs[chrom] = cluster_candidates(cands, INV_CLUSTER_DIST, 1)
    for chrom, cands in dup_cands.items():
        res.dups[chrom] = cluster_candidates(cands, params["cluster_dist"], 1)
    # TRA clustering: chain-link by position per chromosome (dist 100, like
    # the reference's cluster over breakpoints)
    tra_cands.sort(key=lambda x: (x[0], x[1]))
    groups: list[list[tuple]] = []
    for c in tra_cands:
        if groups and groups[-1][-1][0] == c[0] \
                and abs(c[1] - groups[-1][-1][1]) <= 100:
            groups[-1].append(c)
        else:
            groups.append([c])
    for group in groups:
        poss = [g[1] for g in group]
        mqs = [g[3] for g in group]
        res.tras.append((group[0][0], int(np.mean(poss)), group[0][2],
                         len(group), round(float(np.mean(mqs)), 1)))
    return res


def filter_dups(
    dups: list[ClusteredSV], mean_cov: float, data_type: str,
) -> list[ClusteredSV]:
    """Round-1 DUP filter (process_dup.py first_round_filter :45-66)."""
    p = AUTO_PARAMS[data_type]
    min_sup = mean_cov * p["dup_min_sup_cov"]
    out = []
    for d in dups:
        if (d.support >= min_sup and d.mapq >= p["dup_min_mapq"]
                and (d.end - d.start) >= p["dup_min_size"]):
            out.append(d)
    return out


def filter_tra_inv(
    svs: list[ClusteredSV], min_sup: int = 2, min_mapq: float = 20,
    min_size: int = 30, max_size: int = 160_000_000,
) -> list[ClusteredSV]:
    """process_tra_inv.py load_bed :47-67."""
    return [s for s in svs
            if s.support >= min_sup and s.mapq >= min_mapq
            and min_size <= (s.end - s.start) <= max_size]


def complex_result_to_vcf(res: AutoComplexResult) -> list[VcfRecord]:
    out: list[VcfRecord] = []
    n = {"INV": 0, "DUP": 0, "BND": 0}
    for chrom, svs in sorted(res.invs.items()):
        for s in svs:
            n["INV"] += 1
            out.append(VcfRecord(
                chrom=chrom, pos=s.start + 1, id=f"focalsv.INV.{n['INV']}",
                ref="N", alt="<INV>", qual=".", filter="PASS",
                info=dict(SVTYPE="INV", SVLEN=s.end - s.start,
                          END=s.end + 1, SUPPORT=s.support), gt="./."))
    for chrom, svs in sorted(res.dups.items()):
        for s in svs:
            n["DUP"] += 1
            out.append(VcfRecord(
                chrom=chrom, pos=s.start + 1, id=f"focalsv.DUP.{n['DUP']}",
                ref="N", alt="<DUP>", qual=".", filter="PASS",
                info=dict(SVTYPE="DUP", SVLEN=s.end - s.start,
                          END=s.end + 1, SUPPORT=s.support), gt="./."))
    for chrom, pos, alt, sup, mq in res.tras:
        n["BND"] += 1
        out.append(VcfRecord(
            chrom=chrom, pos=pos + 1, id=f"focalsv.BND.{n['BND']}",
            ref="N", alt=alt, qual=".", filter="PASS",
            info=dict(SVTYPE="TRA", SUPPORT=sup), gt="./."))
    return out
