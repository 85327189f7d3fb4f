"""Read-based SV scanning: per-read signature collection + allele clustering.

Port of the vendored cuteSV 1.0.11 (Reads_Based_Scan/Reads_Based_Scan.py +
resolveINDEL.py) used by the reference for (a) auto-mode region signatures,
(b) step-5 support/GT evidence and (c) the read-based draft VCF:

- parse_read (:458-531): CIGAR walk with cuteSV's exact offset conventions
  (INS breakpoint at pos_start + consumed M/D/=/X *plus one*, :497-503) and
  intra-read combining with merge_dis (generate_combine_sigs :395-456;
  defaults merge_del 0 / merge_ins 100).
- resolution_DEL/INS (resolveINDEL :18-99, :204-278): position sweep with
  max_cluster_bias, per-read longest dedup, length-sorted allele splitting at
  gaps > diff_ratio * mean_len, support filter, mean breakpoint/length, INS
  representative sequence = first seq >= mean length truncated to it.
- genotyping: local spanning-read counting (genotype.count_coverage :64-85)
  + binomial GL (scan/genotype.py).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu.config import ReadScanConfig
from focalsv_tpu.io import bam as bamio
from focalsv_tpu.io.vcf import VcfRecord
from focalsv_tpu.ops import encode as enc
from focalsv_tpu.scan.genotype import (
    GENOTYPES, cal_cipos, cal_gl, threshold_ref_count,
)


@dataclass
class RawSig:
    pos: int
    length: int
    read: str
    seq: np.ndarray | None = None      # INS sequence


def collect_read_signatures(
    rec: bamio.BamRecord, cfg: ReadScanConfig,
) -> tuple[list[RawSig], list[RawSig]]:
    """(del_sigs, ins_sigs) from one primary alignment, intra-read merged."""
    if rec.query_length < cfg.min_read_len or rec.mapq < cfg.min_mapq:
        return [], []
    cig = rec.cigar
    if cig.shape[0] == 0:
        return [], []
    dels: list[RawSig] = []
    inss: list[RawSig] = []
    pos_start = rec.pos
    shift_del = 0
    shift_ins = 0
    shift_ins_read = 0
    hardclip_left = int(cig[0][1]) if cig[0][0] == bamio.CHARD_CLIP else 0
    for op, ln in cig:
        op, ln = int(op), int(ln)
        if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
            shift_del += ln
        if op == bamio.CDEL:
            if ln < cfg.min_sv_size:
                shift_del += ln
            else:
                dels.append(RawSig(pos_start + shift_del, ln, rec.name))
                shift_del += ln
        # NOTE: cuteSV counts every non-D op here (parse_read :497), which
        # miscounts query offsets for N/P ops; those consume no query bases
        if op not in (bamio.CDEL, bamio.CREF_SKIP, bamio.CPAD):
            shift_ins_read += ln
        if op in (bamio.CMATCH, bamio.CDEL, bamio.CEQUAL, bamio.CDIFF):
            shift_ins += ln
        if op == bamio.CINS and ln >= cfg.min_sv_size:
            shift_ins += 1
            seq = rec.seq[shift_ins_read - ln - hardclip_left
                          : shift_ins_read - hardclip_left]
            inss.append(RawSig(pos_start + shift_ins, ln, rec.name,
                               seq.copy()))
    return (_combine(dels, merge_dis=0, is_ins=False),
            _combine(inss, merge_dis=100, is_ins=True))


def _combine(sigs: list[RawSig], merge_dis: int, is_ins: bool) -> list[RawSig]:
    """generate_combine_sigs: merge same-read signals closer than merge_dis."""
    if len(sigs) <= 1:
        return sigs
    out: list[RawSig] = []
    cur = sigs[0]
    cur_tail = cur.pos if is_ins else cur.pos + cur.length
    for s in sigs[1:]:
        if s.pos - cur_tail <= merge_dis:
            if is_ins:
                cur = RawSig(cur.pos, cur.length + s.length, cur.read,
                             np.concatenate([cur.seq, s.seq])
                             if cur.seq is not None and s.seq is not None else None)
                cur_tail = s.pos
            else:
                cur = RawSig(cur.pos, cur.length + s.length, cur.read)
                cur_tail = s.pos + s.length
        else:
            out.append(cur)
            cur = s
            cur_tail = s.pos if is_ins else s.pos + s.length
    out.append(cur)
    return out


def split_read_signatures(
    geoms: list[dict], cfg: ReadScanConfig, read_name: str,
    fwd_seq: np.ndarray | None = None,
) -> tuple[list[RawSig], list[RawSig]]:
    """DEL/INS from adjacent same-strand split segments.

    Port of cuteSV's analysis_split_read same-chrom same-strand branch
    (Reads_Based_Scan.py:183-218): coordinates are flipped to forward-read
    space, segments sorted by read start, and for each adjacent pair with
    dis_ref = ref gap, dis_read = read gap:

    - INS: dis_ref < SV_size, dis_read - dis_ref >= SV_size, dis_ref <= 100,
      len <= MaxSize; pos = midpoint of the ref gap; the inserted sequence is
      the forward-read slice between the segments (:203-210).
    - DEL: dis_ref - dis_read >= SV_size, dis_read <= 100, len <= MaxSize;
      pos = left segment's ref end (:212-218).
    """
    dels: list[RawSig] = []
    inss: list[RawSig] = []
    if len(geoms) < 2 or len(geoms) > cfg.max_split_parts:
        return dels, inss
    fwd = []
    for g in geoms:
        if g["strand"]:
            fs = g["read_len"] - g["read_end"]
            fe = g["read_len"] - g["read_start"]
        else:
            fs, fe = g["read_start"], g["read_end"]
        fwd.append(dict(g, fs=fs, fe=fe))
    fwd.sort(key=lambda g: g["fs"])
    for a, b in zip(fwd[:-1], fwd[1:]):
        if a["strand"] != b["strand"]:
            continue
        dis_ref = b["ref_start"] - a["ref_end"]
        dis_read = b["fs"] - a["fe"]
        ins_len = dis_read - dis_ref
        del_len = dis_ref - dis_read
        if (dis_ref < cfg.min_sv_size and ins_len >= cfg.min_sv_size
                and dis_ref <= 100 and ins_len <= cfg.max_sv_size):
            pos = (b["ref_start"] + a["ref_end"]) // 2
            seq = None
            if fwd_seq is not None:
                lo = a["fe"] + max(dis_ref, 0) // 2
                seq = fwd_seq[lo : lo + ins_len].copy()
                if len(seq) < ins_len:
                    seq = None
            inss.append(RawSig(int(pos), int(ins_len), read_name, seq))
        if (del_len >= cfg.min_sv_size and dis_read <= 100
                and del_len <= cfg.max_sv_size):
            dels.append(RawSig(int(a["ref_end"]), int(del_len), read_name))
    return dels, inss


@dataclass
class ScanResult:
    del_sigs: list[RawSig] = field(default_factory=list)
    ins_sigs: list[RawSig] = field(default_factory=list)
    # spanning intervals of primary reads, for local-coverage genotyping
    read_spans: list[tuple[str, int, int]] = field(default_factory=list)


def scan_records(records, cfg: ReadScanConfig) -> ScanResult:
    """Collect all signatures from an iterable of BamRecords (one chrom).

    Gating mirrors cuteSV parse_read: every record (primary AND supplementary)
    with mapq >= min_mapq and query_length >= min_read_len contributes CIGAR
    signatures; spanning intervals for genotyping come from primaries only
    (count_coverage fetches flags 0/16 with no length filter)."""
    out = ScanResult()
    from focalsv_tpu.signatures.contig import _aln_geometry
    from focalsv_tpu.ops import encode as enc
    geoms: dict[str, list[dict]] = {}
    fwd_seqs: dict[str, np.ndarray] = {}
    for rec in records:
        if rec.is_unmapped or rec.is_secondary:
            continue
        if not rec.is_supplementary:
            out.read_spans.append((rec.name, rec.pos, rec.reference_end))
        d, i = collect_read_signatures(rec, cfg)
        out.del_sigs.extend(d)
        out.ins_sigs.extend(i)
        if rec.mapq >= cfg.min_mapq and rec.cigar.shape[0] \
                and rec.query_length >= cfg.min_read_len:
            g = _aln_geometry(rec.cigar.astype(np.int64), rec.pos, rec.mapq,
                              int(rec.is_reverse), 0)
            geoms.setdefault(rec.name, []).append(g)
            # keep one full-length forward-strand sequence per read for
            # split-INS sequence attachment (soft-clipped primaries carry it)
            if rec.name not in fwd_seqs and rec.seq.shape[0] == g["read_len"]:
                fwd_seqs[rec.name] = (enc.revcomp(rec.seq) if rec.is_reverse
                                      else rec.seq)
    for name, gs in geoms.items():
        d, i = split_read_signatures(gs, cfg, name, fwd_seqs.get(name))
        out.del_sigs.extend(d)
        out.ins_sigs.extend(i)
    out.del_sigs.sort(key=lambda s: s.pos)
    out.ins_sigs.sort(key=lambda s: s.pos)
    return out


def normalize_scan_result(scan: "ScanResult", ref_codes: np.ndarray,
                          offset: int = 0) -> None:
    """Left-align signature positions in place (ops/normalize.py): DELs via
    the reference, INS via their carried sequence -- so shift-bounded
    matching (FP filter, GT correction, draft-call comparison) sees the
    same canonical coordinates as the normalized calls."""
    from focalsv_tpu_torch.ops.normalize import (left_align_del,
                                           left_align_ins_approx)
    L = len(ref_codes)
    for s in scan.del_sigs:
        p = s.pos - offset
        if 1 <= p and p + s.length <= L:
            s.pos = left_align_del(ref_codes, p, s.length) + offset
    for s in scan.ins_sigs:
        p = s.pos - offset
        if s.seq is not None and len(s.seq) == s.length and 1 <= p <= L:
            new_p, new_seq = left_align_ins_approx(ref_codes, p, s.seq)
            s.pos = new_p + offset
            s.seq = new_seq
    scan.del_sigs.sort(key=lambda s: s.pos)
    scan.ins_sigs.sort(key=lambda s: s.pos)


@dataclass
class ScanCall:
    chrom: str
    svtype: str
    pos: int
    svlen: int
    support: int
    reads: list[str]
    cipos: str = "-0,0"
    cilen: str = "-0,0"
    gt: str = "./."
    gl: str = ".,.,."
    gq: str = "."
    qual: str = "."
    dr: int | str = "."
    seq: np.ndarray | None = None


def _genotype_call(pos: int, support_reads: list[str],
                   spans: np.ndarray, span_names: list[str],
                   bias: int, err: float, prior: float):
    """Local spanning-read genotyping (count_coverage + cal_GL semantics)."""
    s, e = pos - bias, pos + bias
    up_bound = threshold_ref_count(len(support_reads))
    covering = np.nonzero((spans[:, 0] < s) & (spans[:, 1] > e))[0]
    names = {span_names[i] for i in covering[:up_bound]}
    dr = len(names - set(support_reads))
    gt, gl, gq, qual = cal_gl(dr, len(support_reads), err, prior)
    return dr, gt, gl, gq, qual


def cluster_signatures(
    sigs: list[RawSig], chrom: str, svtype: str, cfg: ReadScanConfig,
    scan: ScanResult | None = None, genotype: bool = True,
) -> list[ScanCall]:
    """resolution_DEL/resolution_INS sweep + allele split + genotyping."""
    is_ins = svtype == "INS"
    bias = cfg.max_cluster_bias_ins if is_ins else cfg.max_cluster_bias_del
    ratio = cfg.diff_ratio_merging_ins if is_ins else cfg.diff_ratio_merging_del
    read_count = cfg.min_support
    calls: list[ScanCall] = []
    spans = None
    span_names: list[str] = []
    if genotype and scan is not None and scan.read_spans:
        span_names = [x[0] for x in scan.read_spans]
        spans = np.array([[x[1], x[2]] for x in scan.read_spans], np.int64)
    else:
        genotype = False

    def flush(cluster: list[RawSig]):
        if len(cluster) < read_count:
            return
        # per-read keep-longest dedup
        best: dict[str, RawSig] = {}
        for s in cluster:
            if s.read not in best or s.length > best[s.read].length:
                best[s.read] = s
        if len(best) < read_count:
            return
        items = sorted(best.values(), key=lambda s: s.length)
        lens = np.array([s.length for s in items], np.float64)
        gap_thresh = ratio * lens.mean()
        alleles: list[list[RawSig]] = [[items[0]]]
        for prev, cur in zip(items[:-1], items[1:]):
            if cur.length - prev.length > gap_thresh:
                alleles.append([])
            alleles[-1].append(cur)
        alleles.sort(key=lambda a: len(a))
        for allele in alleles:
            if len(allele) < cfg.min_support:
                continue
            poss = np.array([s.pos for s in allele], np.float64)
            ls = np.array([s.length for s in allele], np.float64)
            bp = int(poss.mean())
            svlen = int(ls.mean())
            seq = None
            if is_ins:
                for s in allele:
                    if s.seq is not None and len(s.seq) >= svlen:
                        seq = s.seq[:svlen]
                        break
                if seq is None:
                    continue
            reads = [s.read for s in allele]
            call = ScanCall(
                chrom=chrom, svtype=svtype, pos=bp,
                svlen=-svlen if svtype == "DEL" else svlen,
                support=len(allele), reads=reads,
                cipos=cal_cipos(float(poss.std()), len(allele)),
                cilen=cal_cipos(float(ls.std()), len(allele)), seq=seq)
            if genotype:
                # DEL searches around min(pos) with max_cluster_bias; INS
                # around the mean breakpoint with a fixed 1000 bp window
                search = bp if is_ins else int(np.min(poss))
                dr, gt, gl, gq, qual = _genotype_call(
                    search, reads, spans, span_names,
                    1000 if is_ins else bias, cfg.gl_error, cfg.gl_prior)
                call.dr, call.gt, call.gl, call.gq, call.qual = \
                    dr, gt, gl, str(gq), str(qual)
            calls.append(call)

    cluster: list[RawSig] = []
    last_pos = -10 ** 12
    for s in sigs:
        if s.pos - last_pos > bias and cluster:
            flush(cluster)
            cluster = []
        cluster.append(s)
        last_pos = s.pos
    if cluster:
        flush(cluster)
    calls.sort(key=lambda c: c.pos)
    return calls


def scan_chromosome(
    records, chrom: str, cfg: ReadScanConfig, genotype: bool = True,
) -> tuple[list[ScanCall], ScanResult]:
    """Full per-chromosome read-based scan -> draft calls + raw signatures."""
    scan = scan_records(records, cfg)
    calls = cluster_signatures(scan.del_sigs, chrom, "DEL", cfg, scan, genotype)
    calls += cluster_signatures(scan.ins_sigs, chrom, "INS", cfg, scan, genotype)
    calls.sort(key=lambda c: c.pos)
    return calls, scan


def calls_to_vcf(calls: list[ScanCall], ref: np.ndarray, ref_offset: int,
                 id_prefix: str = "readscan") -> list[VcfRecord]:
    out = []
    counters = {"DEL": 0, "INS": 0}
    for c in calls:
        p0 = c.pos - ref_offset
        if p0 < 1 or p0 >= len(ref):
            continue
        anchor = enc.decode(ref[p0 - 1 : p0])
        if c.svtype == "DEL":
            dseq = enc.decode(ref[p0 : p0 + abs(c.svlen)])
            ref_a, alt_a = anchor + dseq, anchor
        else:
            ref_a, alt_a = anchor, anchor + enc.decode(c.seq)
        counters[c.svtype] += 1
        out.append(VcfRecord(
            chrom=c.chrom, pos=c.pos, id=f"{id_prefix}.{c.svtype}.{counters[c.svtype]}",
            ref=ref_a, alt=alt_a, qual=str(c.qual), filter="PASS",
            info=dict(SVTYPE=c.svtype, SVLEN=c.svlen, SUPPORT=c.support,
                      CIPOS=c.cipos, CILEN=c.cilen),
            gt=c.gt))
    return out
