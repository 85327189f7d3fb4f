"""Per-region SV calling: phase -> assemble -> align -> extract -> refine.

One region's pass through the stack (the per-region equivalent of reference
steps 2-5, main.py:104-155): read phasing (phasing/phase.py), per-haplotype
consensus (assembly/consensus.py), contig alignment + diploid signature
calling (calling/dippav.py), read-signature FP filtering and dedup.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu_torch.assembly.consensus import assemble_haplotypes
from focalsv_tpu_torch.calling.dedup import dedup_records
from focalsv_tpu_torch.calling.dippav import call_region_variants
from focalsv_tpu.calling.fp_filter import fp_filter_records
from focalsv_tpu.config import PipelineConfig
from focalsv_tpu.io import bam as bamio
from focalsv_tpu.io.vcf import VcfRecord
from focalsv_tpu.phasing.phase import group_reads_by_block, phase_region
from focalsv_tpu_torch.ops.normalize import left_align_del
from focalsv_tpu.signatures.reads import extract_read_sigs


def _normalize_sigs(sigs, ref_codes, region_start, reads=None) -> None:
    """Left-align signature positions in place (repeat canonicalization).

    The contig caller left-aligns both DEL and INS calls
    (calling/dippav.py); read signatures must take the SAME canonical
    positions or the FP filter's 500 bp shift gate drops true calls inside
    tandem arrays (a whole-unit INS left-aligns to the array start, many
    units away from the raw CIGAR placement -- reference analog:
    both sides of FP_filter_v1.py see minimap2's left-aligning CIGARs).
    INS alignment needs the inserted sequence, sliced from the SOURCE
    record: for a split read the Sigs row does not say which alignment it
    came from, so the record is identified exactly -- the one whose CIGAR
    carries an INS op of this length at this full-read query offset
    (slicing the wrong record, with a different hard-clip offset or
    reverse-strand storage, would shift the signature to a wrong
    canonical position)."""
    from focalsv_tpu.signatures.sigs import DEL as _DEL, INS as _INS
    from focalsv_tpu.io.bam import CHARD_CLIP, CINS, CONSUMES_QUERY
    from focalsv_tpu_torch.ops.normalize import left_align_ins_approx

    def ins_source(recs, rs: int, ln: int):
        """The record whose CIGAR has an INS of length ln at full-read
        query offset rs (hard clips included), or None."""
        for r in recs:
            q = 0
            for op, olen in r.cigar:
                if op == CINS and q == rs and olen == ln:
                    return r
                if CONSUMES_QUERY[op] or op == CHARD_CLIP:
                    q += int(olen)
                if q > rs:
                    break
        return None

    by_name: dict[str, list] = {}
    if reads is not None:
        for r in reads:
            if not r.is_unmapped and not r.is_secondary:
                by_name.setdefault(r.name, []).append(r)
    L = len(ref_codes)
    for i in range(len(sigs)):
        p = int(sigs.pos[i]) - region_start
        ln = int(sigs.svlen[i])
        if sigs.svtype[i] == _DEL:
            # a DEL consumes [p, p+ln) of reference: both ends in range
            if 1 <= p and p + ln <= L:
                sigs.pos[i] = left_align_del(ref_codes, p, ln) + region_start
        elif sigs.svtype[i] == _INS and reads is not None and 1 <= p <= L:
            # an INS consumes no reference: only p must be in range
            name = sigs.names[int(sigs.contig[i])]
            rs, re_ = int(sigs.rstart[i]), int(sigs.rend[i])
            if re_ - rs != ln:
                continue              # not a CIGAR-INS-shaped signature
            r = ins_source(by_name.get(name, ()), rs, ln)
            if r is None:
                continue
            hc = int(r.cigar[0, 1]) if (r.cigar.shape[0]
                                        and r.cigar[0, 0] == CHARD_CLIP) \
                else 0
            a, b = rs - hc, re_ - hc
            if 0 <= a < b <= len(r.seq):
                new_p, _ = left_align_ins_approx(ref_codes, p, r.seq[a:b])
                sigs.pos[i] = new_p + region_start


@dataclass
class RegionResult:
    chrom: str
    start: int
    end: int
    records: list[VcfRecord] = field(default_factory=list)
    dropped: list[VcfRecord] = field(default_factory=list)
    n_reads: int = 0
    n_phased: int = 0
    n_blocks: int = 0
    n_contigs: int = 0
    # artifacts for reference-layout output (region_phased.bam + .vcf,
    # PS*_hp*.fa)
    usable_reads: list = field(default_factory=list)
    phase_hp: np.ndarray | None = None
    phase_ps: np.ndarray | None = None
    snv_records: list = field(default_factory=list)
    contigs_hp1: dict = field(default_factory=dict)
    contigs_hp2: dict = field(default_factory=dict)
    # contig name -> implied alignment segments (guided consensus only;
    # lets the variant caller skip contig->ref re-alignment)
    contig_alns: dict = field(default_factory=dict)


def process_region(
    reads: list[bamio.BamRecord],
    ref_codes: np.ndarray,          # region reference window (codes)
    region_start: int,              # genome coordinate of ref_codes[0]
    chrom: str,
    cfg: PipelineConfig,
    apply_fp_filter: bool = True,
) -> RegionResult:
    region_len = len(ref_codes)
    res = RegionResult(chrom=chrom, start=region_start,
                       end=region_start + region_len)
    usable = [r for r in reads
              if not r.is_unmapped and not r.is_secondary
              and not r.is_supplementary and r.mapq >= cfg.phasing.min_mapq]
    res.n_reads = len(usable)
    if not usable:
        return res
    # 1. phase
    pr = phase_region(usable, ref_codes, region_start, cfg.phasing)
    res.n_phased = int((pr.hp > 0).sum())
    res.n_blocks = pr.n_blocks
    groups = group_reads_by_block(usable, pr)
    # 2. assemble
    hp1, hp2 = assemble_haplotypes(usable, groups, region_start, region_len,
                                   cfg.assembly,
                                   name_prefix=f"{chrom}_S{region_start}",
                                   alns_out=res.contig_alns)
    res.n_contigs = len(hp1) + len(hp2)
    res.usable_reads = usable
    res.phase_hp, res.phase_ps = pr.hp, pr.ps
    from focalsv_tpu.phasing.phase import phased_snv_records
    res.snv_records = phased_snv_records(pr, ref_codes, region_start, chrom)
    res.contigs_hp1, res.contigs_hp2 = hp1, hp2
    finish_region_result(res, reads, ref_codes, region_start, chrom, cfg,
                         apply_fp_filter)
    return res


def finish_region_result(
    res: RegionResult,
    reads: list[bamio.BamRecord],
    ref_codes: np.ndarray,
    region_start: int,
    chrom: str,
    cfg: PipelineConfig,
    apply_fp_filter: bool = True,
) -> None:
    """Steps 3-4 for a region whose contigs are already on ``res``: align the
    contigs and call variants, then FP-filter/dedup.  Shared by the host
    per-region path above and the device-batched path
    (pipeline/device_exec.py), so the two execution modes cannot drift."""
    hp1, hp2 = res.contigs_hp1, res.contigs_hp2
    if not hp1 and not hp2:
        return
    # 3. align contigs + call variants (implied alignments skip the aligner)
    records = call_region_variants(hp1, hp2, ref_codes, region_start, chrom,
                                   cfg, implied_alns=res.contig_alns)
    # 4. refine: read-signature support filter + dedup
    if apply_fp_filter and records:
        read_sigs = extract_read_sigs(
            reads, min_cigar_mapq=cfg.read_scan.min_mapq,
            min_svlen=cfg.read_scan.min_sv_size)
        _normalize_sigs(read_sigs, ref_codes, region_start, reads=reads)
        records, dropped = fp_filter_records(records, read_sigs, cfg.fp_filter)
        res.dropped.extend(dropped)
        # tandem-array loci: spanning-read clusters arbitrate contig calls
        # (noisy de-novo consensus mis-counts units; reads are the
        # stronger witness exactly there — calling/array_arbitrate.py)
        from focalsv_tpu.calling.array_arbitrate import arbitrate_array_calls
        hp_by_name = {}
        if res.usable_reads is not None and res.phase_hp is not None:
            hp_by_name = {r.name: int(h) for r, h in
                          zip(res.usable_reads, res.phase_hp)}
        records, arb_dropped = arbitrate_array_calls(
            records, read_sigs, res.usable_reads or reads, hp_by_name,
            ref_codes, region_start, chrom, cfg.fp_filter,
            min_sv_size=cfg.read_scan.min_sv_size)
        res.dropped.extend(arb_dropped)
    if records:
        records, removed = dedup_records(records, cfg.dedup)
        res.dropped.extend(removed)
    res.records = records
