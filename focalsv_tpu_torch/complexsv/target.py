"""Target-mode TRA/INV/DUP calling over typed BED windows.

Port of `TRA_INV_DUP_call/Target/` on framework machinery:

- INV / TRA / split-read DUP: the same split-segment geometry as auto mode
  (complexsv/auto.py) restricted to the typed windows
  (Reads_Based_INV_Call.py:34-213, Reads_Based_TRA_Call.py:160-354,
  call_DUP.py alignment route :98-140).
- DUP recovered from INS: each INS call's ALT sequence is re-aligned to the
  reference near the call; an INS whose sequence maps adjacent to itself is a
  tandem duplication (align_ins2ref.py:82-131; defaults mapq>=0,
  size-sim>=0.7, shift<=300, shift-ratio<=0.3; multi-hit ties broken by
  z-scored (size_sim, -shift, -shift_ratio) sum).

NOTE vs reference: the driver bug where `--bed_file` is read as
`args.target_bed` (FocalSV-target_TRA_INV_DUP_call.py:13 vs :27) is NOT
replicated (SURVEY.md 'known quirks').
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu_torch.align_engine import Aligner
from focalsv_tpu_torch.complexsv import auto as cauto
from focalsv_tpu_torch.config import PipelineConfig
from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.io.bed import Region
from focalsv_tpu_torch.io.vcf import VcfRecord, sort_records
from focalsv_tpu_torch.ops import encode as enc


def recover_dup_from_ins(
    ins_records: list[VcfRecord],
    ref_by_chrom,                       # chrom -> uint8 codes (FastaFile ok)
    min_mapq: int = 0,
    min_size_sim: float = 0.7,
    max_shift: int = 300,
    max_shift_ratio: float = 0.3,
    search_flank_factor: int = 4,
) -> list[VcfRecord]:
    """INS whose ALT sequence re-aligns adjacent to its own breakpoint = DUP."""
    out: list[VcfRecord] = []
    n = 0
    for rec in ins_records:
        if rec.svtype != "INS" or len(rec.alt) <= 1:
            continue
        ins_seq = enc.encode(rec.alt[1:])
        svlen = len(ins_seq)
        try:
            chrom_seq = ref_by_chrom[rec.chrom] if not hasattr(ref_by_chrom, "fetch") \
                else ref_by_chrom.fetch(rec.chrom)
        except KeyError:
            continue
        w = svlen * search_flank_factor + 1000
        ws = max(0, rec.pos - w)
        we = min(len(chrom_seq), rec.pos + w)
        window = np.asarray(chrom_seq[ws:we], np.uint8)
        if len(window) < 100:
            continue
        aligner = Aligner(window, t_name=rec.chrom)
        alns = aligner.align(ins_seq, rec.id, min_chain_score=20)
        cands = []
        pos0 = rec.pos - 1               # VCF POS is 1-based
        for a in alns:
            start_aln = ws + a.t_start
            end_aln = ws + a.t_end
            svlen_aln = end_aln - start_aln
            size_sim = min(svlen_aln, svlen) / max(svlen_aln, svlen, 1)
            shift = min(abs(start_aln - pos0), abs(end_aln - pos0))
            shift_ratio = shift / max(svlen, 1)
            if (a.mapq >= min_mapq and size_sim >= min_size_sim
                    and shift <= max_shift and shift_ratio <= max_shift_ratio):
                cands.append((size_sim, -shift, -shift_ratio,
                              start_aln, end_aln))
        if not cands:
            continue
        if len(cands) > 1:
            arr = np.array([c[:3] for c in cands], np.float64)
            norm = (arr - arr.mean(0)) / (arr.std(0) + 1e-4)
            best = cands[int(np.argmax(norm.sum(1)))]
        else:
            best = cands[0]
        n += 1
        out.append(VcfRecord(
            chrom=rec.chrom, pos=best[3] + 1, id=f"focalsv.DUP.recover.{n}",
            ref=".", alt="<DUP>", qual="20", filter="PASS",
            info=dict(SVTYPE="DUP", END=best[4] + 1, SVLEN=best[4] - best[3],
                      READS=rec.info.get("TIG_REGION", ".")),
            gt=rec.gt))
    return out


def call_dup_from_contigs(
    out_dir: str,
    ref_by_chrom,                     # FastaFile or chrom->codes mapping
    data_type: str = "HIFI",
    min_support: int = 1,
    min_sv_size: int = 30,
) -> list[VcfRecord]:
    """Contig-route DUP calling: align the indel pipeline's per-region
    haplotype contigs (out_dir/chr*/regions/*/HP{1,2}.fa) back to the
    reference and run the split-segment DUP geometry on them -- the
    framework's replacement for the reference's minimap2-asm10 + vendored
    svim-asm diploid route (call_DUP_from_contigs.py:57-130)."""
    import glob
    import os

    from focalsv_tpu_torch.io.fasta import FastaFile

    records_by_chrom: dict[str, list[bamio.BamRecord]] = {}
    for fa_path in sorted(glob.glob(
            os.path.join(out_dir, "chr*", "regions", "Region_*", "HP*.fa"))):
        region_name = os.path.basename(os.path.dirname(fa_path))
        # Region_chr21_S12345_E67890
        parts = region_name.split("_")
        chrom = parts[1]
        start = int(parts[2][1:])
        end = int(parts[3][1:])
        try:
            chrom_seq = ref_by_chrom.fetch(chrom) if hasattr(ref_by_chrom, "fetch") \
                else ref_by_chrom[chrom]
        except KeyError:
            continue
        pad = max(end - start, 50_000)
        ws = max(0, start - pad)
        we = min(len(chrom_seq), end + pad)
        window = np.asarray(chrom_seq[ws:we], np.uint8)
        fa = FastaFile.load(fa_path)
        aligner = Aligner(window, t_name=chrom)
        for name in fa.names:
            seq = fa.fetch(name)
            alns = aligner.align(np.asarray(seq, np.uint8),
                                 f"{region_name}_{name}")
            for a in alns:
                rec = aligner.to_bam_record(a, np.asarray(seq, np.uint8), alns)
                rec.pos += ws
                records_by_chrom.setdefault(chrom, []).append(rec)
    res = cauto.call_complex_auto(records_by_chrom, data_type)
    out: list[VcfRecord] = []
    n = 0
    for chrom, svs in sorted(res.dups.items()):
        for s in svs:
            if s.support < min_support or s.end - s.start < min_sv_size:
                continue
            n += 1
            out.append(VcfRecord(
                chrom=chrom, pos=s.start + 1, id=f"focalsv.DUP.contig.{n}",
                ref="N", alt="<DUP>", qual=".", filter="PASS",
                info=dict(SVTYPE="DUP", END=s.end + 1,
                          SVLEN=s.end - s.start, SUPPORT=s.support,
                          SIG_SOURCE="contig"), gt="./."))
    return out


@dataclass
class TargetComplexResult:
    invs: list[VcfRecord] = field(default_factory=list)
    dups: list[VcfRecord] = field(default_factory=list)
    tras: list[VcfRecord] = field(default_factory=list)

    def all_records(self) -> list[VcfRecord]:
        return sort_records(self.invs + self.dups + self.tras)


def _merge_intervals(ivs: list[tuple[int, int]]) -> list[tuple[int, int]]:
    """Union of possibly-overlapping [lo, hi) intervals."""
    out: list[tuple[int, int]] = []
    for lo, hi in sorted(ivs):
        if out and lo <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], hi))
        else:
            out.append((lo, hi))
    return out


def split_typed_bed(rows: list[tuple[Region, str]]):
    """Typed BED rows (region, svtype) -> per-type region lists
    (driver :35-47 split of the 4-column BED)."""
    by_type: dict[str, list[Region]] = {"DUP": [], "INV": [], "TRA": []}
    for region, svtype in rows:
        key = svtype.upper()
        if key in by_type:
            by_type[key].append(region)
    return by_type


def call_complex_target(
    bam: bamio.BamReader,
    regions_by_type: dict[str, list[Region]],
    data_type: str,
    ins_records: list[VcfRecord] | None = None,
    ref_by_chrom=None,
    min_sv_size: int = 30,
    min_support: int = 1,
) -> TargetComplexResult:
    """Call complex SVs inside the typed target windows."""
    res = TargetComplexResult()

    def fetch_window_records(region: Region, pad: int = 2000):
        return list(bam.fetch(region.chrom, max(0, region.start - pad),
                              region.end + pad))

    # INV windows: strand-flip geometry, in-window filter
    for region in regions_by_type.get("INV", []):
        records = fetch_window_records(region)
        out = cauto.call_complex_auto({region.chrom: records}, data_type)
        for chrom, svs in out.invs.items():
            for s in svs:
                if s.support < min_support:
                    continue
                if s.end - s.start < min_sv_size:
                    continue
                if not (region.start - 2000 <= s.start <= region.end + 2000):
                    continue
                res.invs.append(VcfRecord(
                    chrom=chrom, pos=s.start + 1,
                    id=f"focalsv.INV.{len(res.invs)+1}", ref="N", alt="<INV>",
                    qual=".", filter="PASS",
                    info=dict(SVTYPE="INV", END=s.end + 1,
                              SVLEN=s.end - s.start, SUPPORT=s.support),
                    gt="./."))
    # DUP windows: split-read route + INS recovery route
    for region in regions_by_type.get("DUP", []):
        records = fetch_window_records(region, pad=5000)
        out = cauto.call_complex_auto({region.chrom: records}, data_type)
        for chrom, svs in out.dups.items():
            for s in svs:
                if s.support < min_support or s.end - s.start < min_sv_size:
                    continue
                res.dups.append(VcfRecord(
                    chrom=chrom, pos=s.start + 1,
                    id=f"focalsv.DUP.{len(res.dups)+1}", ref="N", alt="<DUP>",
                    qual=".", filter="PASS",
                    info=dict(SVTYPE="DUP", END=s.end + 1,
                              SVLEN=s.end - s.start, SUPPORT=s.support),
                    gt="./."))
    if ins_records and ref_by_chrom is not None:
        dup_regions = regions_by_type.get("DUP", [])
        cands = [r for r in ins_records
                 if any(d.chrom == r.chrom and d.start - 5000 <= r.pos <= d.end + 5000
                        for d in dup_regions)] if dup_regions else list(ins_records)
        res.dups.extend(recover_dup_from_ins(cands, ref_by_chrom))
    # TRA windows: cross-chromosome split pairs; the mate chromosome's
    # supplementary records come from SA-tag mate coordinates with a bounded
    # BAI fetch per mate window -- NOT a whole-BAM scan (reference locates
    # mates from SA tags the same way, Reads_Based_TRA_Call.py:180; a
    # genome-wide qname scan would be O(whole BAM) per target call)
    tra_regions = regions_by_type.get("TRA", [])
    if tra_regions:
        by_chrom: dict[str, list] = {}
        for region in tra_regions:
            by_chrom.setdefault(region.chrom, []).extend(
                fetch_window_records(region))
        qnames = {r.name for recs in by_chrom.values() for r in recs}
        # mate windows from SA tags: (chrom, pos) of every supplementary
        # segment of a window read
        mate_ivs: dict[str, list[tuple[int, int]]] = {}
        for recs in list(by_chrom.values()):
            for r in recs:
                sa = r.tags.get("SA")
                if not sa:
                    continue
                for entry in str(sa).split(";"):
                    if not entry:
                        continue
                    parts = entry.split(",")
                    if len(parts) < 4:
                        continue
                    mchrom, mpos = parts[0], int(parts[1]) - 1
                    cig = bamio.parse_cigar_string(parts[3])
                    span = int(
                        cig[bamio.CONSUMES_REF[cig[:, 0]], 1].sum()) or 1
                    mate_ivs.setdefault(mchrom, []).append(
                        (max(0, mpos - 2000), mpos + span + 2000))
        have = {(r.name, r.flag, r.pos)
                for recs in by_chrom.values() for r in recs}
        for mchrom, ivs in mate_ivs.items():
            recs = by_chrom.setdefault(mchrom, [])
            for lo, hi in _merge_intervals(ivs):
                for rec in bam.fetch(mchrom, lo, hi):
                    key = (rec.name, rec.flag, rec.pos)
                    if rec.name in qnames and key not in have:
                        have.add(key)
                        recs.append(rec)
        out = cauto.call_complex_auto(by_chrom, data_type)
        for chrom, pos, alt, sup, mq in out.tras:
            if sup < min_support:
                continue
            if not any(r.chrom == chrom and r.start - 2000 <= pos <= r.end + 2000
                       for r in tra_regions):
                continue
            res.tras.append(VcfRecord(
                chrom=chrom, pos=pos + 1, id=f"focalsv.BND.{len(res.tras)+1}",
                ref="N", alt=alt, qual=".", filter="PASS",
                info=dict(SVTYPE="TRA", SUPPORT=sup), gt="./."))
    return res
