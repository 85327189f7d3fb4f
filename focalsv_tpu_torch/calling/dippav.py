"""DipPAV-equivalent variant caller: diploid contig alignments -> VCF records.

Mirrors `Dippav/DipPAV_variant_call.py:52-171`: align HP1/HP2 contigs to the
chromosome reference (here with the in-process seed-chain-extend engine
instead of `minimap2 -a -x asm5 --cs -r2k`), extract per-haplotype contig
signatures, pair across haplotypes into genotypes, attach REF/ALT sequences
and emit FocalSV-compatible VCF records (write_vcf :634-670 semantics:
POS is the 0-based event start written as the 1-based anchor column, REF/ALT
carry the anchor base + event sequence).
"""

from __future__ import annotations

import dataclasses

import numpy as np

from focalsv_tpu_torch.align_engine import Aligner
from focalsv_tpu.config import PipelineConfig
from focalsv_tpu.io.vcf import VcfRecord
from focalsv_tpu.ops import encode as enc
from focalsv_tpu.signatures.contig import extract_hap_sigs
from focalsv_tpu.signatures.sigs import DEL, INS, PairedSig, pair_haplotypes


def align_contigs(
    contigs: dict[str, np.ndarray],
    aligner: Aligner,
) -> list:
    """Align every contig; returns flat list of Alignment objects."""
    out = []
    for name, seq in contigs.items():
        out.extend(aligner.align(np.asarray(seq, np.uint8), q_name=name))
    return out


def _contig_alignments(
    contigs: dict[str, np.ndarray],
    implied: dict[str, list] | None,
    make_aligner,
    chrom: str,
) -> list:
    """Per contig: use the construction-implied alignment when present
    (guided consensus knows its own placement, stitch_contig_segments),
    otherwise fall back to the seed-chain-extend aligner (OLC/de-novo
    contigs, insertion-only contigs).  The aligner is built lazily -- the
    minimizer index over the region reference is pure overhead when every
    contig carries an implied alignment (the production guided path)."""
    from focalsv_tpu_torch.align_engine import implied_alignments
    out = []
    aligner = None
    for name, seq in contigs.items():
        segs = (implied or {}).get(name)
        if segs:
            out.extend(implied_alignments(name, len(seq), segs, t_name=chrom))
        else:
            if aligner is None:
                aligner = make_aligner()
            out.extend(aligner.align(np.asarray(seq, np.uint8), q_name=name))
    return out


def paired_sig_to_vcf(
    paired: list[PairedSig],
    chrom: str,
    ref: np.ndarray,                 # chromosome (or region) reference codes
    ref_offset: int,                 # genome coordinate of ref[0]
    contigs_hp1: dict[str, np.ndarray],
    contigs_hp2: dict[str, np.ndarray],
    id_prefix: str = "focalsv",
) -> list[VcfRecord]:
    """Attach sequences and build VCF records (add_seq_to_sig :598-631)."""
    contigs = dict(contigs_hp1)
    contigs.update(contigs_hp2)
    from focalsv_tpu_torch.ops.normalize import (left_align_del,
                                           left_align_ins_approx,
                                           snap_indel_to_unit)
    records: list[VcfRecord] = []
    counters = {DEL: 0, INS: 0}
    for sig in paired:
        pos0 = sig.pos - ref_offset          # 0-based index into ref
        if pos0 < 1 or pos0 >= len(ref):
            continue
        if sig.svtype == DEL and pos0 + sig.svlen <= len(ref):
            # unit-aware length canonicalization first (a noisy consensus
            # measures whole-unit array contractions a fraction of a unit
            # short, which strands the call mid-array: non-multiple
            # lengths are not rotation-invariant), then the leftmost
            # equivalent placement
            snapped = snap_indel_to_unit(ref, pos0, sig.svlen)
            if snapped != sig.svlen and pos0 + snapped <= len(ref):
                sig = dataclasses.replace(sig, svlen=snapped)
            pos0 = left_align_del(ref, pos0, sig.svlen)
        anchor = enc.decode(ref[pos0 - 1 : pos0])
        if sig.svtype == DEL:
            deleted = enc.decode(ref[pos0 : pos0 + sig.svlen])
            if len(deleted) < sig.svlen:
                continue
            ref_allele = anchor + deleted
            alt_allele = anchor
            svlen = -sig.svlen
            tname = "DEL"
        else:
            cseq = contigs.get(sig.contig_name)
            if cseq is None:
                continue
            cseq = np.asarray(cseq, np.uint8)
            if sig.hp_strand:
                # offsets are in stored (revcomp) strand space
                stored = enc.revcomp(cseq)
            else:
                stored = cseq
            ins_seq = stored[sig.rstart : sig.rend]
            if len(ins_seq) == 0:
                continue
            snapped = snap_indel_to_unit(ref, pos0, len(ins_seq))
            if snapped != len(ins_seq) and pos0 + snapped <= len(ref):
                # whole-unit array expansion measured a fraction of a
                # unit off: rebuild the insertion as unit copies from the
                # (periodic) reference so rotation reaches the array start
                ins_seq = np.asarray(ref[pos0 : pos0 + snapped],
                                     np.uint8).copy()
            pos0, ins_seq = left_align_ins_approx(ref, pos0, ins_seq)
            anchor = enc.decode(ref[pos0 - 1 : pos0])
            ref_allele = anchor
            alt_allele = anchor + enc.decode(ins_seq)
            svlen = len(alt_allele) - 1
            tname = "INS"
        counters[sig.svtype] += 1
        records.append(VcfRecord(
            chrom=chrom, pos=pos0 + ref_offset, ref=ref_allele, alt=alt_allele,
            id=f"{id_prefix}.{chrom}.{tname}.{counters[sig.svtype]}",
            qual="20", filter="PASS",
            info=dict(SVLEN=svlen, SVTYPE=tname, TIG_REGION=sig.tig_region,
                      QUERY_STRAND=sig.strand, SIG_SOURCE=sig.source,
                      TIG_MAPQ=sig.mapq),
            gt=sig.gt,
        ))
    return records


def _snap_sig_lengths(s, ref: np.ndarray, ref_offset: int) -> None:
    """In-place unit-aware canonicalization over a Sigs set: svlen snaps
    to the whole-unit multiple AND the position walks to the array start
    (two haplotypes can observe one array indel whole UNITS apart --
    beyond pair_haplotypes' shift gate; at the canonical boundary they
    pair and genotype correctly).  No-op outside tandem arrays."""
    from focalsv_tpu_torch.ops.normalize import (left_align_del,
                                           snap_indel_with_unit)
    L = len(ref)
    for i in range(len(s)):
        p0 = int(s.pos[i]) - ref_offset
        ln = int(s.svlen[i])
        if 1 <= p0 < L and ln >= 20:
            snapped, u = snap_indel_with_unit(ref, p0, ln)
            s.svlen[i] = snapped
            if u >= 3 and snapped % u == 0:
                # position canonicalization is equivalence-preserving only
                # for whole-unit lengths (shifting a non-multiple indel by
                # units changes the haplotype)
                s.pos[i] = left_align_del(ref, p0, u) + ref_offset


def call_region_variants(
    contigs_hp1: dict[str, np.ndarray],
    contigs_hp2: dict[str, np.ndarray],
    ref: np.ndarray,
    ref_offset: int,
    chrom: str,
    cfg: PipelineConfig,
    implied_alns: dict[str, list] | None = None,
) -> list[VcfRecord]:
    """Full DipPAV path for one region/chromosome worth of contigs.

    ``implied_alns`` maps contig name -> region-local alignment segments from
    guided consensus (stitch_contig_segments); contigs present there skip the
    seed-chain-extend re-alignment entirely.
    """
    aligner_holder: list = []

    def make_aligner():
        if not aligner_holder:
            aligner_holder.append(
                Aligner(np.asarray(ref, np.uint8), cfg.align, t_name=chrom))
        return aligner_holder[0]

    names1 = list(contigs_hp1)
    names2 = list(contigs_hp2)
    aln1 = _contig_alignments(contigs_hp1, implied_alns, make_aligner, chrom)
    aln2 = _contig_alignments(contigs_hp2, implied_alns, make_aligner, chrom)
    # alignments carry region-local coordinates; shift to genome space
    for a in aln1 + aln2:
        a.t_start += ref_offset
    s1 = extract_hap_sigs(aln1, names1, cfg.data_type, cfg.contig_sig)
    s2 = extract_hap_sigs(aln2, names2, cfg.data_type, cfg.contig_sig)
    # unit-aware length snap BEFORE hp pairing: two noisy observations of
    # one whole-unit array indel can measure a fraction of a unit apart,
    # fail the pairing size gate, and mis-genotype a hom event as two
    # unpaired hets (paired_sig_to_vcf re-snaps idempotently for the
    # REF/ALT build)
    _snap_sig_lengths(s1, ref, ref_offset)
    _snap_sig_lengths(s2, ref, ref_offset)
    paired = pair_haplotypes(s1, s2)
    return paired_sig_to_vcf(paired, chrom, ref, ref_offset,
                             contigs_hp1, contigs_hp2)
