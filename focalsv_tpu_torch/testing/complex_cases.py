"""Seeded complex-SV inputs: an inversion and a translocation as BAM files,
a tandem duplication carried as an INS record, and a duplication inside
assembled contigs.  Shared by chip_smoke.py and tests/test_torch_complexsv.py
so that both drive the complex-SV callers on the same data."""

from __future__ import annotations

import os

import numpy as np

from focalsv_tpu_torch.align_engine import Aligner
from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.io.fasta import write_fasta
from focalsv_tpu_torch.io.vcf import VcfRecord
from focalsv_tpu_torch.ops import encode as enc


def inversion_reads(seed=21, ref_len=40_000, inv=(18_000, 24_000),
                    n_reads=40, read_len=12_000):
    """(ref, reads): reads sampled from a donor that carries ``inv``."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    donor = np.concatenate([ref[: inv[0]], enc.revcomp(ref[inv[0] : inv[1]]),
                            ref[inv[1] :]])
    reads = []
    for _ in range(n_reads):
        s = int(rng.integers(0, len(donor) - read_len))
        reads.append(donor[s : s + read_len])
    return ref, reads


def align_reads(ref, reads, chrom="chr21", aligner=Aligner):
    """BAM records (primary and supplementary) of ``reads`` against ``ref``."""
    al = aligner(ref, t_name=chrom)
    records = []
    for i, seq in enumerate(reads):
        alns = al.align(seq, f"r{i}")
        records.extend(al.to_bam_record(a, seq, alns) for a in alns)
    return records


def write_bam(path, records, names, lengths):
    w = bamio.BamWriter(path, names, lengths)
    for r in sorted(records, key=lambda r: (r.ref_id, r.pos)):
        w.write(r)
    w.close()
    bamio.build_bai(path)
    return path


def translocation_records(seed=5, bp1=100_000, bp2=50_000, n=12):
    """Split reads across a chr1:bp1 | chr2:bp2 junction, mates named by
    their SA tags."""
    rng = np.random.default_rng(seed)
    recs = []
    for i in range(n):
        a = 5000 + 200 * i           # left-segment length
        b = 12_000 - a
        seq = rng.integers(0, 4, 12_000).astype(np.uint8)
        qual = np.full(12_000, 40, np.uint8)
        recs.append(bamio.BamRecord(
            name=f"r{i}", flag=0, ref_id=0, pos=bp1 - a, mapq=60,
            cigar=np.array([[bamio.CMATCH, a], [bamio.CSOFT_CLIP, b]],
                           np.int32),
            seq=seq, qual=qual,
            tags={"SA": f"chr2,{bp2 + 1},+,{a}S{b}M,60,0;"}))
        recs.append(bamio.BamRecord(
            name=f"r{i}", flag=bamio.FLAG_SUPPLEMENTARY, ref_id=1, pos=bp2,
            mapq=60,
            cigar=np.array([[bamio.CSOFT_CLIP, a], [bamio.CMATCH, b]],
                           np.int32),
            seq=seq, qual=qual,
            tags={"SA": f"chr1,{bp1 - a + 1},+,{a}M{b}S,60,0;"}))
    return recs


def dup_as_ins_records(seed=3, ref_len=30_000, ref=None):
    """(ref, records): an 800 bp tandem duplication called as an INS, and a
    novel INS that is no duplication, on ``ref`` or a random reference."""
    rng = np.random.default_rng(seed)
    if ref is None:
        ref = rng.integers(0, 4, ref_len).astype(np.uint8)
    dup = VcfRecord(
        "chr21", 10_800, "ins1", "A", "A" + enc.decode(ref[10_000:10_800]),
        info={"SVTYPE": "INS", "SVLEN": 800, "TIG_REGION": "c1:0-800"},
        gt="0/1")
    novel = VcfRecord(
        "chr21", 20_000, "ins2", "A",
        "A" + enc.decode(rng.integers(0, 4, 700).astype(np.uint8)),
        info={"SVTYPE": "INS", "SVLEN": 700}, gt="0/1")
    return ref, [dup, novel]


def dup_contig_dir(out_dir, seed=5, dup=(30_000, 48_000)):
    """Writes HP1.fa and HP2.fa of one region whose contig carries a tandem
    duplication of ``dup`` under ``out_dir`` (the pipeline's layout);
    returns the reference."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, 80_000).astype(np.uint8)
    contig = np.concatenate([ref[22_000 : dup[1]], ref[dup[0] : dup[1]],
                             ref[dup[1] : 60_000]])
    rdir = os.path.join(out_dir, "chr21", "regions",
                        "Region_chr21_S22000_E60000")
    os.makedirs(rdir, exist_ok=True)
    write_fasta(os.path.join(rdir, "HP1.fa"), [("c_hp1_1", contig)])
    write_fasta(os.path.join(rdir, "HP2.fa"), [("c_hp2_1", contig)])
    return ref
