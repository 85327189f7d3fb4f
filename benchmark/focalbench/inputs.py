"""A run's input files from its traffic mix and seed: reference FASTA, BAM
and index, and for target mixes the BED; with the truth kept for the
comparison and the sizes kept for the least-time formula (``work.py``).
Made anew in every run, segment by segment, so the reads of one segment
at a time are held."""

from __future__ import annotations

import os
from dataclasses import dataclass, field

import numpy as np

from focalbench import bamfile, gen


@dataclass
class Inputs:
    plan: gen.Plan
    bam: str
    ref: str
    bed: str | None
    truth: list[gen.SimSegment]            # reads dropped, counts kept
    counts: list[dict] = field(default_factory=list)   # one a segment
    bam_bytes: int = 0

    @property
    def n_regions(self) -> int:
        return len(self.plan.bed)

    @property
    def megabases(self) -> float:
        return sum(n for _, n in self.plan.chroms) / 1e6


def _counts(sim: gen.SimSegment) -> dict:
    """What the least-time formula (``work.py``) counts, inside the
    segment's BED interval (the whole segment where it has none): reads,
    columns, (read, SNP site) entries, and events: substitutions, SNP
    alleles carried and indel operations."""
    seg = sim.seg
    lo, hi = seg.bed if seg.bed is not None else (seg.offset,
                                                   seg.offset + seg.width)
    events = entries = 0
    order = np.argsort(sim.snps[:, 0])
    snp_pos = sim.snps[order, 0] + seg.offset
    snp_hap = sim.snps[order, 3]
    for r in sim.reads:
        p = r.pos
        for op, ln in r.cigar:
            if op == gen.CMATCH:
                a, b = max(p, lo), min(p + ln, hi)
                if b > a:
                    i, j = np.searchsorted(snp_pos, [a, b])
                    entries += int(j - i)
                    events += int((snp_hap[i:j] == r.hap).sum())
                p += ln
            elif op == gen.CDEL:
                events += int(lo <= p < hi)
                p += ln
            elif op == gen.CINS:
                events += int(lo <= p < hi)
        events += r.n_sub
    return dict(reads=len(sim.reads), columns=hi - lo,
                site_entries=entries, events=events)


def make(traffic: dict, seed: int, out_dir: str) -> Inputs:
    plan = gen.plan(traffic, seed)
    os.makedirs(out_dir, exist_ok=True)
    rid = {c: i for i, (c, _) in enumerate(plan.chroms)}
    truth, counts = [], []

    def records():
        for seg in plan.segments:
            sim = gen.simulate(seg, traffic)
            counts.append(_counts(sim))
            for r in sim.reads:
                yield rid[seg.chrom], r.name, r.pos, r.cigar, r.seq
            sim.spans = np.array(
                [(r.pos, bamfile.ref_end(r.pos, r.cigar), r.hap)
                 for r in sim.reads], np.int64).reshape(-1, 3)
            sim.reads = []
            truth.append(sim)

    bam = os.path.join(out_dir, "reads.bam")
    nbytes = bamfile.write_bam(bam, plan.chroms, records())
    refs = {}
    for sim in truth:
        refs.setdefault(sim.seg.chrom, []).append(sim.ref)
    ref = os.path.join(out_dir, "ref.fa")
    bamfile.write_fasta(ref, [(c, np.concatenate(refs[c]))
                              for c, _ in plan.chroms])
    bed = None
    if plan.bed:
        bed = os.path.join(out_dir, "targets.bed")
        with open(bed, "w") as f:
            f.writelines(f"{c}\t{s}\t{e}\n" for c, s, e in plan.bed)
    return Inputs(plan, bam, ref, bed, truth, counts, nbytes)
