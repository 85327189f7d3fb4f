"""Genomes for auto mode: simulated chromosomes in one BAM, a prior VCF, and
the native-against-Python signature scan check.

``build_genome`` writes the same BAM and FASTA bytes as the repository's
``bench_auto.py::build_genome`` for the same arguments: chromosomes
``chr1..chrN``, SVs spread evenly with log-uniform lengths from 60 to 3,000
bp, half DEL and half INS, half of them het, at the data type's error profile.
Past ``CHUNK`` bp a chromosome is simulated in windows of ``CHUNK`` bp and
streamed into the BAM, so the builder never holds a whole chromosome's reads.
``mini_wgs`` is the two-chromosome genome of ``tests/test_mini_wgs.py`` (2 x
60 kb at 20x, two SVs and a prior of one true site and one decoy a
chromosome), with an error profile as its one argument.

Everything here uses the port's own copies of the simulator, the BAM and
FASTA writers and the truth records, so that chip_smoke.py can build the
same genomes where the JAX package is absent.
"""

from __future__ import annotations

import os
import time

import numpy as np

from focalsv_tpu_torch.evaluation.compare import truth_from_sim
from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.io.fasta import write_fasta
from focalsv_tpu_torch.io.vcf import VcfRecord, write_vcf
from focalsv_tpu_torch.testing import simulate as sim

# bench_auto.py's read error profiles
ERROR_PROFILES = {
    "HIFI": dict(sub_rate=0.002),
    "CLR": dict(sub_rate=0.06, ins_rate=0.03, del_rate=0.03),
    "ONT": dict(sub_rate=0.04, ins_rate=0.02, del_rate=0.02),
}
CHUNK = 2_000_000
# one decoy record a megabase in a prior (at least one a chromosome)
DECOY_EVERY = 1_000_000


def _random_svs(rng, n, lo, span, limit=None):
    """n SVs, one every ``span`` bp from ``lo``, as bench_auto draws them;
    stops at the first past ``limit``."""
    svs = []
    for si in range(n):
        pos = lo + si * span + int(rng.integers(0, span - 8_000))
        if limit is not None and pos >= limit:
            break
        length = int(np.exp(rng.uniform(np.log(60), np.log(3_000))))
        svtype = "DEL" if rng.random() < 0.5 else "INS"
        gt = "0/1" if rng.random() < 0.5 else "1/1"
        seq = (rng.integers(0, 4, length).astype(np.uint8)
               if svtype == "INS" else None)
        svs.append(sim.SimSV(svtype, pos, length, gt, seq=seq))
    return svs


def build_genome_chunked(tmp, n_chroms, chrom_len, coverage, svs_per_chrom,
                         dtype, chunk: int = CHUNK):
    """Chromosomes simulated in ``chunk``-bp windows, each window's reads
    written to the BAM as soon as they are made; reads do not span a
    window's edge.  Returns (bam path, FASTA path, truth records)."""
    err = ERROR_PROFILES[dtype]
    rng = np.random.default_rng(4242)
    names = [f"chr{ci + 1}" for ci in range(n_chroms)]
    bam_path = os.path.join(tmp, "wgs.bam")
    w = bamio.BamWriter(bam_path, names, [chrom_len] * n_chroms)
    truth = []
    refs = []
    n_chunks = -(-chrom_len // chunk)
    # window k takes quota[k] of the chromosome's SVs, summing to exactly
    # svs_per_chrom
    quota = [svs_per_chrom // n_chunks
             + (1 if k < svs_per_chrom % n_chunks else 0)
             for k in range(n_chunks)]
    for ci, name in enumerate(names):
        parts = []
        for ki in range(n_chunks):
            off = ki * chunk
            clen = min(chunk, chrom_len - off)
            span = max((clen - 40_000) // max(quota[ki], 1), 10_000)
            svs = _random_svs(rng, quota[ki], 20_000, span,
                              limit=clen - 20_000)
            region = sim.simulate_region(
                seed=9000 + 1000 * ci + ki, ref_len=clen, coverage=coverage,
                n_snps=clen // 1_200, svs=svs, chrom=name, **err)
            for rec in region.reads:
                rec.ref_id = ci
                rec.pos += off
                w.write(rec)
            truth.extend(truth_from_sim(region.svs, name, region.ref,
                                        ref_offset=off))
            parts.append(region.ref)
            del region
        refs.append((name, np.concatenate(parts)))
    w.close()
    bamio.build_bai(bam_path)
    ref_path = os.path.join(tmp, "ref.fa")
    write_fasta(ref_path, refs)
    return bam_path, ref_path, truth


def build_genome(tmp, n_chroms, chrom_len, coverage, svs_per_chrom, dtype):
    """``n_chroms`` chromosomes of ``chrom_len`` bp at ``coverage`` with
    ``svs_per_chrom`` SVs each; chunked past ``CHUNK`` bp.  Returns (bam
    path, FASTA path, truth records)."""
    if chrom_len > CHUNK:
        return build_genome_chunked(tmp, n_chroms, chrom_len, coverage,
                                    svs_per_chrom, dtype)
    err = ERROR_PROFILES[dtype]
    rng = np.random.default_rng(4242)
    chroms, truth = {}, []
    for ci in range(n_chroms):
        name = f"chr{ci + 1}"
        span = (chrom_len - 40_000) // svs_per_chrom
        svs = _random_svs(rng, svs_per_chrom, 20_000, span)
        region = sim.simulate_region(seed=9000 + ci, ref_len=chrom_len,
                                     coverage=coverage,
                                     n_snps=chrom_len // 1_200, svs=svs,
                                     chrom=name, **err)
        chroms[name] = region
        truth.extend(truth_from_sim(region.svs, name, region.ref))
    bam_path = os.path.join(tmp, "wgs.bam")
    w = bamio.BamWriter(bam_path, list(chroms),
                        [len(chroms[c].ref) for c in chroms])
    for ci, c in enumerate(chroms):
        for rec in chroms[c].reads:
            rec.ref_id = ci
            w.write(rec)
    w.close()
    bamio.build_bai(bam_path)
    ref_path = os.path.join(tmp, "ref.fa")
    write_fasta(ref_path, [(c, chroms[c].ref) for c in chroms])
    return bam_path, ref_path, truth


def write_prior(path: str, truth: list[VcfRecord],
                chrom_lens: dict[str, int]) -> int:
    """A population prior as tests/test_mini_wgs.py writes one: a record 25
    bp past each true SV, of its type, and one decoy INS a megabase (the
    middle of each, or of a shorter chromosome).  Returns the record count."""
    prior = [VcfRecord(r.chrom, r.pos + 25, ".", "N",
                       f"<{r.info['SVTYPE']}>",
                       info={"SVTYPE": r.info["SVTYPE"]}) for r in truth]
    for chrom, n in chrom_lens.items():
        for mb in range(max(1, n // DECOY_EVERY)):
            start = mb * DECOY_EVERY
            pos = start + min(DECOY_EVERY, n - start) // 2
            prior.append(VcfRecord(chrom, pos, ".", "N", "<INS>",
                                   info={"SVTYPE": "INS"}))
    order = {c: i for i, c in enumerate(chrom_lens)}
    prior.sort(key=lambda r: (order[r.chrom], r.pos))
    write_vcf(path, prior)
    return len(prior)


def mini_wgs(d: str, dtype: str = "HIFI") -> dict:
    """tests/test_mini_wgs.py's genome in directory ``d``: chr1 and chr2 of
    60 kb at 20x, a het DEL at 18 kb and a hom INS at 42 kb on each, and its
    prior (the DEL 25 bp on, a decoy INS at 55 kb).  ``dtype`` picks the
    reads' error profile (HIFI: the simulator's default, as the test has it;
    CLR and ONT: bench_auto's)."""
    err = {} if dtype == "HIFI" else ERROR_PROFILES[dtype]
    rng = np.random.default_rng(88)
    chroms = {}
    truth = []
    for ci, chrom in enumerate(("chr1", "chr2")):
        svs = [
            sim.SimSV("DEL", 18_000, 150 + 40 * ci, "0/1"),
            sim.SimSV("INS", 42_000, 220 + 30 * ci, "1/1",
                      seq=rng.integers(0, 4, 220 + 30 * ci).astype(np.uint8)),
        ]
        region = sim.simulate_region(seed=700 + ci, ref_len=60_000,
                                     coverage=20, n_snps=50, svs=svs,
                                     chrom=chrom, **err)
        chroms[chrom] = region
        truth.extend(truth_from_sim(region.svs, chrom, region.ref))
    bam_path = os.path.join(d, "wgs.bam")
    w = bamio.BamWriter(bam_path, list(chroms),
                        [len(chroms[c].ref) for c in chroms])
    for ci, chrom in enumerate(chroms):
        for rec in chroms[chrom].reads:
            rec.ref_id = ci
            w.write(rec)
    w.close()
    bamio.build_bai(bam_path)
    ref_path = os.path.join(d, "ref.fa")
    write_fasta(ref_path, [(c, chroms[c].ref) for c in chroms])
    prior_path = os.path.join(d, "prior.vcf")
    prior = []
    for chrom, region in chroms.items():
        prior.append(VcfRecord(chrom, region.svs[0].pos + 25, ".", "N",
                               "<DEL>", info={"SVTYPE": "DEL"}))
        prior.append(VcfRecord(chrom, 55_000, ".", "N", "<INS>",
                               info={"SVTYPE": "INS"}))
    write_vcf(prior_path, prior)
    return dict(dir=d, bam=bam_path, ref=ref_path, prior=prior_path,
                truth=truth)


def scan_parity_check(bam_path: str, cfg) -> dict:
    """The native whole-BAM signature scan (pipeline/main.py's
    ``_native_chrom_scan``, scan/fast_scan.py) against the Python scan of
    each whole chromosome (scan/read_scan.py over ``BamReader.fetch``): the
    sorted (pos, length) of the DEL and the INS signatures must be equal on
    every chromosome.  Raises if the native scan is absent.  Returns the
    signatures checked, the (chromosome, kind) sets that differ and the
    seconds of each scan."""
    from focalsv_tpu_torch.pipeline import main as pipeline_main
    from focalsv_tpu_torch.scan.read_scan import scan_chromosome

    bam = bamio.ensure_indexed(bam_path)
    pipeline_main._native_scan_cache.clear()
    checked, differ, native_s, python_s = 0, [], 0.0, 0.0
    for c in bam.ref_names:
        t0 = time.perf_counter()
        nat = pipeline_main._native_chrom_scan(bam, c, cfg)
        native_s += time.perf_counter() - t0
        if nat is None:
            raise RuntimeError("the native signature scan did not run")
        t0 = time.perf_counter()
        _, py = scan_chromosome(bam.fetch(c), c, cfg.read_scan,
                                genotype=False)
        python_s += time.perf_counter() - t0
        for kind in ("del_sigs", "ins_sigs"):
            a = sorted((s.pos, s.length) for s in getattr(nat, kind))
            b = sorted((s.pos, s.length) for s in getattr(py, kind))
            checked += len(b)
            if a != b:
                differ.append((c, kind))
    pipeline_main._native_scan_cache.clear()
    return dict(checked=checked, differ=differ, native_s=native_s,
                python_s=python_s)
