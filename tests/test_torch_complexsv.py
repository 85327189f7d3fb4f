"""The port's complex-SV callers (focalsv_tpu_torch/complexsv) against the
JAX package's on the same seeded inputs: the split-read auto caller, the
typed-window target caller, the INS->DUP and contig DUP routes and the CLI.
Records and VCF files are equal (tolerance 0: the callers are integer and
string work on the aligner's output, and the aligner's DP is integer)."""

import dataclasses
import io
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from focalsv_tpu.align_engine import Aligner as JAligner
from focalsv_tpu.complexsv import auto as jauto
from focalsv_tpu.complexsv import cli as jcli
from focalsv_tpu.complexsv import target as jtarget
from focalsv_tpu.io import bam as jbamio
from focalsv_tpu.io.bed import Region as JRegion
from focalsv_tpu.io.vcf import VcfRecord as JVcfRecord
from focalsv_tpu_torch.complexsv import auto as tauto
from focalsv_tpu_torch.complexsv import cli as tcli
from focalsv_tpu_torch.complexsv import target as ttarget
from focalsv_tpu_torch.io import bam as tbamio
from focalsv_tpu_torch.io.bed import Region as TRegion
from focalsv_tpu_torch.io.fasta import write_fasta
from focalsv_tpu_torch.testing import complex_cases as cc


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _rec_key(r):
    return (r.chrom, r.pos, r.id, r.ref, r.alt, r.gt,
            sorted((k, str(v)) for k, v in r.info.items()))


def _svs(by_chrom):
    """ClusteredSV lists as plain tuples (each package has its own class)."""
    return {c: [dataclasses.astuple(s) for s in v]
            for c, v in by_chrom.items()}


def _bam_key(r):
    return (r.name, r.flag, r.ref_id, r.pos, r.mapq, r.cigar.tolist(),
            r.seq.tolist(), sorted(r.tags.items()))


@pytest.fixture(scope="module")
def inv_case(tmp_path_factory):
    """The inversion's reads aligned by both packages' aligners (equal
    records), written once as a BAM that both packages read."""
    torch.set_num_threads(1)
    os.environ["FOCALSV_TORCH_DEVICE"] = "cpu"
    d = tmp_path_factory.mktemp("complex")
    ref, reads = cc.inversion_reads()
    recs_t = cc.align_reads(ref, reads)
    recs_j = cc.align_reads(ref, reads, aligner=JAligner)
    bam = cc.write_bam(str(d / "inv.bam"), recs_t, ["chr21"], [len(ref)])
    fa = str(d / "ref.fa")
    write_fasta(fa, [("chr21", ref)])
    return dict(bam=bam, ref=fa, ref_codes=ref, recs_t=recs_t, recs_j=recs_j,
                inv=(18_000, 24_000))


def test_aligner_split_records_equal(inv_case):
    got = [_bam_key(r) for r in inv_case["recs_t"]]
    assert got == [_bam_key(r) for r in inv_case["recs_j"]]
    assert any(r.is_supplementary for r in inv_case["recs_t"])


def test_auto_inversion_equal(inv_case):
    res_t = tauto.call_complex_auto({"chr21": inv_case["recs_t"]}, "HIFI")
    res_j = jauto.call_complex_auto({"chr21": inv_case["recs_j"]}, "HIFI")
    assert _svs(res_t.invs) == _svs(res_j.invs)
    assert _svs(res_t.dups) == _svs(res_j.dups)
    assert res_t.tras == res_j.tras
    invs = tauto.filter_tra_inv(res_t.invs["chr21"], min_sup=2, min_mapq=5,
                                min_size=1000)
    invs_j = jauto.filter_tra_inv(res_j.invs["chr21"], min_sup=2, min_mapq=5,
                                  min_size=1000)
    assert _svs({"chr21": invs}) == _svs({"chr21": invs_j})
    best = max(invs, key=lambda s: s.support)
    assert abs(best.start - 18_000) < 1500 and abs(best.end - 24_000) < 1500
    vcf_t = tauto.complex_result_to_vcf(res_t)
    vcf_j = jauto.complex_result_to_vcf(res_j)
    assert [_rec_key(r) for r in vcf_t] == [_rec_key(r) for r in vcf_j]


def test_auto_duplication_equal():
    """A 15 kb tandem DUP, longer than the reads: split alignments."""
    rng = np.random.default_rng(12)
    ref = rng.integers(0, 4, 60_000).astype(np.uint8)
    donor = np.concatenate([ref[:35_000], ref[20_000:35_000], ref[35_000:]])
    reads = []
    for _ in range(60):
        s = int(rng.integers(0, len(donor) - 12_000))
        reads.append(donor[s : s + 12_000].copy())
    recs_t = cc.align_reads(ref, reads)
    recs_j = cc.align_reads(ref, reads, aligner=JAligner)
    assert [_bam_key(r) for r in recs_t] == [_bam_key(r) for r in recs_j]
    res_t = tauto.call_complex_auto({"chr21": recs_t}, "HIFI")
    res_j = jauto.call_complex_auto({"chr21": recs_j}, "HIFI")
    assert _svs(res_t.dups) == _svs(res_j.dups)
    assert _svs(res_t.invs) == _svs(res_j.invs)
    best = max((d for d in res_t.dups["chr21"] if d.support >= 2),
               key=lambda s: s.support)
    assert abs(best.start - 20_000) < 1500 and abs(best.end - 35_000) < 1500


def test_auto_translocation_equal():
    recs_t = cc.translocation_records()
    recs_j = [jbamio.BamRecord(name=r.name, flag=r.flag, ref_id=r.ref_id,
                               pos=r.pos, mapq=r.mapq, cigar=r.cigar,
                               seq=r.seq, qual=r.qual, tags=dict(r.tags))
              for r in recs_t]

    def by_chrom(recs):
        return {"chr1": [r for r in recs if r.ref_id == 0],
                "chr2": [r for r in recs if r.ref_id == 1]}

    res_t = tauto.call_complex_auto(by_chrom(recs_t), "HIFI")
    res_j = jauto.call_complex_auto(by_chrom(recs_j), "HIFI")
    assert res_t.tras == res_j.tras and res_t.tras
    assert res_t.tras[0][0] == "chr1" and res_t.tras[0][3] == 12


def test_recover_dup_from_ins_equal():
    ref, recs_t = cc.dup_as_ins_records()
    recs_j = [JVcfRecord(r.chrom, r.pos, r.id, r.ref, r.alt,
                         info=dict(r.info), gt=r.gt) for r in recs_t]
    dups_t = ttarget.recover_dup_from_ins(recs_t, {"chr21": ref})
    dups_j = jtarget.recover_dup_from_ins(recs_j, {"chr21": ref})
    assert [_rec_key(r) for r in dups_t] == [_rec_key(r) for r in dups_j]
    assert len(dups_t) == 1 and dups_t[0].info["SVTYPE"] == "DUP"
    assert abs(dups_t[0].pos - 10_000) < 100


def test_target_inv_window_equal(inv_case):
    regions = [("chr21", 15_000, 27_000)]
    res_t = ttarget.call_complex_target(
        tbamio.BamReader(inv_case["bam"]),
        {"INV": [TRegion(*r) for r in regions]}, "HIFI", min_support=2)
    res_j = jtarget.call_complex_target(
        jbamio.BamReader(inv_case["bam"]),
        {"INV": [JRegion(*r) for r in regions]}, "HIFI", min_support=2)
    got = [_rec_key(r) for r in res_t.all_records()]
    assert got == [_rec_key(r) for r in res_j.all_records()] and got
    best = max(res_t.invs, key=lambda r: r.info["SUPPORT"])
    assert abs(best.pos - 18_000) < 1500


def test_target_tra_window_equal(tmp_path):
    bam = cc.write_bam(str(tmp_path / "tra.bam"), cc.translocation_records(),
                       ["chr1", "chr2"], [200_000, 200_000])
    region = ("chr1", 95_000, 105_000)
    res_t = ttarget.call_complex_target(
        tbamio.BamReader(bam), {"TRA": [TRegion(*region)]}, "HIFI",
        min_support=2)
    res_j = jtarget.call_complex_target(
        jbamio.BamReader(bam), {"TRA": [JRegion(*region)]}, "HIFI",
        min_support=2)
    got = [_rec_key(r) for r in res_t.all_records()]
    assert got == [_rec_key(r) for r in res_j.all_records()] and res_t.tras
    best = max(res_t.tras, key=lambda r: r.info["SUPPORT"])
    assert best.chrom == "chr1" and abs(best.pos - 100_000) < 1500


def test_split_typed_bed_equal():
    rows = [(("chr1", 0, 100), "DUP"), (("chr1", 200, 300), "INV"),
            (("chr2", 0, 50), "TRA"), (("chr2", 60, 80), "inv")]
    out_t = ttarget.split_typed_bed([(TRegion(*r), t) for r, t in rows])
    out_j = jtarget.split_typed_bed([(JRegion(*r), t) for r, t in rows])
    assert {k: [(r.chrom, r.start, r.end) for r in v]
            for k, v in out_t.items()} == {
        k: [(r.chrom, r.start, r.end) for r in v] for k, v in out_j.items()}
    assert len(out_t["INV"]) == 2


def test_call_dup_from_contigs_equal(tmp_path):
    ref = cc.dup_contig_dir(str(tmp_path))
    dups_t = ttarget.call_dup_from_contigs(str(tmp_path), {"chr21": ref},
                                           "HIFI", min_support=1)
    dups_j = jtarget.call_dup_from_contigs(str(tmp_path), {"chr21": ref},
                                           "HIFI", min_support=1)
    assert [_rec_key(r) for r in dups_t] == [_rec_key(r) for r in dups_j]
    best = max(dups_t, key=lambda r: int(r.info["SUPPORT"]))
    assert abs(best.pos - 30_000) < 2_000
    assert best.info["SIG_SOURCE"] == "contig"


@pytest.mark.parametrize("mode", ["auto", "target"])
def test_cli_vcf_equal(inv_case, tmp_path, mode):
    a, b = inv_case["inv"]
    bed = str(tmp_path / "typed.bed")
    with open(bed, "w") as f:
        f.write(f"chr21\t{a - 3000}\t{b + 3000}\tINV\n")
    vcfs = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        out = str(tmp_path / name)
        args = ["--mode", mode, "--bam_file", inv_case["bam"], "-d", "HIFI",
                "-o", out, "--min_support", "2"]
        if mode == "target":
            args += ["--bed_file", bed, "--ref_file", inv_case["ref"]]
        with redirect_stdout(io.StringIO()):
            assert cli.main(args) == 0
        with open(os.path.join(out, "FocalSV_TRA_INV_DUP.vcf")) as f:
            vcfs[name] = f.read()
    assert vcfs["torch"] == vcfs["jax"]
    assert "SVTYPE=INV" in vcfs["torch"]
