"""The noisy-read (ONT) target mode through the dense region step, from the
CLI's entry point, on the CPU: one 15 kb region at 30x with 10 %
substitutions, 3 % insertions and 3 % deletions takes the dense encoding on
its own, and the port's run_target_mode in device mode writes the JAX
package's records.  On a card the same path runs kernel B3
(chip_smoke.py's noisy phase).  Also which encoding noisy reads take in
both packages: substitution-heavy reads go dense, indel-heavy ones stay
delta."""

import dataclasses
import json

import pytest
import torch

import focalsv_tpu.io.bam as bamio
from focalsv_tpu.config import preset
from focalsv_tpu.io.fasta import write_fasta
from focalsv_tpu.pipeline import device_exec as jdx
from focalsv_tpu.pipeline import main as jmain
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.config import config_from_reference
from focalsv_tpu_torch.config import preset as tpreset
from focalsv_tpu_torch.io.vcf import read_vcf
from focalsv_tpu_torch.ops import region_cuda
from focalsv_tpu_torch.parallel import region_step as trs
from focalsv_tpu_torch.pipeline import device_exec as dx
from focalsv_tpu_torch.pipeline import main as tmain
from focalsv_tpu_torch.testing import simulate as tsim

NOISE = dict(sub_rate=0.10, ins_rate=0.03, del_rate=0.03)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def test_noisy_region_takes_the_dense_step_and_matches_jax(tmp_path,
                                                           monkeypatch):
    kw = dict(seed=3000, ref_len=15_000, coverage=30.0, n_snps=12, **NOISE)
    rg = sim.simulate_region(**kw)
    bam = str(tmp_path / "reads.bam")
    w = bamio.BamWriter(bam, ["chr21"], [len(rg.ref)])
    for rec in sorted(rg.reads, key=lambda r: r.pos):
        w.write(rec)
    w.close()
    bamio.build_bai(bam)
    fasta = str(tmp_path / "ref.fa")
    write_fasta(fasta, [("chr21", rg.ref)])
    bed = tmp_path / "t.bed"
    bed.write_text("chr21\t100\t14900\n")

    # the port's tile of the same simulation takes the dense encoding
    trg = tsim.simulate_region(**kw)
    tile = dx.build_tile(trg.reads, trg.ref, 0, trg.chrom, tpreset("ONT"))
    assert tile.encoding == "dense"
    assert dx._bucket_key(tile, tpreset("ONT"))[0] == "dense"

    cfg = preset("ONT")
    cfg = cfg.replace(execution=dataclasses.replace(cfg.execution,
                                                    mode="device"))
    calls = []
    real = trs.phase_consensus_rows_flat

    def counted(buf, **args):
        calls.append(args["G"])
        return real(buf, **args)

    monkeypatch.setattr(trs, "phase_consensus_rows_flat", counted)
    region_cuda.reset_launches()
    want = jmain.run_target_mode(bam, fasta, str(tmp_path / "jax"), cfg,
                                 target_bed=str(bed), num_workers=1)
    got = tmain.run_target_mode(bam, fasta, str(tmp_path / "torch"),
                                config_from_reference(dataclasses.asdict(cfg)),
                                target_bed=str(bed), num_workers=1)
    assert len(calls) == 1 and region_cuda.rows_launches == 0
    with open(tmp_path / "torch" / "chr21" / "log" / "device_stats.json") as f:
        stats = json.load(f)
    assert stats["n_chunks"] == 1 and stats["n_host_fallback"] == 0
    _, want_recs = read_vcf(want)
    _, got_recs = read_vcf(got)
    assert [r.to_line() for r in got_recs] == [r.to_line() for r in want_recs]
    assert {r.info["SVTYPE"] for r in got_recs} == {"DEL", "INS"}


@pytest.mark.parametrize("noise,encoding", [
    (NOISE, "dense"),
    # on the wire the delta encoding costs 9 bytes a substitution, 12 a
    # deletion run and nothing an insertion, the rows half a byte a column:
    # noisy reads whose errors are mostly indels stay delta
    (dict(sub_rate=0.03, ins_rate=0.07, del_rate=0.06), "delta"),
    (dict(sub_rate=0.04, ins_rate=0.03, del_rate=0.05), "delta"),
], ids=["substitution_heavy", "insertion_heavy", "deletion_heavy"])
def test_encoding_of_noisy_reads_follows_substitutions(noise, encoding):
    """Which encoding a 15 kb region at 30x takes under the ONT preset: the
    port's tile and bucket equal the JAX package's."""
    kw = dict(seed=4000, ref_len=15_000, coverage=30.0, n_snps=12, **noise)
    rg = sim.simulate_region(**kw)
    want = jdx.build_tile(rg.reads, rg.ref, 0, rg.chrom, preset("ONT"))
    trg = tsim.simulate_region(**kw)
    got = dx.build_tile(trg.reads, trg.ref, 0, trg.chrom, tpreset("ONT"))
    assert got.encoding == want.encoding == encoding
    assert (dx._bucket_key(got, tpreset("ONT"))
            == jdx._bucket_key(want, preset("ONT")))
