"""The port's pipeline (focalsv_tpu_torch) end to end on the CPU, held to
the committed golden VCFs and to the JAX package's device mode on the same
inputs: byte for byte, or record for record."""

import dataclasses
import json
import os
import threading

import numpy as np
import pytest
import torch

import focalsv_tpu.io.bam as bamio
from focalsv_tpu.config import preset
from focalsv_tpu.io.bed import Region
from focalsv_tpu.io.fasta import FastaFile, write_fasta
from focalsv_tpu.pipeline import cli as jcli
from focalsv_tpu.pipeline import main as jmain
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.parallel import batch_executor as tbe
from focalsv_tpu_torch.pipeline import cli as tcli
from focalsv_tpu_torch.pipeline import main as tmain

HERE = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(HERE, "data", "golden")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _run(cli, dtype: str, out_dir: str, execution: str) -> str:
    d = os.path.join(GOLDEN, dtype.lower())
    rc = cli.main([
        "--bam_file", os.path.join(d, "reads.bam"),
        "--ref_file", os.path.join(d, "ref.fa"),
        "--target_bed", os.path.join(d, "regions.bed"),
        "--out_dir", out_dir, "--data_type", dtype,
        "--num_threads", "1", "--execution", execution,
    ])
    assert rc == 0
    with open(os.path.join(out_dir, "FocalSV_Final_SV.vcf")) as f:
        return f.read()


@pytest.mark.parametrize("execution", ["device", "host"])
def test_golden_hifi_byte_exact(execution, tmp_path):
    got = _run(tcli, "HIFI", str(tmp_path / execution), execution)
    with open(os.path.join(GOLDEN, "hifi", "expected.vcf")) as f:
        assert got == f.read()
    if execution == "device":
        with open(tmp_path / execution / "chr21" / "log" /
                  "device_stats.json") as f:
            stats = json.load(f)
        assert stats["n_chunks"] > 0 and stats["n_host_fallback"] == 0


@pytest.mark.parametrize("dtype", ["CLR", "ONT"])
def test_golden_noisy_device_matches_jax(dtype, tmp_path):
    want = _run(jcli, dtype, str(tmp_path / "jax"), "device")
    got = _run(tcli, dtype, str(tmp_path / "torch"), "device")
    assert got == want


def _olc_chromosome(tmp_path):
    """One 12 kb region with 4 kb HiFi reads, written as BAM + FASTA."""
    rg = sim.simulate_region(seed=61, ref_len=12_000, coverage=10,
                             n_snps=12, sub_rate=0.002, read_len_mean=4000,
                             read_len_sd=300)
    bam_path = str(tmp_path / "reads.bam")
    w = bamio.BamWriter(bam_path, ["chr21"], [len(rg.ref)])
    for rec in sorted(rg.reads, key=lambda r: r.pos):
        w.write(rec)
    w.close()
    bamio.build_bai(bam_path)
    fa_path = str(tmp_path / "ref.fa")
    write_fasta(fa_path, [("chr21", rg.ref)])
    return bamio.ensure_indexed(bam_path), FastaFile.load(fa_path)


def test_olc_region_device_matches_jax(tmp_path, monkeypatch):
    """OLC assembly in device mode with every DP job on the device batch
    (dp_batching on, round-trip estimate pinned at 0): the port's records
    equal the JAX package's under the same settings."""
    monkeypatch.setenv("FOCALSV_DP_RT_MS", "0")
    cfg = preset("HIFI")
    cfg = cfg.replace(
        assembly=dataclasses.replace(cfg.assembly, method="olc"),
        execution=dataclasses.replace(cfg.execution, mode="device",
                                      dp_batching=True))
    bam, fasta = _olc_chromosome(tmp_path)
    regions = [Region("chr21", 500, 11_500)]
    out = {}
    for name, mod in (("jax", jmain), ("torch", tmain)):
        res = mod.process_chromosome(bam, fasta, "chr21", regions, cfg,
                                     out_dir=str(tmp_path / name),
                                     num_workers=2)
        out[name] = [(r.pos, r.ref, r.alt, r.gt) for r in res.records]
    assert out["torch"] == out["jax"] and out["torch"]
    with open(tmp_path / "torch" / "log" / "device_stats.json") as f:
        stats = json.load(f)
    assert stats["dp_jobs"] > 0 and stats["n_chunks"] > 0


def test_failed_batch_raises_in_every_waiting_job(monkeypatch):
    """A device batch that fails resolves no job with a stand-in score:
    every job waiting on it raises."""
    def broken(*a, **k):
        raise RuntimeError("simulated device fault")

    monkeypatch.setattr(talign, "banded_align", broken)
    rng = np.random.default_rng(0)
    pairs = [(rng.integers(0, 4, 200).astype(np.uint8),
              rng.integers(0, 4, 210).astype(np.uint8)) for _ in range(3)]
    errors = []

    def job(q, t):
        try:
            talign.banded_align_pair(q, t, band=128)
        except RuntimeError as exc:
            errors.append(exc)

    with tbe.dp_batching(init_rt_ms=0.0, max_wait_ms=50.0) as batcher:
        threads = [threading.Thread(target=job, args=p) for p in pairs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=30)
        assert not any(th.is_alive() for th in threads)
    assert len(errors) == len(pairs)
    assert all("simulated device fault" in str(e.__cause__) for e in errors)
    assert batcher.n_jobs == 0
