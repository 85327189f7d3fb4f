"""Auto mode (step-0 scan -> region detection -> target mode) of the port
against the JAX package's, on the CPU.

The two-chromosome genome of tests/test_mini_wgs.py (2 x 60 kb at 20x, with
its prior) and its CLR twin go through both packages' CLIs with ``--auto``:
the BED, the merged VCF and each chromosome's VCF must be the same bytes,
for HiFi and CLR (whose min_sig follows the estimated coverage), device and
host execution, with and without the prior, and with ``--chr_num``.  The
port's genome builder (testing/auto_cases.py, which chip_smoke.py's auto
phase uses) must write bench_auto.py's BAM and FASTA bytes, and the port's
native signature scan must equal its Python scan on that genome."""

import filecmp
import importlib.util
import json
import os

import pytest
import torch

from focalsv_tpu.pipeline import cli as jcli
from focalsv_tpu.pipeline import main as jmain
from focalsv_tpu_torch.config import preset
from focalsv_tpu_torch.io.vcf import read_vcf
from focalsv_tpu_torch.pipeline import cli as tcli
from focalsv_tpu_torch.pipeline import main as tmain
from focalsv_tpu_torch.testing import auto_cases

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


@pytest.fixture(scope="module")
def genomes(tmp_path_factory):
    """The mini-WGS genome with its prior, HiFi and CLR reads."""
    out = {}
    for dtype in ("HIFI", "CLR"):
        d = tmp_path_factory.mktemp(f"miniwgs_{dtype.lower()}")
        out[dtype] = auto_cases.mini_wgs(str(d), dtype)
    return out


def _auto(cli, g, out, dtype, execution, prior, chr_num):
    argv = ["--bam_file", g["bam"], "--ref_file", g["ref"], "--out_dir",
            out, "--data_type", dtype, "--auto", "--execution", execution,
            "--num_threads", "2"]
    if prior:
        argv += ["--prior_file", g["prior"]]
    if chr_num:
        argv += ["--chr_num", str(chr_num)]
    assert cli.main(argv) == 0


def _outputs(out: str) -> list[str]:
    """The BED, the merged VCF and every chromosome's VCF of an auto run."""
    names = [n for n in os.listdir(out) if n.endswith(".bed")]
    names.append("FocalSV_Final_SV.vcf")
    names += sorted(os.path.join(c, "FocalSV_Final_SV.vcf")
                    for c in os.listdir(out)
                    if os.path.isfile(os.path.join(out, c,
                                                   "FocalSV_Final_SV.vcf")))
    return names


@pytest.mark.parametrize("dtype,execution,prior,chr_num", [
    *[(d, e, p, None) for d in ("HIFI", "CLR") for e in ("device", "host")
      for p in (True, False)],
    ("HIFI", "host", True, 2),
    ("CLR", "host", True, 2),
])
def test_auto_mode_matches_jax(genomes, tmp_path, monkeypatch, dtype,
                               execution, prior, chr_num):
    """Also the min_sig that detection is handed, in both packages: the
    preset's for HiFi; for CLR 0.17 x the reference's coverage estimate
    over the chromosomes of the run."""
    from focalsv_tpu.io import bam as jbamio
    from focalsv_tpu.utils.coverage import estimate_bam_cov
    min_sig = {}
    for tag, mod in (("jax", jmain), ("torch", tmain)):
        def spy(*args, _real=mod.detect_regions, _tag=tag, **kw):
            min_sig[_tag] = args[3].min_sig
            return _real(*args, **kw)

        monkeypatch.setattr(mod, "detect_regions", spy)
    g = genomes[dtype]
    want, got = str(tmp_path / "jax"), str(tmp_path / "torch")
    _auto(jcli, g, want, dtype, execution, prior, chr_num)
    _auto(tcli, g, got, dtype, execution, prior, chr_num)
    names = _outputs(want)
    assert names == _outputs(got)
    assert names[0] == f"SV_Regions_{dtype}.bed"
    chroms = ["chr2"] if chr_num else ["chr1", "chr2"]
    assert names[2:] == [os.path.join(c, "FocalSV_Final_SV.vcf")
                         for c in chroms]
    for name in names:
        assert filecmp.cmp(os.path.join(want, name), os.path.join(got, name),
                           shallow=False), name
    with open(os.path.join(got, names[0])) as f:
        bed_chroms = [ln.split("\t")[0] for ln in f]
    assert bed_chroms == chroms
    # step 0's parts, timed by the port; each chromosome's device stats
    # count its tiles by encoding and each bucket's chunks and regions
    with open(os.path.join(got, "log", "stage_times.json")) as f:
        step0 = set(json.load(f))
    assert step0 == ({"load", "scan", "detect", "bed"}
                     | ({"coverage"} if dtype == "CLR" else set())
                     | ({"prior"} if prior else set()))
    if execution == "device":
        for c in chroms:
            with open(os.path.join(got, c, "log", "device_stats.json")) as f:
                st = json.load(f)
            tiles = st["tiles_by_encoding"]
            assert sum(tiles.values()) == bed_chroms.count(c)
            assert tiles.get("host", 0) == st["n_host_fallback"]
            assert sum(b["chunks"] for b in st["buckets"].values()) == \
                st["n_chunks"] > 0
            assert sum(b["regions"] for b in st["buckets"].values()) == \
                sum(n for k, n in tiles.items() if k != "host")
            for name, b in st["buckets"].items():
                assert name == "-".join(map(str, b["key"]))
                assert b["chunks"] * b["G"] >= b["regions"]
    _, calls = read_vcf(os.path.join(got, "FocalSV_Final_SV.vcf"))
    assert {r.chrom for r in calls} == set(chroms)
    detect = preset(dtype).detect
    if dtype == "CLR":
        cov = estimate_bam_cov(jbamio.ensure_indexed(g["bam"]), chroms)
        assert int(detect.min_sig_cov_fraction * cov) != detect.min_sig
        assert min_sig["jax"] == max(1, int(detect.min_sig_cov_fraction
                                            * cov))
    else:
        assert min_sig["jax"] == detect.min_sig
    assert min_sig["torch"] == min_sig["jax"]


def _bench_auto():
    spec = importlib.util.spec_from_file_location(
        "bench_auto", os.path.join(ROOT, "bench_auto.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("dtype,chunk", [("HIFI", None), ("CLR", 100_000)])
def test_genome_builder_writes_bench_auto_bytes(tmp_path, dtype, chunk):
    """2 x 200 kb at 30x: whole chromosomes (HIFI) and, with 100 kb
    windows, the chunked builder that chip_smoke.py's 10 Mb chromosomes
    take (CLR)."""
    bench_auto = _bench_auto()
    args = (2, 200_000, 30.0, 4, dtype)
    outs = {}
    for tag, mod in (("ref", bench_auto), ("port", auto_cases)):
        d = tmp_path / tag
        d.mkdir()
        if chunk:
            outs[tag] = mod.build_genome_chunked(str(d), *args, chunk=chunk)
        else:
            outs[tag] = mod.build_genome(str(d), *args)
    for i, name in ((0, "wgs.bam"), (0, "wgs.bam.bai"), (1, "ref.fa")):
        ref = outs["ref"][i].replace("wgs.bam", name) if i == 0 \
            else outs["ref"][i]
        port = outs["port"][i].replace("wgs.bam", name) if i == 0 \
            else outs["port"][i]
        assert filecmp.cmp(ref, port, shallow=False), name
    assert [(r.chrom, r.pos, r.info) for r in outs["ref"][2]] == \
        [(r.chrom, r.pos, r.info) for r in outs["port"][2]]


def test_native_scan_equals_python_scan(tmp_path):
    """The port's scan parity check on the builder's 2 x 200 kb genome: the
    native whole-BAM scan's signatures equal the Python scan's (the forked
    whole-chromosome fetch) on both chromosomes; the prior it writes has a
    record at every true SV and a decoy a chromosome."""
    bam, _, truth = auto_cases.build_genome(str(tmp_path), 2, 200_000, 30.0,
                                            4, "HIFI")
    got = auto_cases.scan_parity_check(bam, preset("HIFI"))
    assert got["differ"] == [] and got["checked"] > 100, got
    assert tmain._native_scan_cache == {}
    n = auto_cases.write_prior(str(tmp_path / "prior.vcf"), truth,
                               {"chr1": 200_000, "chr2": 200_000})
    _, prior = read_vcf(str(tmp_path / "prior.vcf"))
    assert n == len(prior) == len(truth) + 2
    assert [r.pos for r in prior if r.chrom == "chr1"] == sorted(
        [t.pos + 25 for t in truth if t.chrom == "chr1"] + [100_000])
