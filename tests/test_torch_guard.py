"""The port never imports jax, and nothing of the JAX package.

tests/conftest.py imports jax for the whole session, so the check runs in a
subprocess with jax and focalsv_tpu blocked: it imports focalsv_tpu_torch,
runs the golden HIFI fixture in device mode, auto mode with a prior on two
chromosomes of noisy reads, an OLC region with every DP
job on the device batch, and every other entry point of the port once (the
multi-process executor, a host region with pair-HMM realignment, the
complex-SV, evaluation, somatic, clean-up and call-set CLIs, the dry run on
a mesh of two shards, each measurement module's --help), and records
any attempt to import jax, focalsv_tpu
or a module below either (an attempt that the port's code might catch and
pass over would otherwise go unseen).  A second case runs the two-rank entry
(testing/dist_worker.py over gloo) with the same block in each rank.  A
static case reads the port's sources and chip_smoke.py for such an
import."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "focalsv_tpu_torch"

BLOCK = textwrap.dedent('''
    import importlib.abc
    import sys

    blocked = []
    BLOCKED_ROOTS = ("jax", "focalsv_tpu")

    class Guard(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name.split(".")[0] in BLOCKED_ROOTS:
                blocked.append(name)
                raise ImportError(f"blocked import of {name}")
            return None

    sys.modules["jax"] = None
    sys.modules["focalsv_tpu"] = None
    sys.meta_path.insert(0, Guard())
''')

GUARD = BLOCK + textwrap.dedent('''
    import dataclasses
    import os

    import focalsv_tpu_torch
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io import bam as bamio
    from focalsv_tpu_torch.io.fasta import write_fasta
    from focalsv_tpu_torch.testing import simulate as sim
    from focalsv_tpu_torch.pipeline import cli, main

    golden, out = sys.argv[1], sys.argv[2]
    rc = cli.main(["--bam_file", f"{golden}/reads.bam",
                   "--ref_file", f"{golden}/ref.fa",
                   "--target_bed", f"{golden}/regions.bed",
                   "--out_dir", f"{out}/golden", "--data_type", "HIFI",
                   "--num_threads", "1", "--execution", "device"])
    assert rc == 0
    with open(f"{out}/golden/FocalSV_Final_SV.vcf") as f:
        got = f.read()
    with open(f"{golden}/expected.vcf") as f:
        assert got == f.read(), "golden HIFI VCF differs"

    # auto mode on two chromosomes with a prior: the native step-0 scan,
    # the coverage estimate of noisy reads, detection, then target mode
    from focalsv_tpu_torch.testing import auto_cases
    os.makedirs(f"{out}/wgs")
    wgs = auto_cases.mini_wgs(f"{out}/wgs", "CLR")
    rc = cli.main(["--bam_file", wgs["bam"], "--ref_file", wgs["ref"],
                   "--out_dir", f"{out}/auto", "--data_type", "CLR",
                   "--auto", "--prior_file", wgs["prior"],
                   "--num_threads", "2", "--execution", "device"])
    assert rc == 0
    assert main._native_scan_cache.get(wgs["bam"]) is not None
    for c in ("chr1", "chr2"):
        assert os.path.exists(f"{out}/auto/{c}/FocalSV_Final_SV.vcf")
    with open(f"{out}/auto/SV_Regions_CLR.bed") as f:
        assert {ln.split()[0] for ln in f} == {"chr1", "chr2"}

    rg = sim.simulate_region(seed=62, ref_len=8000, coverage=6, n_snps=8,
                             sub_rate=0.002, read_len_mean=3000,
                             read_len_sd=200)
    w = bamio.BamWriter(f"{out}/olc.bam", ["chr21"], [len(rg.ref)])
    for rec in sorted(rg.reads, key=lambda r: r.pos):
        w.write(rec)
    w.close()
    bamio.build_bai(f"{out}/olc.bam")
    write_fasta(f"{out}/olc.fa", [("chr21", rg.ref)])
    with open(f"{out}/olc.bed", "w") as f:
        f.write("chr21\\t300\\t7700\\n")
    cfg = preset("HIFI")
    cfg = cfg.replace(
        assembly=dataclasses.replace(cfg.assembly, method="olc"),
        execution=dataclasses.replace(cfg.execution, mode="device",
                                      dp_batching=True))
    main.run_target_mode(f"{out}/olc.bam", f"{out}/olc.fa", f"{out}/olc",
                         cfg, target_bed=f"{out}/olc.bed", num_workers=2)
    import json
    with open(f"{out}/olc/chr21/log/device_stats.json") as f:
        assert json.load(f)["dp_jobs"] > 0

    # the multi-process executor: one child, one region
    import numpy as np
    from focalsv_tpu_torch.pipeline.mp_exec import MpRegionExecutor
    sim.write_region_bam(rg, f"{out}/mp.bam")
    np.save(f"{out}/mp.npy", rg.ref)
    stats = {}
    with MpRegionExecutor(preset("HIFI"), n_children=1) as ex:
        res = ex.run([(f"{out}/mp.bam", f"{out}/mp.npy", "chr21")],
                     collect="records", stats=stats)
    assert res[0][1] is not None and stats["cuda_initialized"] == 0

    # a host region with pair-HMM realignment
    from focalsv_tpu_torch.pipeline.region import process_region
    hmm = preset("HIFI")
    hmm = hmm.replace(phasing=dataclasses.replace(hmm.phasing,
                                                  use_pairhmm=True))
    rg_hmm = sim.simulate_region(seed=5, ref_len=6000, coverage=12, n_snps=8,
                                 read_len_mean=2500)
    assert process_region(rg_hmm.reads, rg_hmm.ref, 0, "chr21",
                          hmm).n_phased > 0

    # the complex-SV CLI, both modes, on split reads across a translocation
    from focalsv_tpu_torch.complexsv import cli as ccli
    from focalsv_tpu_torch.testing import complex_cases as cc
    cc.write_bam(f"{out}/tra.bam", cc.translocation_records(),
                 ["chr1", "chr2"], [200_000, 200_000])
    with open(f"{out}/typed.bed", "w") as f:
        f.write("chr1\\t95000\\t105000\\tTRA\\n")
    assert ccli.main(["--mode", "auto", "--bam_file", f"{out}/tra.bam",
                      "-d", "HIFI", "-o", f"{out}/cauto"]) == 0
    assert ccli.main(["--mode", "target", "--bam_file", f"{out}/tra.bam",
                      "--bed_file", f"{out}/typed.bed", "-d", "HIFI",
                      "-o", f"{out}/ctarget"]) == 0
    with open(f"{out}/ctarget/FocalSV_TRA_INV_DUP.vcf") as f:
        assert "SVTYPE=TRA" in f.read()
    ref, ins = cc.dup_as_ins_records()
    from focalsv_tpu_torch.complexsv.target import recover_dup_from_ins
    assert len(recover_dup_from_ins(ins, {"chr21": ref})) == 1

    # evaluation, somatic merge, clean-up, call-set converter
    from focalsv_tpu_torch.evaluation import cli as ecli
    from focalsv_tpu_torch.evaluation import somatic
    from focalsv_tpu_torch.evaluation.compare import truth_from_sim
    from focalsv_tpu_torch.io.vcf import write_vcf
    from focalsv_tpu_torch.tools import callset_to_bed, clean
    write_vcf(f"{out}/truth.vcf", truth_from_sim(rg.svs, "chr21", rg.ref))
    calls = f"{out}/olc/FocalSV_Final_SV.vcf"
    assert ecli.main(["bench", "--call", calls, "--truth",
                      f"{out}/truth.vcf"]) == 0
    assert ecli.main(["protocol", "--call", calls, "--truth",
                      f"{out}/truth.vcf", "--out_dir", f"{out}/proto"]) == 0
    assert ecli.main(["grid", "--call", calls, "--truth", f"{out}/truth.vcf",
                      "--out_dir", f"{out}/grid", "--refdists", "100,500",
                      "--pctsims", "0.0,0.5"]) == 0
    assert ecli.main(["figdata", "--call", calls, "--truth",
                      f"{out}/truth.vcf", "--out_dir", f"{out}/grid"]) == 0
    assert somatic.main(["-n", f"{out}/cauto/FocalSV_TRA_INV_DUP.vcf", "-t",
                         f"{out}/ctarget/FocalSV_TRA_INV_DUP.vcf", "-o",
                         f"{out}/somatic.vcf"]) == 0
    with open(f"{out}/calls.csv", "w") as f:
        f.write(",chrom1,pos1,chrom2,pos2,svsize,svtype\\n"
                "0,chr1,1000000,chr1,1200000,200000,DUP\\n")
    assert callset_to_bed.main([f"{out}/calls.csv", f"{out}/calls.bed"]) == 0
    assert clean.main(["--out_dir", f"{out}/olc", "--dry_run"]) == 0

    # the multi-device path: the dry run on a mesh of two shards
    from focalsv_tpu_torch.testing import dryrun
    fn, args = dryrun.entry()
    assert fn(*args)[0].shape == (8,)
    dryrun.dryrun_multichip(2)

    # the fetch timing and kernel B2's source built for the CPU
    import torch

    from focalsv_tpu_torch.testing import fetch_timing, host_kernel
    from focalsv_tpu_torch.testing import region_cases
    timed = fetch_timing.time_fetches(
        f"{golden}/reads.bam", [("chr21", 10000, 26000),
                                ("chr21", 34000, 48000)], reps=1)
    assert timed["same"] and timed["records"] > 0, timed
    from focalsv_tpu_torch.parallel import region_step as rs
    buf, args = region_cases.build("mec_one_round")
    kw = {**rs.STEP_DEFAULTS, **args}
    want = rs.phase_consensus_delta_flat_plain(torch.from_numpy(buf), **kw)
    assert (host_kernel.region_step(buf, **kw) == want.numpy()).all()

    # each measurement module's --help
    import contextlib
    import io
    import runpy
    for name in ("bench", "bench_auto", "bench_scaling", "bench_accuracy",
                 "bench_accuracy_complex"):
        sys.argv = [name, "--help"]
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text):
                runpy.run_module(f"focalsv_tpu_torch.benches.{name}",
                                 run_name="__main__")
        except SystemExit as e:
            assert e.code == 0, (name, e.code)
        assert "usage: python -m focalsv_tpu_torch.benches." + name in \
            text.getvalue(), text.getvalue()
    print("BLOCKED", blocked)
    assert not blocked, blocked
    assert sys.modules.get("jax") is None
    assert sys.modules.get("focalsv_tpu") is None
    print("GUARD OK")
''')


def test_port_runs_with_jax_blocked(tmp_path):
    env = dict(os.environ, FOCALSV_TORCH_DEVICE="cpu", FOCALSV_DP_RT_MS="0",
               OMP_NUM_THREADS="1", PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    proc = subprocess.run(
        [sys.executable, "-c", GUARD, str(ROOT / "tests" / "data" / "golden" /
                                          "hifi"), str(tmp_path)],
        capture_output=True, text=True, env=env, timeout=600, cwd=tmp_path)
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-6000:]
    assert "GUARD OK" in proc.stdout


RANK = BLOCK + textwrap.dedent('''
    import runpy
    sys.argv = ["dist_worker"] + sys.argv[1:]
    runpy.run_module("focalsv_tpu_torch.testing.dist_worker",
                     run_name="__main__")
    import torch.distributed
    assert not torch.distributed.is_initialized()
    assert not blocked, blocked
    assert sys.modules.get("jax") is None
    assert sys.modules.get("focalsv_tpu") is None
    print("GUARD OK")
''')


def test_two_rank_entry_runs_with_jax_blocked(tmp_path):
    """Two ranks of testing/dist_worker.py over gloo on the CPU, jax and
    focalsv_tpu blocked in each: the collective branch writes the VCF and
    each rank leaves its group."""
    import socket

    from focalsv_tpu_torch.io.fasta import write_fasta
    from focalsv_tpu_torch.testing import simulate as sim
    rg = sim.simulate_region(seed=11, ref_len=8_192, coverage=12, n_snps=12,
                             svs=[sim.SimSV("DEL", 4_000, 120, "1/1")],
                             chrom="chr21")
    sim.write_region_bam(rg, str(tmp_path / "r.bam"))
    write_fasta(str(tmp_path / "ref.fa"), [("chr21", rg.ref)])
    with open(tmp_path / "t.bed", "w") as f:
        f.write("chr21\t500\t4100\nchr21\t3900\t7700\n")
    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        port = sock.getsockname()[1]
    env = dict(os.environ, FOCALSV_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=str(ROOT))
    env.pop("JAX_PLATFORMS", None)
    procs = [subprocess.Popen(
        [sys.executable, "-c", RANK, "--pid", str(rank), "--nprocs", "2",
         "--port", str(port), "--bam", str(tmp_path / "r.bam"), "--ref",
         str(tmp_path / "ref.fa"), "--bed", str(tmp_path / "t.bed"), "--out",
         str(tmp_path / "out"), "--device", "cpu", "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env,
        cwd=tmp_path) for rank in range(2)]
    try:
        outs = [p.communicate(timeout=300)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    for p, out in zip(procs, outs):
        assert p.returncode == 0 and "GUARD OK" in out, out[-4000:]
    assert "final VCF (collective gather)" in outs[0]
    with open(tmp_path / "out" / "FocalSV_Final_SV.vcf") as f:
        dels = [ln for ln in f if "SVTYPE=DEL" in ln]
    assert len(dels) == 1      # called by both ranks, kept once


def test_no_jax_import_in_port_sources():
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if "import jax" in p.read_text()
                 or "from jax" in p.read_text()]
    assert not offenders, offenders


IMPORT_OF_REFERENCE = re.compile(
    r"^\s*(from|import)\s+(jax|focalsv_tpu|bench|bench_auto|bench_accuracy|"
    r"bench_accuracy_complex|bench_scaling)(\.|\s|$)", re.M)


def test_guard_pattern_sees_an_import_put_back():
    for line in ("from focalsv_tpu.config import preset",
                 "    import focalsv_tpu.io.bam as bamio",
                 "from focalsv_tpu import native", "import jax",
                 "import focalsv_tpu", "from bench_auto import build_genome",
                 "    import bench_auto", "import bench",
                 "    import bench as jbench", "from bench import _make_jobs",
                 "import bench_accuracy",
                 "from bench_accuracy import make_case",
                 "    import bench_accuracy_complex",
                 "from bench_accuracy_complex import _run_type",
                 "import bench_scaling", "    from bench_scaling import main"):
        assert IMPORT_OF_REFERENCE.search(line), line
    for line in ("from focalsv_tpu_torch.config import preset",
                 "import focalsv_tpu_torch", "# from focalsv_tpu import x",
                 "from focalsv_tpu_torch.benches import bench",
                 "from focalsv_tpu_torch.benches.bench_accuracy import x",
                 "import benchmark", "import bench_autox"):
        assert not IMPORT_OF_REFERENCE.search(line), line


def test_no_import_of_the_jax_package_in_port_sources():
    """Neither the port's package (its auto-mode genome builder and its
    bench modules included), nor chip_smoke.py, nor the card tests (which
    run where there is no jax) import jax, focalsv_tpu or one of the
    repository's measurement scripts (bench.py, bench_auto.py,
    bench_accuracy.py, bench_accuracy_complex.py, bench_scaling.py), which
    import the latter."""
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tests" / "test_torch_cuda.py"]
    offenders = []
    for p in files:
        for m in IMPORT_OF_REFERENCE.finditer(p.read_text()):
            offenders.append(f"{p.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
