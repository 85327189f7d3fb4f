"""The port never imports jax, and nothing of the JAX package.

tests/conftest.py imports jax for the whole session, so the check runs in a
subprocess with jax and focalsv_tpu blocked: it imports focalsv_tpu_torch,
runs the golden HIFI fixture in device mode, an OLC region with every DP
job on the device batch, and every other entry point of the port once (the
multi-process executor, a host region with pair-HMM realignment, the
complex-SV, evaluation, somatic, clean-up and call-set CLIs), and records
any attempt to import jax, focalsv_tpu
or a module below either (an attempt that the port's code might catch and
pass over would otherwise go unseen).  A static case reads the port's
sources and chip_smoke.py for such an import."""

import os
import re
import subprocess
import sys
import textwrap
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
PORT = ROOT / "focalsv_tpu_torch"

GUARD = textwrap.dedent('''
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


def test_no_jax_import_in_port_sources():
    offenders = [str(p.relative_to(ROOT)) for p in PORT.rglob("*.py")
                 if "import jax" in p.read_text()
                 or "from jax" in p.read_text()]
    assert not offenders, offenders


IMPORT_OF_REFERENCE = re.compile(
    r"^\s*(from|import)\s+(jax|focalsv_tpu)(\.|\s|$)", re.M)


def test_guard_pattern_sees_an_import_put_back():
    for line in ("from focalsv_tpu.config import preset",
                 "    import focalsv_tpu.io.bam as bamio",
                 "from focalsv_tpu import native", "import jax",
                 "import focalsv_tpu"):
        assert IMPORT_OF_REFERENCE.search(line), line
    for line in ("from focalsv_tpu_torch.config import preset",
                 "import focalsv_tpu_torch", "# from focalsv_tpu import x"):
        assert not IMPORT_OF_REFERENCE.search(line), line


def test_no_import_of_the_jax_package_in_port_sources():
    """Neither the port's package, nor chip_smoke.py, nor the card tests
    (which run where there is no jax) import jax or focalsv_tpu."""
    files = list(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py",
                                        ROOT / "tests" / "test_torch_cuda.py"]
    offenders = []
    for p in files:
        for m in IMPORT_OF_REFERENCE.finditer(p.read_text()):
            offenders.append(f"{p.relative_to(ROOT)}: {m.group(0).strip()}")
    assert not offenders, offenders
