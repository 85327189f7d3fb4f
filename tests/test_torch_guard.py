"""The port never imports jax.

tests/conftest.py imports jax for the whole session, so the check runs in a
subprocess with jax blocked: it imports focalsv_tpu_torch, runs the golden
HIFI fixture in device mode and an OLC region with every DP job on the
device batch, and records any attempt to import jax or a jax-bound module
of the reference package (an attempt that shared code might catch and pass
over would otherwise go unseen)."""

import os
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
    # reference modules that import jax when they load (the shared modules
    # reach jax at run time only through these)
    JAX_BOUND = {
        "focalsv_tpu.align_engine", "focalsv_tpu.assembly.olc",
        "focalsv_tpu.calling.dedup", "focalsv_tpu.calling.dippav",
        "focalsv_tpu.ops.align", "focalsv_tpu.ops.align_pallas",
        "focalsv_tpu.parallel.batch_executor",
        "focalsv_tpu.parallel.region_step",
        "focalsv_tpu.pipeline.device_exec", "focalsv_tpu.pipeline.main",
        "focalsv_tpu.pipeline.region", "focalsv_tpu.utils.profiling",
    }

    class Guard(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path, target=None):
            if name == "jax" or name.startswith("jax.") or name in JAX_BOUND:
                blocked.append(name)
                raise ImportError(f"blocked import of {name}")
            return None

    sys.modules["jax"] = None
    sys.meta_path.insert(0, Guard())

    import dataclasses
    import os

    import focalsv_tpu_torch
    from focalsv_tpu.config import preset
    from focalsv_tpu.io import bam as bamio
    from focalsv_tpu.io.fasta import write_fasta
    from focalsv_tpu.testing import simulate as sim
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
    print("BLOCKED", blocked)
    assert not blocked, blocked
    assert sys.modules.get("jax") is None
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
