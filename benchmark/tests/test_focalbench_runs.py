"""Whole runs of each cell through the harness, on the CPU at a small size:
every pass pays the whole-BAM scan, a sound run comes out correct, and the
control and every planted fault come out not correct."""

import ast
import os
import subprocess
import sys

import pytest

from conftest import BENCH, ROOT, cells, load, run_small, small
from focalbench import faults, harness, inputs

CELLS = [c["name"] for c in cells()]


@pytest.mark.parametrize("cell", CELLS)
def test_every_pass_pays_the_scan(cell, cpu, monkeypatch, tmp_path):
    """Each pass is its own call on its own path to the BAM: the native
    whole-BAM scan runs once a pass, on that pass's path, and each pass's
    stage_times.json shows its own scan."""
    from focalsv_tpu_torch.scan import fast_scan
    real = fast_scan.scan_bam_native
    paths = []

    def counting(path, *args, **kwargs):
        paths.append(path)
        return real(path, *args, **kwargs)
    monkeypatch.setattr(fast_scan, "scan_bam_native", counting)
    _, _, config, traffic = load(cell)
    inp = inputs.make(small(traffic), 5, str(tmp_path / "inputs"))
    runner = harness.Runner(config, inp, str(tmp_path), on_card=False)
    passes = [runner.run()[0] for _ in range(3)]
    # each pass once, each on its own path
    assert len(paths) == len(passes)
    assert len(set(paths)) == len(paths)
    for p in passes:
        assert p.calls
        if inp.plan.bed:
            stages = [v for k, v in p.logs.items()
                      if k.endswith("stage_times.json") and "read_scan" in v]
        else:
            stages = [p.logs[os.path.join("log", "stage_times.json")]]
            assert "scan" in stages[0]
        assert stages


@pytest.mark.parametrize("fault", sorted(faults.ALL))
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_program_is_not_correct(cell, fault, cpu):
    rc, result, _ = run_small(cell, fault=faults.ALL[fault])
    assert rc == 0
    assert result["correct"] is False
    broken = [k for k, c in result["checks"].items()
              if c["limit"] is not None and c["value"] > c["limit"]]
    print(cell, fault, broken)
    assert broken


def test_no_card_no_result():
    """Without a card the command exits with an error and prints no
    result."""
    p = subprocess.run([sys.executable, "benchmark/run.py", "--workload",
                        CELLS[0], "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=ROOT, capture_output=True,
                       text=True, env=dict(os.environ, CUDA_VISIBLE_DEVICES=""),
                       timeout=300)
    assert p.returncode != 0
    assert "correct" not in p.stdout


IMPORT_CHECK = r"""
import os, sys, argparse, time
sys.path[:0] = [{root!r}, {bench!r}]
os.environ["FOCALSV_TORCH_DEVICE"] = "cpu"
sys.path.insert(0, os.path.join({bench!r}, "tests"))
from conftest import run_small
from focalbench import harness
import readings
for m in os.listdir(os.path.join({bench!r}, "metrics")):
    if m.endswith(".py"):
        harness.reader(m[:-3])
rc, result, run = run_small({cell!r})
assert rc == 0 and result["correct"], result
print(sorted({{m.split(".")[0] for m in sys.modules}}))
"""


@pytest.mark.parametrize("cell", CELLS[:1])
def test_nothing_loads_jax_or_the_jax_package(cell):
    """A whole run in a process of its own, then the top-level names of
    every module it loaded: neither JAX nor the JAX package."""
    p = subprocess.run([sys.executable, "-c", IMPORT_CHECK.format(
        root=ROOT, bench=BENCH, cell=cell)], capture_output=True, text=True,
        timeout=900)
    assert p.returncode == 0, p.stderr[-3000:]
    loaded = set(eval(p.stdout.strip().splitlines()[-1]))
    assert "focalsv_tpu_torch" in loaded
    assert not loaded & {"jax", "jaxlib", "flax", "focalsv_tpu"}


REFERENCE = ("gen.py", "bamfile.py", "inputs.py", "oracle.py", "work.py")


@pytest.mark.parametrize("name", REFERENCE)
def test_the_reference_imports_nothing_of_the_program(name):
    """The reference and the input makers import neither JAX, nor the JAX
    package, nor the program; only the standard library, NumPy and each
    other."""
    with open(os.path.join(BENCH, "focalbench", name)) as f:
        tree = ast.parse(f.read())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            tops.add(node.module.split(".")[0])
    assert not tops & {"jax", "jaxlib", "flax", "focalsv_tpu",
                       "focalsv_tpu_torch", "torch"}
    assert tops <= set(sys.stdlib_module_names) | {"numpy", "focalbench"}
