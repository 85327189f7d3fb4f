"""The benchmark's own tests run on the CPU: the program's plain versions
(``FOCALSV_TORCH_DEVICE=cpu``), small inputs.

    python -m pytest benchmark/tests -q
"""

import argparse
import json
import os
import sys
import time

import pytest

BENCH = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH)
for p in (BENCH, ROOT):
    if p not in sys.path:
        sys.path.insert(0, p)


def small(traffic: dict) -> dict:
    """A traffic mix cut to a size a CPU test holds: 4 regions of 15 and
    30 kb, or 2 chromosomes of 480 kb with 4 SVs each (half of 8 SVs lies
    past the auto configuration's limit of 3 missed)."""
    t = dict(traffic)
    if t["kind"] == "target_tiles":
        t.update(n_regions=4, widths=[15_000, 30_000])
    else:
        t.update(chrom_len=480_000, svs_per_chrom=4)
    return t


@pytest.fixture
def cpu(monkeypatch):
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


# the harness's auto-mode path, held by a configuration and a traffic mix
# of these tests (no cell of BENCHMARK.json runs auto mode yet): bench_auto's
# HiFi genome at 9 SVs a Mb, 60-3,000 bp, half DEL and half INS, half het
AUTO_CELL = dict(name="auto_hifi_test", config="hifi_auto_test",
                 traffic="hifi_genome_test", chips=1)
AUTO_CONFIG = dict(
    name="hifi_auto_test", entry="run_auto_mode", data_type="HIFI",
    overrides={}, num_workers=8, chips=1,
    limits=dict(sv_missed=3, snv_missed_pct=20, reads_untagged_pct=30,
                contig_hap_mixed_pct=2, regions_missing=0))
AUTO_TRAFFIC = dict(
    kind="genome", chroms=2, chrom_len=5_000_000, svs_per_chrom=45,
    sv_sizes=[int(round(60 * 50 ** (i / 44))) for i in range(45)],
    sv_kinds=["DEL", "INS"], sv_gts=["0/1", "1/1"], jitter=10_000,
    sub_rate=0.002, read_len_mean=12_000, read_len_sd=2_000,
    read_len_min=500, coverage=30.0, snp_every=1_200)


def bench_json() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def cells() -> list[dict]:
    return bench_json()["workloads"] + [AUTO_CELL]


def load(cell_name: str):
    """(BENCHMARK.json, cell, configuration, traffic) of a cell."""
    from focalbench import harness
    bench = bench_json()
    if cell_name == AUTO_CELL["name"]:
        return bench, AUTO_CELL, AUTO_CONFIG, AUTO_TRAFFIC
    cell = next(c for c in cells() if c["name"] == cell_name)
    return (bench, cell) + harness.cell_files(cell, bench)


def run_small(cell_name: str, seed: int = 5, seconds: float = 0.1,
              fault=None):
    """One run of a cell through the harness on the CPU at a small size,
    with ``fault`` (a context manager of focalbench/faults.py) underneath
    the whole run; returns (exit code, result, Run)."""
    import contextlib

    from focalbench import harness
    bench, cell, config, traffic = load(cell_name)
    args = argparse.Namespace(seed=seed, seconds=seconds, trace=0)
    with fault() if fault else contextlib.nullcontext():
        return harness.run_cell(args, bench, cell, config, small(traffic),
                                time.time(), 1, on_card=False)
