"""The per-layer metrics that read the program's own spans (the
chromosomes' stage_times.json, device_stats.json ``device_s``): a run of
the cell on the CPU gives each a number, except the chunks' stream time,
which needs a card."""

import math

import pytest

from conftest import bench_json, run_small
from focalbench import harness

CELL = "target_hifi_wide32"
ON_THE_CPU = ("fetch_s_per_region.target",
              "region_write_s_per_region.target",
              "pool_offcpu_pct.target",
              "finish_queue_s_per_region.target",
              "dispatch_wait_s_per_region.target")
CARD_ONLY = ("device_ms_per_region.target",)


def test_the_metrics_are_declared_for_the_cell():
    per_layer = {m["name"]: m for m in bench_json()["per_layer"]}
    for name in ON_THE_CPU + CARD_ONLY:
        m = per_layer[name]
        assert m["workloads"] == [CELL]
        assert m["moves"] == "target_regions_per_s"
        assert m["source"] == "program_span"


@pytest.fixture(scope="module")
def cpu_run():
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("FOCALSV_TORCH_DEVICE", "cpu")
        rc, result, run = run_small(CELL)
    assert rc == 0 and result["correct"], result
    return run


@pytest.mark.parametrize("name", ON_THE_CPU)
def test_span_metric_reads_a_number_on_the_cpu(cpu_run, name):
    v = harness.reader(name)(cpu_run)
    assert v is not None and math.isfinite(v) and v > 0
    if name == "pool_offcpu_pct.target":
        assert v < 100


@pytest.mark.parametrize("name", CARD_ONLY)
def test_card_metric_reads_nothing_on_the_cpu(cpu_run, name):
    assert harness.reader(name)(cpu_run) is None


@pytest.mark.parametrize("name", ON_THE_CPU + CARD_ONLY)
def test_span_metric_reads_nothing_without_the_spans(cpu_run, name):
    """A program that records none of these (the parent of the change
    that added them) gives no number, and no error."""
    import copy
    run = copy.copy(cpu_run)
    run.passes = [copy.copy(p) for p in cpu_run.passes]
    for p in run.passes:
        p.logs = {path: {k: v for k, v in log.items()
                         if k in ("read_scan", "fp_filter_dedup", "refine",
                                  "regions_streamed", "tile_build_s",
                                  "finish_s", "n_chunks")}
                  for path, log in p.logs.items()}
    assert harness.reader(name)(run) is None
