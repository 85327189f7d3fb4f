"""The port's span recorder (focalsv_tpu_torch/utils/profiling.py::
StageTimer) and the spans of a target-mode run, written to each
chromosome's log/stage_times.json, on the CPU."""

import dataclasses
import json
import os
import sys
import threading
import time

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile, record_function

from focalsv_tpu_torch.config import preset as tpreset
from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.parallel.batch_executor import dp_batching
from focalsv_tpu_torch.pipeline.main import run_target_mode
from focalsv_tpu_torch.utils.profiling import StageTimer, device_trace

GOLDEN_HIFI = os.path.join(os.path.dirname(__file__), "data", "golden", "hifi")
N_GOLDEN = 5
# spans a region (queue waits included), whichever path it takes
PER_REGION = ("tile_job", "finish_job", "finish_queue", "region_fetch",
              "region_tile", "region_finish", "region_write")
PER_CHUNK = ("chunk_pack", "chunk_dispatch", "chunk_wait", "chunk_decode")


def _refuse(name):
    raise AssertionError(f"record_function({name!r}) without a profiler")


# -- the recorder ----------------------------------------------------------

def test_port_stage_timer_spans_and_waits(tmp_path):
    """A span has seconds, calls and its thread's CPU seconds; an interval
    from add() has no CPU seconds."""
    t = StageTimer()
    with t.stage("busy"):
        end = time.perf_counter() + 0.05
        while time.perf_counter() < end:
            pass
    with t.stage("idle"):
        time.sleep(0.05)
    t.add("queue", 0.25)
    t.add("queue", 0.5)
    t.dump(str(tmp_path / "stage_times.json"))
    with open(tmp_path / "stage_times.json") as f:
        s = json.load(f)
    assert s["queue"] == dict(seconds=0.75, calls=2)
    for name in ("busy", "idle"):
        assert s[name]["calls"] == 1
        assert 0 <= s[name]["cpu_s"] <= s[name]["seconds"] + 0.01
    # a spinning span burns CPU, a sleeping one hardly any
    assert s["busy"]["cpu_s"] > s["idle"]["cpu_s"]
    assert s["idle"]["cpu_s"] <= 0.5 * s["idle"]["seconds"]
    assert t.seconds("queue") == 0.75 and t.seconds("absent") == 0.0


def test_port_stage_timer_loses_no_update_across_threads():
    """8 threads x 10,000 spans and adds on one timer, with the
    interpreter switching threads as often as it can: nothing is lost."""
    t = StageTimer()

    def work():
        for _ in range(10_000):
            with t.stage("span"):
                pass
            t.add("wait", 1.0)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=work) for _ in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
    finally:
        sys.setswitchinterval(old)
    assert not any(th.is_alive() for th in threads)
    s = t.summary()
    assert s["span"]["calls"] == 80_000
    assert s["wait"] == dict(seconds=80_000.0, calls=80_000)


def test_port_stage_timer_enters_no_profiler_range_without_a_profiler(
        monkeypatch):
    monkeypatch.setattr(torch.profiler, "record_function", _refuse)
    t = StageTimer()
    with t.stage("a"):
        pass
    assert t.summary()["a"]["calls"] == 1


def test_port_stage_timer_spans_land_in_the_profiler_trace(tmp_path):
    """Under torch.profiler a span is a record_function range of its own
    thread: the calling thread's with a plain profile, every thread's
    under utils/profiling.device_trace (the CLI's --device_trace)."""
    def spans_in(path):
        with open(path) as f:
            ev = json.load(f)["traceEvents"]
        return {(e["name"], e["tid"]) for e in ev
                if e.get("ph") == "X" and e["name"].startswith("span_")}

    def pool_span(t):
        with t.stage("span_pool"):
            pass

    def run(t):
        with t.stage("span_main"):
            th = threading.Thread(target=pool_span, args=(t,))
            th.start()
            th.join(timeout=30)
        assert not th.is_alive()

    t = StageTimer()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run(t)
    prof.export_chrome_trace(str(tmp_path / "plain.json"))
    assert {n for n, _ in spans_in(tmp_path / "plain.json")} >= {"span_main"}
    with device_trace(str(tmp_path / "all")):
        run(t)
    got = spans_in(tmp_path / "all" / "trace.json")
    assert {n for n, _ in got} == {"span_main", "span_pool"}
    assert len({tid for _, tid in got}) == 2
    assert t.summary()["span_pool"]["calls"] == 2


# -- the spans of a target-mode run ----------------------------------------

def _port_golden_run(out_dir: str, monkeypatch) -> dict:
    """The port's run_target_mode on the golden HiFi BED (5 regions of
    14-16 kb), device mode on the CPU, two workers; tiles past 15 kb take
    the host fallback, so both finishes run.  Returns the chromosome's
    logs and the final VCF's text."""
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")
    cfg = tpreset("HIFI")
    cfg = cfg.replace(execution=dataclasses.replace(cfg.execution,
                                                    max_tile_len=15_000))
    final = run_target_mode(
        os.path.join(GOLDEN_HIFI, "reads.bam"),
        os.path.join(GOLDEN_HIFI, "ref.fa"), out_dir, cfg,
        target_bed=os.path.join(GOLDEN_HIFI, "regions.bed"), num_workers=2)
    logs = {}
    for name in ("stage_times", "device_stats"):
        with open(os.path.join(out_dir, "chr21", "log", name + ".json")) as f:
            logs[name] = json.load(f)
    with open(final) as f:
        logs["vcf"] = f.read()
    return logs


@pytest.fixture(scope="module")
def port_golden_logs(tmp_path_factory):
    """One run with no profiler, torch.profiler.record_function made to
    raise: the spans must never enter it."""
    entered = []

    def refuse(name):
        entered.append(name)
        _refuse(name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, "record_function", refuse)
        logs = _port_golden_run(str(tmp_path_factory.mktemp("spans")), mp)
    assert entered == []
    return logs


def test_port_stage_times_hold_every_span(port_golden_logs):
    with open(os.path.join(GOLDEN_HIFI, "expected.vcf")) as f:
        assert port_golden_logs["vcf"] == f.read()
    st = port_golden_logs["stage_times"]
    for name in PER_REGION:
        assert st[name]["calls"] == N_GOLDEN, name
    # 3 regions under 15 kb go through the device step, 2 take the host
    # fallback; only the dispatched wait for their chunk
    assert st["finish_phase"]["calls"] == st["finish_call"]["calls"] == 3
    assert st["finish_host_fallback"]["calls"] == 2
    assert st["dispatch_wait"]["calls"] == 3
    for name in PER_CHUNK:
        assert st[name]["calls"] == 1, name
    # the existing stages keep their names
    for name in ("regions_streamed", "read_scan", "fp_filter_dedup",
                 "refine"):
        assert st[name]["calls"] == 1, name


def test_port_spans_nest_and_burn_no_more_cpu_than_wall(port_golden_logs):
    st = port_golden_logs["stage_times"]
    for name, v in st.items():
        if "cpu_s" in v:
            assert 0 <= v["cpu_s"] <= v["seconds"] + 0.01, name
    # queue waits are intervals between threads: no CPU seconds
    assert "cpu_s" not in st["finish_queue"]
    assert "cpu_s" not in st["dispatch_wait"]

    def s(*names):
        return sum(st[n]["seconds"] for n in names)
    assert s("region_fetch", "region_tile") <= 1.01 * s("tile_job")
    assert s("region_finish", "region_write") <= 1.01 * s("finish_job")
    assert s("finish_phase", "finish_call", "finish_host_fallback") <= \
        1.01 * s("region_finish")


def test_port_device_stats_take_the_spans(port_golden_logs):
    """tile_build_s and finish_s are the tile_job and finish_job spans;
    device_s is the chunks' stream time, 0 on the CPU; the removed keys
    are gone."""
    st = port_golden_logs["stage_times"]
    ds = port_golden_logs["device_stats"]
    assert ds["tile_build_s"] == pytest.approx(st["tile_job"]["seconds"],
                                               abs=1e-3)
    assert ds["finish_s"] == pytest.approx(st["finish_job"]["seconds"],
                                           abs=1e-3)
    assert ds["device_s"] == 0.0
    assert ds["n_chunks"] == 1 and ds["n_host_fallback"] == 2
    assert not {"device_busy_s", "device_wait_s"} & set(ds)


def test_port_region_spans_in_the_device_trace(tmp_path, monkeypatch):
    """Under utils/profiling.device_trace the pool threads' region spans
    are in the Chrome trace, inside the profiled window."""
    with device_trace(str(tmp_path / "trace")):
        with record_function("window"):
            logs = _port_golden_run(str(tmp_path / "out"), monkeypatch)
    with open(tmp_path / "trace" / "trace.json") as f:
        ev = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    window = next(e for e in ev if e["name"] == "window")
    t0, t1 = window["ts"], window["ts"] + window["dur"]
    main_tid = window["tid"]
    for name in ("region_fetch", "region_finish", "region_write"):
        got = [e for e in ev if e["name"] == name]
        assert len(got) == N_GOLDEN, name
        assert all(t0 <= e["ts"] and e["ts"] + e["dur"] <= t1
                   for e in got), name
        assert all(e["tid"] != main_tid for e in got), name
    assert logs["stage_times"]["region_fetch"]["calls"] == N_GOLDEN


def test_port_dp_batcher_spans():
    """The DP batcher's spans on the timer it is given: dp_wait for each
    batched job, dp_batch for each batch; a job that route_native keeps on
    the host makes neither."""
    rng = np.random.default_rng(3)
    pairs = [(rng.integers(0, 4, 300).astype(np.uint8),
              rng.integers(0, 4, 310).astype(np.uint8)) for _ in range(4)]
    t = StageTimer()
    with dp_batching(device="cpu", init_rt_ms=0, timer=t) as b:
        threads = [threading.Thread(target=talign.banded_align_pair,
                                    args=p) for p in pairs]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=120)
        assert not any(th.is_alive() for th in threads)
    s = t.summary()
    assert s["dp_wait"]["calls"] == b.n_jobs == 4
    assert s["dp_batch"]["calls"] == b.n_batches >= 1
    t = StageTimer()
    with dp_batching(device="cpu", init_rt_ms=1e6, timer=t) as b:
        for q, r in pairs:
            talign.banded_align_pair(q, r)
    assert b.n_jobs == 0
    assert t.summary() == {}
