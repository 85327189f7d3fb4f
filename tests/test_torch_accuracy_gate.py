"""The port's accuracy gate: tests/test_accuracy_gate.py's hard floors, on
its seeds (4000 + 97*i and the named ones), through focalsv_tpu_torch.

This file runs every floor in host mode (pipeline/region.py::
process_region) and the JAX gate's own device-mode cases (its HiFi floors
and its noisy device floor); tests/test_torch_accuracy_gate_device.py runs
every other floor in device mode, so that the two halves take a worker
each.  Device mode on the CPU is the production device path (tile -> the
region step -> host finish) with the region step's plain version standing
in for the kernels (FOCALSV_TORCH_DEVICE=cpu), at chunks of a few regions
(max_regions_per_batch 1): a region's result does not depend on the
padded slots beside it, and the CPU pays for every slot.  The cases come
from the port's bench_accuracy.make_case, which tests/test_torch_benches.py
holds to bench_accuracy.py's.  The large-INS information bound (INS > ~2x
read length) is excluded by construction, as in the JAX gate."""

import dataclasses

import pytest
import torch

from focalsv_tpu_torch.benches.bench_accuracy import score_seeds
from focalsv_tpu_torch.config import preset


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def gate_config(dtype: str, mode: str, olc: bool = False):
    """The dtype's preset; with de-novo OLC assembly for ``olc``; in device
    mode with chunks of a few regions (the CPU pays for padded slots)."""
    cfg = preset(dtype)
    if olc:
        cfg = cfg.replace(assembly=dataclasses.replace(cfg.assembly,
                                                        method="olc"))
    if mode == "device":
        cfg = cfg.replace(execution=dataclasses.replace(
            cfg.execution, max_regions_per_batch=1))
    return cfg


def run(dtype: str, case: str, seeds, mode: str,
        olc: bool = False) -> tuple[int, int, int]:
    return score_seeds(dtype, case, seeds, mode,
                       gate_config(dtype, mode, olc))


def f1(tp: int, fp: int, fn: int) -> float:
    rec = tp / max(tp + fn, 1)
    prec = tp / max(tp + fp, 1)
    return 2 * prec * rec / max(prec + rec, 1e-9)


def hifi_recoverable_large_ins_floor(mode: str) -> None:
    """Large SVs within the read-evidence bound must call exactly: DEL 8.5
    kb hom, DEL 8.4 kb het, INS 8.8 kb hom, INS 5.1 kb hom."""
    tp, fp, fn = run("HIFI", "large", [4000, 4582, 4873, 5067], mode)
    assert fn == 0 and fp == 0, (mode, tp, fp, fn)


def olc_denovo_floor(mode: str) -> None:
    """De-novo OLC assembly: F1 1.0 on basic/nested for HIFI and basic for
    the noisy dtypes."""
    tp = fp = fn = 0
    for dtype, case, seeds in (
        ("HIFI", "basic", [4000, 4097]),
        ("HIFI", "nested", [4000]),
        ("CLR", "basic", [4000]),
        ("ONT", "basic", [4097]),
    ):
        t, p, n = run(dtype, case, seeds, mode, olc=True)
        tp, fp, fn = tp + t, fp + p, fn + n
    assert fn == 0 and fp == 0, (mode, tp, fp, fn)


def alnnoise_floor(dtype: str, mode: str) -> None:
    """Systematic alignment noise (indel-placement jitter and soft-clip
    growth) must not break calls."""
    tp, fp, fn = run(dtype, "alnnoise", [4000 + 97 * i for i in range(3)],
                     mode)
    assert fn == 0 and fp == 0, (dtype, mode, tp, fp, fn)


def olc_repeat_and_large_floor(mode: str) -> None:
    """OLC on whole-unit repeat indels and recoverable large events: F1 at
    least 0.85 over the set."""
    tp = fp = fn = 0
    for dtype, case, seeds in (
        ("HIFI", "repeat", [4000, 4097, 4194]),
        ("ONT", "repeat", [4097, 4679]),    # hom DEL + het DEL
        ("HIFI", "large", [4000, 4873]),    # DEL 8.5k hom, INS 8.8k hom
    ):
        t, p, n = run(dtype, case, seeds, mode, olc=True)
        tp, fp, fn = tp + t, fp + p, fn + n
    assert f1(tp, fp, fn) >= 0.85, (mode, tp, fp, fn)


def noisy_recoverable_large_floor(mode: str) -> None:
    """The large class within the read-evidence bound, noisy dtypes: DEL
    47.3 kb hom, INS 19.2 kb, INS 8.8 kb, called exactly."""
    tp = fp = fn = 0
    for dtype in ("CLR", "ONT"):
        t, p, n = run(dtype, "large", [4776, 4679, 4873], mode)
        tp, fp, fn = tp + t, fp + p, fn + n
    assert fn == 0 and fp == 0, (mode, tp, fp, fn)


def olc_clr_repeat_floor(mode: str) -> None:
    """CLR repeat through de-novo OLC, closed exactly by the tandem-array
    read-evidence arbitration (calling/array_arbitrate.py)."""
    tp, fp, fn = run("CLR", "repeat", (4000, 4097, 4485, 4679), mode,
                     olc=True)
    assert fn == 0 and fp == 0, (mode, tp, fp, fn)


def noisy_basic_floor(dtype: str, mode: str) -> None:
    tp, fp, fn = run(dtype, "basic", [4000 + 97 * i for i in range(3)],
                     mode)
    assert fn == 0 and fp == 0, (dtype, mode, tp, fp, fn)


@pytest.mark.parametrize("mode", ["host", "device"])
@pytest.mark.parametrize("case,min_f1", [
    ("basic", 1.0), ("nested", 1.0), ("dropout", 1.0), ("repeat", 1.0),
])
def test_hifi_accuracy_floor(case, min_f1, mode):
    tp, fp, fn = run("HIFI", case, [4000 + 97 * i for i in range(4)], mode)
    assert f1(tp, fp, fn) >= min_f1, (mode, case, tp, fp, fn)


@pytest.mark.parametrize("dtype", ["CLR", "ONT"])
def test_noisy_device_floor(dtype):
    """Noisy dtypes through the production device path, truth-checked."""
    tp, fp, fn = run(dtype, "basic", [4000, 4097], "device")
    assert fn == 0 and fp == 0, (dtype, tp, fp, fn)


@pytest.mark.parametrize("dtype", ["CLR", "ONT"])
def test_noisy_basic_floor(dtype):
    noisy_basic_floor(dtype, "host")


def test_hifi_recoverable_large_ins_floor():
    hifi_recoverable_large_ins_floor("host")


def test_olc_denovo_floor():
    olc_denovo_floor("host")


@pytest.mark.parametrize("dtype", ["HIFI", "CLR", "ONT"])
def test_alnnoise_floor(dtype):
    alnnoise_floor(dtype, "host")


def test_olc_repeat_and_large_floor():
    olc_repeat_and_large_floor("host")


def test_noisy_recoverable_large_floor():
    noisy_recoverable_large_floor("host")


def test_olc_clr_repeat_floor():
    olc_clr_repeat_floor("host")
