"""The rest of the port's accuracy gate in device mode on the CPU:
tests/test_accuracy_gate.py's floors that the JAX gate runs in host mode
only, each through the production device path (tile -> the region step's
plain version -> host finish), on the same seeds.  The floors and their
helpers live in tests/test_torch_accuracy_gate.py, which runs them in host
mode; this file gives the device half a worker of its own."""

import pytest
import torch

from test_torch_accuracy_gate import (alnnoise_floor,
                                      hifi_recoverable_large_ins_floor,
                                      noisy_basic_floor,
                                      noisy_recoverable_large_floor,
                                      olc_clr_repeat_floor, olc_denovo_floor,
                                      olc_repeat_and_large_floor)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("dtype", ["CLR", "ONT"])
def test_noisy_basic_floor_device(dtype):
    noisy_basic_floor(dtype, "device")


def test_hifi_recoverable_large_ins_floor_device():
    hifi_recoverable_large_ins_floor("device")


def test_olc_denovo_floor_device():
    olc_denovo_floor("device")


@pytest.mark.parametrize("dtype", ["HIFI", "CLR", "ONT"])
def test_alnnoise_floor_device(dtype):
    alnnoise_floor(dtype, "device")


def test_olc_repeat_and_large_floor_device():
    olc_repeat_and_large_floor("device")


def test_noisy_recoverable_large_floor_device():
    noisy_recoverable_large_floor("device")


def test_olc_clr_repeat_floor_device():
    olc_clr_repeat_floor("device")
