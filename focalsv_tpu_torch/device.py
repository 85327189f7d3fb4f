"""The port's one device decision.

Device execution runs on CUDA.  The CPU is used only when a caller passes a
CPU device or the environment asks for it (``FOCALSV_TORCH_DEVICE=cpu``, the
counterpart of ``JAX_PLATFORMS=cpu`` for the reference).  Asking for CUDA on a
machine without a card raises: nothing carries on quietly on the CPU.
"""

from __future__ import annotations

import os

import torch

DEVICE_ENV = "FOCALSV_TORCH_DEVICE"


def resolve_device(device: str | torch.device | None = None) -> torch.device:
    """The device the region step and the DP kernel run on."""
    if device is None:
        device = os.environ.get(DEVICE_ENV) or "cuda"
    dev = torch.device(device)
    if dev.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported device {dev}; use cuda or cpu")
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device execution needs a CUDA device and none is available "
            f"(set {DEVICE_ENV}=cpu to run the plain versions on the CPU)")
    return dev
