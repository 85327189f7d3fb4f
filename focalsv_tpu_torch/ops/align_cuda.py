"""Kernel B1 on the card: the wrapper of ``csrc/banded_align.cu``.

The counterpart of ``focalsv_tpu/ops/align_pallas.py``.  It takes the
arguments of ``ops/align.py::banded_align_batch`` as CUDA tensors and returns
the same scores and direction bytes, computed by one thread block per pair
(see the note at the top of the CUDA source).  There is no fallback: a
tensor the kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focalsv_tpu_torch.ops import _build

# band state per cell in shared memory: H and F double-buffered, plus G
STATE_BYTES_PER_CELL = 20
# widest band whose state stays in shared memory; wider bands use scratch
SMEM_MAX_BAND = 10240

_lock = threading.Lock()
_fn = None
launches = 0


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            fn = _build.load_library().focalsv_banded_align
            fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 9
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def reset_launches() -> None:
    global launches
    with _lock:
        launches = 0


def _check(name: str, x: torch.Tensor, dtype: torch.dtype, ndim: int,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if x.dim() != ndim:
        raise ValueError(f"{name} must be {ndim}-D, got shape "
                         f"{tuple(x.shape)}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def banded_align_batch_cuda(q, q_len, t, t_len, d_lo, band: int,
                            match: int = 2, mismatch: int = -4,
                            gap_open: int = -4, gap_extend: int = -2,
                            store_dirs: bool = True):
    """Scores (B,) int32 and dirs (B, Lq, band) uint8 (None without
    ``store_dirs``), as ``ops/align.py::banded_align_batch`` computes them.

    q (B, Lq) and t (B, Lt) uint8, q_len, t_len and d_lo (B,) int32, all
    contiguous on one CUDA device."""
    global launches
    device = q.device
    if device.type != "cuda":
        raise ValueError(f"banded_align_batch_cuda needs CUDA tensors, got "
                         f"{device}")
    _check("q", q, torch.uint8, 2, device)
    _check("t", t, torch.uint8, 2, device)
    B, Lq = q.shape
    Lt = t.shape[1]
    for name, x in (("q_len", q_len), ("t_len", t_len), ("d_lo", d_lo)):
        _check(name, x, torch.int32, 1, device)
        if x.shape[0] != B:
            raise ValueError(f"{name} has {x.shape[0]} entries for {B} pairs")
    if t.shape[0] != B:
        raise ValueError(f"t has {t.shape[0]} rows for {B} pairs")
    W = int(band)
    if W < 1:
        raise ValueError(f"band must be positive, got {band}")
    scores = torch.empty(B, dtype=torch.int32, device=device)
    dirs = (torch.empty((B, Lq, W), dtype=torch.uint8, device=device)
            if store_dirs else None)
    if B == 0:
        return scores, dirs
    scratch = (torch.empty((B, 5 * W), dtype=torch.int32, device=device)
               if W > SMEM_MAX_BAND else None)
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(q.data_ptr(), t.data_ptr(), q_len.data_ptr(),
                 t_len.data_ptr(), d_lo.data_ptr(), scores.data_ptr(),
                 dirs.data_ptr() if dirs is not None else None,
                 scratch.data_ptr() if scratch is not None else None,
                 B, Lq, Lt, W, int(match), int(mismatch), int(gap_open),
                 int(gap_extend), int(bool(store_dirs)), stream)
    if err != 0:
        raise RuntimeError(f"banded_align kernel launch failed with CUDA "
                           f"error {err} (B={B}, Lq={Lq}, W={W})")
    with _lock:
        launches += 1
    return scores, dirs
