"""Kernel B2 on the card: the wrapper of ``csrc/region_step.cu``.

``phase_consensus_delta_flat_cuda`` is the counterpart of the JAX package's
``parallel/region_step.py::phase_consensus_delta_flat``: it takes a delta
chunk's one uint8 buffer (``wire.delta_flat_layout``) on a CUDA device and
returns the same (G, bytes) uint8 results as the plain version,
``parallel/region_step.py::phase_consensus_delta_flat_plain``, in one launch
a chunk.  The note at the top of the CUDA source describes the design.
There is no fallback: a buffer the kernel does not take, or a refused
launch, raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focalsv_tpu_torch.ops import _build
from focalsv_tpu_torch.ops.align_cuda import _check
from focalsv_tpu_torch.parallel.wire import (delta_flat_layout, flat_layout,
                                             flat_layout_rle)

_lock = threading.Lock()
_fns: dict = {}
launches = 0             # launches of kernel B2

_SIGNATURES = {
    "focalsv_region_step": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 18
                            + [ctypes.c_void_p]),
}


def _kernel(name: str):
    with _lock:
        if name not in _fns:
            fn = getattr(_build.load_library(), name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def reset_launches() -> None:
    global launches
    with _lock:
        launches = 0


def phase_consensus_delta_flat_cuda(
        buf: torch.Tensor, *, G: int, R: int, L: int, Ds: int, Dd: int,
        Drle: int, max_sites: int, mec_iters: int, min_site_depth: int,
        min_minor_count: int, lo_num: int, lo_den: int, hi_num: int,
        hi_den: int, purify_window: int, purify_min_pairs: int,
        purify_num: int, purify_den: int) -> torch.Tensor:
    """(G, bytes) uint8 in ``wire.flat_layout_rle(R, max_sites, Drle)``
    (``Drle`` > 0) or ``wire.flat_layout(R, L, max_sites)`` (``Drle`` 0),
    as ``phase_consensus_delta_flat_plain`` computes them.

    ``buf`` is the chunk's contiguous 1-D uint8 buffer in
    ``wire.delta_flat_layout(G, R, L, Ds, Dd)`` on a CUDA device."""
    global launches
    device = buf.device
    _check("buf", buf, torch.uint8, 1, device)
    S = int(max_sites)
    sizes = dict(G=G, R=R, L=L, S=S)
    if any(int(v) < 1 for v in sizes.values()) or min(Ds, Dd, Drle) < 0:
        raise ValueError(f"G, R, L and max_sites must be positive and Ds, "
                         f"Dd, Drle not negative: {sizes}, Ds={Ds}, Dd={Dd}, "
                         f"Drle={Drle}")
    if L >= 1 << 26:
        raise ValueError(f"L={L} is past the kernel's 2^26 columns")
    lay = delta_flat_layout(G, R, L, Ds, Dd)
    if buf.numel() != lay["__total__"][1]:
        raise ValueError(f"buf holds {buf.numel()} bytes, the layout of "
                         f"G={G} R={R} L={L} Ds={Ds} Dd={Dd} "
                         f"{lay['__total__'][1]}")
    if buf.data_ptr() % 4 or any(a % 4 for name, (a, _b) in lay.items()
                                 if name not in ("ref", "rv", "sub_sym")):
        raise ValueError("the int32 sections of buf must be 4-byte aligned")
    if Drle:
        nbytes = flat_layout_rle(R, S, Drle)["__total__"][1]
    else:
        if L % 8:
            raise ValueError(f"the dense result layout needs L % 8 == 0, "
                             f"got L={L}")
        nbytes = flat_layout(R, L, S)["__total__"][1]
    if device.type != "cuda":
        raise ValueError(f"phase_consensus_delta_flat_cuda needs a CUDA "
                         f"buffer, got {device}")
    out = torch.empty((G, nbytes), dtype=torch.uint8, device=device)
    # a region's three bitplanes (covered, minor, block assignment), S rows
    # of ceil(R / 32) words: the kernel uses them where they do not fit in
    # a CTA's shared memory
    scratch = torch.empty(G * 3 * S * -(-R // 32), dtype=torch.int32,
                          device=device)
    step = _kernel("focalsv_region_step")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = step(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   G, R, L, Ds, Dd, Drle, S, mec_iters, min_site_depth,
                   min_minor_count, lo_num, lo_den, hi_num, hi_den,
                   purify_window, purify_min_pairs, purify_num, purify_den,
                   stream)
    if err != 0:
        raise RuntimeError(f"region_step kernel launch failed with CUDA "
                           f"error {err} (G={G}, R={R}, L={L}, S={S})")
    with _lock:
        launches += 1
    return out
