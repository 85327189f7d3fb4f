"""Kernel B6 on the card: the wrapper of ``csrc/pairhmm.cu``.

``pairhmm_cuda`` is the counterpart of the JAX package's
``ops/pairhmm.py::pairhmm_forward_batch``: it takes the read windows, their
emissions (``lm_match`` and ``lm_mis``, computed by the caller with the
plain version's own ops) and one or two haplotype windows per read, all as
CUDA tensors, and returns log P(read | hap) for each haplotype from one
launch.  The note at the top of the CUDA source describes the design.
There is no fallback: a tensor the kernel does not take, or a refused
launch, raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focalsv_tpu_torch.ops import _build

# the widest read window B6 takes (4 groups of 32 rows a lane): the
# kernel's focalsv_pairhmm_max_read()
MAX_READ = 127

_lock = threading.Lock()
_fn = None
launches = 0     # launches of kernel B6
windows = 0      # (read, haplotype) pairs those launches computed

_ARGTYPES = ([ctypes.c_void_p] * 4
             + ([ctypes.c_void_p] * 4 + [ctypes.c_int]) * 2
             + [ctypes.c_int] * 3 + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def _kernel():
    global _fn
    with _lock:
        if _fn is None:
            fn = _build.load_library().focalsv_pairhmm
            fn.argtypes = _ARGTYPES
            fn.restype = ctypes.c_int
            _fn = fn
        return _fn


def reset_launches() -> None:
    global launches, windows
    with _lock:
        launches = 0
        windows = 0


def _check(name: str, x, dtype: torch.dtype, shape: tuple,
           device: torch.device) -> None:
    if not isinstance(x, torch.Tensor):
        raise TypeError(f"{name} must be a torch.Tensor, got {type(x)}")
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != dtype:
        raise TypeError(f"{name} must be {dtype}, got {x.dtype}")
    if tuple(x.shape) != shape:
        raise ValueError(f"{name} has shape {tuple(x.shape)}, expected "
                         f"{shape}")
    if not x.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def pairhmm_cuda(reads, read_lens, lm_match, lm_mis, haps, gaps,
                 want_terms: bool = False):
    """log P(read | hap) (n_haps, B) float32 of B read windows against each
    of ``haps``, and the per-diagonal terms (a list of (B, M + N_h) float32,
    or None without ``want_terms``), as
    ``ops/pairhmm.py::pairhmm_forward_batch_plain`` computes them.

    reads (B, M) uint8, read_lens (B,) int32, lm_match and lm_mis (B, M)
    float32; haps one or two (hap (B, N_h) uint8, hap_len (B,) int32)
    pairs; gaps the float32 log probabilities (l_mm, l_gm, l_go, l_ge,
    l_ins).  All contiguous on one CUDA device; 1 <= M <= MAX_READ."""
    global launches, windows
    device = reads.device
    if device.type != "cuda":
        raise ValueError(f"pairhmm_cuda needs CUDA tensors, got {device}")
    if reads.dim() != 2:
        raise ValueError(f"reads must be 2-D, got shape {tuple(reads.shape)}")
    B, M = reads.shape
    if not 1 <= M <= MAX_READ:
        raise ValueError(f"B6 takes read windows of 1 to {MAX_READ} bases, "
                         f"got {M}")
    _check("reads", reads, torch.uint8, (B, M), device)
    _check("read_lens", read_lens, torch.int32, (B,), device)
    _check("lm_match", lm_match, torch.float32, (B, M), device)
    _check("lm_mis", lm_mis, torch.float32, (B, M), device)
    if len(haps) not in (1, 2):
        raise ValueError(f"B6 takes one or two haplotypes, got {len(haps)}")
    widths = []
    for h, (hap, hap_len) in enumerate(haps):
        if hap.dim() != 2 or hap.shape[1] < 1:
            raise ValueError(f"hap {h} must be (B, N) with N >= 1, got "
                             f"{tuple(hap.shape)}")
        _check(f"hap {h}", hap, torch.uint8, (B, hap.shape[1]), device)
        _check(f"hap_len {h}", hap_len, torch.int32, (B,), device)
        widths.append(int(hap.shape[1]))
    if len(gaps) != 5:
        raise ValueError(f"gaps must hold 5 values, got {len(gaps)}")
    out = torch.empty((len(haps), B), dtype=torch.float32, device=device)
    terms = ([torch.empty((B, M + n), dtype=torch.float32, device=device)
              for n in widths] if want_terms else None)
    if B == 0:
        return out, terms
    args = []
    for h in range(2):
        if h < len(haps):
            hap, hap_len = haps[h]
            args += [hap.data_ptr(), hap_len.data_ptr(), out[h].data_ptr(),
                     terms[h].data_ptr() if terms is not None else None,
                     widths[h]]
        else:
            args += [None, None, None, None, 0]
    fn = _kernel()
    stream = torch.cuda.current_stream(device).cuda_stream
    with torch.cuda.device(device):
        err = fn(reads.data_ptr(), read_lens.data_ptr(), lm_match.data_ptr(),
                 lm_mis.data_ptr(), *args, B, M, len(haps),
                 *map(float, gaps), stream)
    if err != 0:
        raise RuntimeError(f"pair-HMM kernel launch failed with CUDA error "
                           f"{err} (B={B}, M={M}, N={widths})")
    with _lock:
        launches += 1
        windows += B * len(haps)
    return out, terms
