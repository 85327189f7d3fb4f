"""Kernel B6 on the card: the wrapper of ``csrc/pairhmm.cu``.

``pairhmm_cuda`` is the counterpart of the JAX package's
``ops/pairhmm.py::pairhmm_forward_batch``: it takes the read windows, their
qualities (clamped to [0, 255]) and the emission table that
``ops/pairhmm.py::emission_table`` builds with the plain version's own ops,
and one or two haplotype windows per read, all as CUDA tensors, and returns
log P(read | hap) for each haplotype from one launch.  Any read or window
width is taken: past the card's shared memory the kernel's workspaces go to
device scratch that this wrapper allocates.  The note at the top of the
CUDA source describes the design.  There is no fallback: a tensor the
kernel does not take, or a refused launch, raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focalsv_tpu_torch.ops import _build

_lock = threading.Lock()
_lib = None
launches = 0     # launches of kernel B6
windows = 0      # (read, haplotype) pairs those launches computed

# (read, window) pairs a warp takes by the reads of a call, both windows
# of a read one after the other: one pair while a call leaves the card's
# warps few (a warp's steps in a row set the time), two as it fills the
# card (fewer idle lanes a pair).  The realignment's calls (278 to 2,605
# reads, chip_smoke.py phase 9c) never gain from four.  On an H100, at the
# calls' shape, one pair a warp is 1.2x faster up to 750 reads, and two
# 1.05x faster from 800 (kernel_sweep.py --b6-only, B6_CUT_SCAN): the time
# at one pair steps up once 2 B warps pass 12 an SM.
PAIRS_BY_BATCH = ((0, 1), (800, 2))

# focalsv_pairhmm: reads, read_lens, quals, table, hap0, hap_len0, hap1,
# hap_len1, out, terms0, terms1, scratch, lane_steps; scratch_bytes; B, M,
# N0, N1, n_haps, pairs_per_warp; l_mm, l_gm, l_go, l_ge, l_ins; stream
_ARGTYPES = ([ctypes.c_void_p] * 13 + [ctypes.c_longlong]
             + [ctypes.c_int] * 6 + [ctypes.c_float] * 5 + [ctypes.c_void_p])


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Set the argument types of B6's two C entries in ``lib``."""
    lib.focalsv_pairhmm.argtypes = _ARGTYPES
    lib.focalsv_pairhmm.restype = ctypes.c_int
    lib.focalsv_pairhmm_scratch_bytes.argtypes = [ctypes.c_int] * 6
    lib.focalsv_pairhmm_scratch_bytes.restype = ctypes.c_longlong
    return lib


def _library() -> ctypes.CDLL:
    global _lib
    with _lock:
        if _lib is None:
            _lib = bind(_build.load_library())
        return _lib


def _kernel():
    """B6's C entry."""
    return _library().focalsv_pairhmm


def reset_launches() -> None:
    global launches, windows
    with _lock:
        launches = 0
        windows = 0


def choose_pairs_per_warp(B: int) -> int:
    """The (read, window) pairs a warp of B6 takes for a batch of B reads
    (PAIRS_BY_BATCH)."""
    return max(k for b, k in PAIRS_BY_BATCH if B >= b)


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


def check_inputs(reads, read_lens, quals, table, haps, gaps) -> list:
    """Raise on what B6 does not take; the widths of ``haps``."""
    device = reads.device
    if reads.dim() != 2 or reads.shape[1] < 1:
        raise ValueError(f"reads must be (B, M) with M >= 1, got shape "
                         f"{tuple(reads.shape)}")
    B, M = reads.shape
    _check("reads", reads, torch.uint8, (B, M), device)
    _check("read_lens", read_lens, torch.int32, (B,), device)
    if quals is not None:
        _check("quals", quals, torch.uint8, (B, M), device)
    _check("table", table, torch.float32, (2, 256), device)
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
    return widths


def launch(fn, scratch_bytes, reads, read_lens, quals, table, haps, gaps,
           out, terms, K: int, stream, lane_steps=None) -> None:
    """One call of B6's C entry ``fn`` on these tensors (on the device that
    ``fn`` runs on), with the scratch that ``scratch_bytes`` (the source's
    focalsv_pairhmm_scratch_bytes) asks for; ``lane_steps`` a (1,) int64
    tensor that the launch adds its lane-steps to, or None; raises on a
    refusal."""
    B, M = reads.shape
    widths = [int(h.shape[1]) for h, _ in haps]
    n1 = widths[1] if len(widths) == 2 else 0
    need = scratch_bytes(B, M, widths[0], n1, len(haps), K)
    if need < 0:
        raise ValueError(f"B6 refused the shape B={B}, M={M}, N={widths}, "
                         f"pairs_per_warp={K}")
    scratch = (torch.empty(need, dtype=torch.uint8, device=reads.device)
               if need else None)
    args = []
    for h in range(2):
        if h < len(haps):
            args += [haps[h][0].data_ptr(), haps[h][1].data_ptr()]
        else:
            args += [None, None]
    term_ptrs = [terms[h].data_ptr() if terms is not None and h < len(haps)
                 else None for h in range(2)]
    err = fn(reads.data_ptr(), read_lens.data_ptr(),
             quals.data_ptr() if quals is not None else None,
             table.data_ptr(), *args, out.data_ptr(), *term_ptrs,
             scratch.data_ptr() if scratch is not None else None,
             lane_steps.data_ptr() if lane_steps is not None else None, need,
             B, M, widths[0], n1, len(haps), K, *map(float, gaps), stream)
    if err != 0:
        raise RuntimeError(f"pair-HMM kernel launch failed with CUDA error "
                           f"{err} (B={B}, M={M}, N={widths}, "
                           f"pairs_per_warp={K})")


def pairhmm_cuda(reads, read_lens, quals, table, haps, gaps,
                 want_terms: bool = False, pairs_per_warp: int | None = None,
                 lane_steps: torch.Tensor | None = None):
    """log P(read | hap) (n_haps, B) float32 of B read windows against each
    of ``haps``, and the per-diagonal terms (a list of (B, M + N_h) float32,
    or None without ``want_terms``), as
    ``ops/pairhmm.py::pairhmm_forward_batch_plain`` computes them.

    reads (B, M) uint8, read_lens (B,) int32, quals (B, M) uint8 (the phred
    qualities clamped to [0, 255]) or None (quality 30), table the (2, 256)
    float32 emissions by quality; haps one or two (hap (B, N_h) uint8,
    hap_len (B,) int32) pairs; gaps the float32 log probabilities (l_mm,
    l_gm, l_go, l_ge, l_ins).  All contiguous on one CUDA device.
    ``pairs_per_warp``: the (read, window) pairs a warp takes
    (``choose_pairs_per_warp(B)`` when None).  ``lane_steps``: a (1,) int64
    tensor on the device to which the launch adds the lane-steps it took
    (32 times each warp's steps, idle lanes included), or None."""
    global launches, windows
    device = reads.device
    if device.type != "cuda":
        raise ValueError(f"pairhmm_cuda needs CUDA tensors, got {device}")
    widths = check_inputs(reads, read_lens, quals, table, haps, gaps)
    if lane_steps is not None:
        _check("lane_steps", lane_steps, torch.int64, (1,), device)
    B, M = reads.shape
    K = (choose_pairs_per_warp(B) if pairs_per_warp is None
         else int(pairs_per_warp))
    out = torch.empty((len(haps), B), dtype=torch.float32, device=device)
    terms = ([torch.empty((B, M + n), dtype=torch.float32, device=device)
              for n in widths] if want_terms else None)
    if B == 0:
        return out, terms
    fn = _kernel()
    with torch.cuda.device(device):
        launch(fn, _library().focalsv_pairhmm_scratch_bytes, reads,
               read_lens, quals, table, haps, gaps, out, terms, K,
               torch.cuda.current_stream(device).cuda_stream, lane_steps)
    with _lock:
        launches += 1
        windows += B * len(haps)
    return out, terms
