"""The CUDA sources of kernels B2, B3 and B6 built for the CPU, for tests.

g++ compiles ``csrc/region_step.cu`` and ``csrc/pairhmm.cu`` against
``testing/host_cuda/``, headers that stand in for the CUDA runtime and for
cooperative_groups' cluster: the
threads of a CTA are POSIX threads, ``__syncthreads`` a barrier, warp
shuffles and ballots meet at a barrier of their warp, and the CTAs of a
cluster run together and map each other's shared memory.  So the kernel's
own code (its tiles, scans, barriers and cluster exchange) runs on the CPU
at the card's block size, and a test can hold it to the plain version byte
for byte.  It says nothing of the card's speed, nor of what only the card's
compiler or memory model would do: the card tests still decide.

    from focalsv_tpu_torch.testing import host_kernel
    out = host_kernel.region_step(buf, **args, cluster=2)   # B2, a delta chunk
    out = host_kernel.region_rows(buf, **args, cluster=4)   # B3, a dense one
    out, terms = host_kernel.pairhmm(reads, rl, [(haps, hl)], quals)  # B6

The library lands in ``build/focalsv_tpu_torch/host/``, named by a hash of
the sources; nothing is built when the module is imported.  The host
library's expf and logf are glibc's, not the card's libdevice, so B6's
results here agree with the plain version on the CPU to some ulps, not bit
for bit.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np
import torch

from focalsv_tpu_torch.ops import _build, pairhmm_cuda
from focalsv_tpu_torch.ops.pairhmm import kernel_inputs
from focalsv_tpu_torch.ops.region_cuda import (KNOBS, MAX_CLUSTER,
                                               MAX_ROWS_CLUSTER,
                                               rows_scratch_words,
                                               scratch_words)
from focalsv_tpu_torch.parallel.wire import flat_layout, flat_layout_rle

HEADERS = Path(__file__).resolve().parent / "host_cuda"
SOURCE = _build.CSRC / "region_step.cu"
PAIRHMM_SOURCE = _build.CSRC / "pairhmm.cu"
FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared", "-fno-extern-tls-init",
         "-x", "c++")

_lock = threading.Lock()
_libs: dict = {}


def _compile(source: Path, defines: tuple = ()) -> ctypes.CDLL:
    """``source`` built with these -D definitions (a library each); the
    caller holds the lock."""
    flags = FLAGS + tuple(f"-D{d}" for d in defines)
    digest = hashlib.sha256(" ".join(flags).encode())
    for f in [source, *sorted(HEADERS.glob("*.h"))]:
        digest.update(f.read_bytes())
    out = _build.BUILD_DIR / "host"
    so = out / f"lib{source.stem}_host_{digest.hexdigest()[:16]}.so"
    if not so.exists():
        out.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        subprocess.run(["g++", *flags, f"-I{HEADERS}", str(source), "-o",
                        str(tmp), "-lpthread"], check=True,
                       capture_output=True, text=True)
        os.replace(tmp, so)
    return ctypes.CDLL(str(so))


def _library(defines: tuple = ()):
    """B2's and B3's source built with these -D definitions."""
    with _lock:
        if defines in _libs:
            return _libs[defines]
        lib = _compile(SOURCE, defines)
        for name, n_ints in (("focalsv_region_step", 19),
                             ("focalsv_region_rows", 17)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        lib.focalsv_region_rows_plan.argtypes = ([ctypes.c_int] * 6
                                                 + [ctypes.c_void_p])
        lib.focalsv_region_rows_plan.restype = ctypes.c_int
        _libs[defines] = lib
        return lib


def region_step(buf: np.ndarray, *, G: int, R: int, L: int, Ds: int,
                Dd: int, Drle: int, max_sites: int, mec_iters: int,
                min_site_depth: int, min_minor_count: int, lo_num: int,
                lo_den: int, hi_num: int, hi_den: int, purify_window: int,
                purify_min_pairs: int, purify_num: int, purify_den: int,
                cluster: int = 0) -> np.ndarray:
    """The kernel's (G, bytes) result of one chunk buffer, run on the CPU;
    ``cluster``: CTAs a region (1, 2, 4; 0 lets the kernel choose as on a
    card of 132 SMs).  Raises where the kernel refuses the chunk."""
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster={cluster}")
    S = max_sites
    lay = flat_layout_rle(R, S, Drle) if Drle else flat_layout(R, L, S)
    out = np.full((G, lay["__total__"][1]), 0x5A, np.uint8)
    scratch = np.full(scratch_words(G, R, Ds, Dd, Drle, S), -1, np.int32)
    buf = np.ascontiguousarray(buf, np.uint8)
    err = _library().focalsv_region_step(
        buf.ctypes.data, out.ctypes.data, scratch.ctypes.data, G, R, L, Ds,
        Dd, Drle, S, mec_iters, min_site_depth, min_minor_count, lo_num,
        lo_den, hi_num, hi_den, purify_window, purify_min_pairs, purify_num,
        purify_den, cluster, None)
    if err != 0:
        raise RuntimeError(f"the region step refused the chunk: error {err}")
    return out


def region_rows(buf: np.ndarray, *, G: int, R: int, L: int, W: int,
                max_sites: int, cluster: int = 0, smem_bytes: int = 232448,
                ring: tuple | None = None, **knobs) -> np.ndarray:
    """B3's (G, bytes) result of one dense chunk buffer
    (``wire.rows_flat_layout``), run on the CPU; ``cluster`` as in
    region_step, ``knobs`` the step's other arguments (every one of
    region_cuda.KNOBS).  ``smem_bytes``: the shared memory a CTA may take
    (the card's 232,448 by default; less moves the planes, then the read
    lists, to the scratch); ``ring``: (stages, reads a stage) of a build
    with another ring.  Raises where the kernel refuses the chunk."""
    if not 0 <= cluster <= MAX_ROWS_CLUSTER:
        raise ValueError(f"cluster={cluster}")
    lib = _library(() if ring is None else
                   (f"FOCALSV_RING_STAGES={ring[0]}",
                    f"FOCALSV_RING_GROUP={ring[1]}"))
    S = max_sites
    out = np.full((G, flat_layout(R, L, S)["__total__"][1]), 0x5A, np.uint8)
    scratch = np.full(rows_scratch_words(G, R, L, W, S), -1, np.int32)
    buf = np.ascontiguousarray(buf, np.uint8)
    with _smem(lib, smem_bytes):
        err = lib.focalsv_region_rows(
            buf.ctypes.data, out.ctypes.data, scratch.ctypes.data, G, R, L,
            W, S, *(knobs[k] for k in KNOBS), cluster, None)
    if err != 0:
        raise RuntimeError(f"the dense region step refused the chunk: error "
                           f"{err}")
    return out


@contextlib.contextmanager
def _smem(lib, smem_bytes: int):
    """The stand-in card's shared memory a CTA, for one call."""
    limit = ctypes.c_int.in_dll(lib, "emu_smem_optin")
    with _lock:
        before, limit.value = limit.value, smem_bytes
        try:
            yield
        finally:
            limit.value = before


def rows_plan(*, G: int, R: int, L: int, W: int, max_sites: int,
              cluster: int = 0, smem_bytes: int = 232448, **_) -> dict:
    """B3's launch plan of a dense chunk on the stand-in card (with
    ``smem_bytes`` of shared memory a CTA): CTAs a region, shared memory a
    CTA, the planes and the read lists in shared memory."""
    lib = _library()
    plan = (ctypes.c_int * 6)()
    with _smem(lib, smem_bytes):
        err = lib.focalsv_region_rows_plan(G, R, L, W, max_sites, cluster,
                                           plan)
    if err != 0:
        raise RuntimeError(f"the dense region step refused the chunk: error "
                           f"{err}")
    return dict(cluster=plan[0], smem_bytes=plan[1],
                planes_in_smem=bool(plan[2]), lists_in_smem=bool(plan[3]))


def pairhmm(reads, read_lens, haps, quals=None, max_read: int | None = None,
            gap_open: float = 1e-3, gap_extend: float = 0.1,
            pairs_per_warp: int | None = None, smem_bytes: int = 232448,
            lane_steps: torch.Tensor | None = None):
    """B6 run on the CPU: log P(read | hap) (n_haps, B) float32 of the read
    windows against each of ``haps`` (one or two (hap (B, N) uint8,
    hap_len (B,)) pairs) in one launch, and the (B, M + N_h) per-diagonal
    terms of each.  The inputs are prepared as for the card
    (``ops/pairhmm.py::kernel_inputs``: the emission table from the plain
    version's own torch ops); ``pairs_per_warp`` as the wrapper chooses it
    when None; ``smem_bytes`` the stand-in card's shared memory a block
    (less moves the workspaces to scratch); ``lane_steps`` a (1,) int64
    tensor that the launch adds its lane-steps to.  Raises where the kernel
    refuses them."""
    reads = np.asarray(reads)
    B = reads.shape[0]
    M = reads.shape[1] if max_read is None else int(max_read)
    reads_t, rlen, quals_t, table, haps_t, gaps = kernel_inputs(
        reads, read_lens, [(h, hl, np.asarray(h).shape[1]) for h, hl in haps],
        quals, M, torch.device("cpu"), gap_open, gap_extend)
    out = torch.full((len(haps), B), float("nan"))
    terms = [torch.full((B, M + h.shape[1]), float("nan")) for h, _ in haps_t]
    K = (pairhmm_cuda.choose_pairs_per_warp(B) if pairs_per_warp is None
         else int(pairs_per_warp))
    lib = _pairhmm_lib()
    with _smem(lib, smem_bytes):
        pairhmm_cuda.launch(lib.focalsv_pairhmm,
                            lib.focalsv_pairhmm_scratch_bytes, reads_t, rlen,
                            quals_t, table, haps_t, gaps, out, terms, K, None,
                            lane_steps)
    return out.numpy(), [t.numpy() for t in terms]


def pairhmm_scratch_bytes(B: int, M: int, widths, pairs_per_warp: int = 2,
                          smem_bytes: int = 232448) -> int:
    """The scratch B6's source asks for at this shape on the stand-in card
    (0: the workspaces fit its shared memory)."""
    lib = _pairhmm_lib()
    with _smem(lib, smem_bytes):
        return int(lib.focalsv_pairhmm_scratch_bytes(
            B, M, widths[0], widths[1] if len(widths) == 2 else 0,
            len(widths), pairs_per_warp))


def _pairhmm_lib() -> ctypes.CDLL:
    with _lock:
        if "pairhmm" not in _libs:
            _libs["pairhmm"] = pairhmm_cuda.bind(_compile(PAIRHMM_SOURCE))
        return _libs["pairhmm"]
