"""The CUDA source of kernels B2 and B3 built for the CPU, for tests.

g++ compiles ``csrc/region_step.cu`` against ``testing/host_cuda/``, headers
that stand in for the CUDA runtime and for cooperative_groups' cluster: the
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

The library lands in ``build/focalsv_tpu_torch/host/``, named by a hash of
the sources; nothing is built when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path

import numpy as np

from focalsv_tpu_torch.ops import _build
from focalsv_tpu_torch.ops.region_cuda import (KNOBS, MAX_CLUSTER,
                                               scratch_words)
from focalsv_tpu_torch.parallel.wire import flat_layout, flat_layout_rle

HEADERS = Path(__file__).resolve().parent / "host_cuda"
SOURCE = _build.CSRC / "region_step.cu"
FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared", "-fno-extern-tls-init",
         "-x", "c++")

_lock = threading.Lock()
_lib = None


def _library():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        digest = hashlib.sha256(" ".join(FLAGS).encode())
        for f in [SOURCE, *sorted(HEADERS.glob("*.h"))]:
            digest.update(f.read_bytes())
        out = _build.BUILD_DIR / "host"
        so = out / f"libregion_step_host_{digest.hexdigest()[:16]}.so"
        if not so.exists():
            out.mkdir(parents=True, exist_ok=True)
            tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
            subprocess.run(["g++", *FLAGS, f"-I{HEADERS}", str(SOURCE), "-o",
                            str(tmp), "-lpthread"], check=True,
                           capture_output=True, text=True)
            os.replace(tmp, so)
        lib = ctypes.CDLL(str(so))
        for name, n_ints in (("focalsv_region_step", 19),
                             ("focalsv_region_rows", 17)):
            fn = getattr(lib, name)
            fn.argtypes = ([ctypes.c_void_p] * 3 + [ctypes.c_int] * n_ints
                           + [ctypes.c_void_p])
            fn.restype = ctypes.c_int
        _lib = lib
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
                max_sites: int, cluster: int = 0, **knobs) -> np.ndarray:
    """B3's (G, bytes) result of one dense chunk buffer
    (``wire.rows_flat_layout``), run on the CPU; ``cluster`` as in
    region_step, ``knobs`` the step's other arguments (every one of
    region_cuda.KNOBS).  Raises where the kernel refuses the chunk."""
    if not 0 <= cluster <= MAX_CLUSTER:
        raise ValueError(f"cluster={cluster}")
    S = max_sites
    out = np.full((G, flat_layout(R, L, S)["__total__"][1]), 0x5A, np.uint8)
    scratch = np.full(scratch_words(G, R, 0, 0, 0, S), -1, np.int32)
    buf = np.ascontiguousarray(buf, np.uint8)
    err = _library().focalsv_region_rows(
        buf.ctypes.data, out.ctypes.data, scratch.ctypes.data, G, R, L, W, S,
        *(knobs[k] for k in KNOBS), cluster, None)
    if err != 0:
        raise RuntimeError(f"the dense region step refused the chunk: error "
                           f"{err}")
    return out
