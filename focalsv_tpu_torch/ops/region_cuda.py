"""Kernels B2 and B3 on the card: the wrappers of ``csrc/region_step.cu``.

``phase_consensus_delta_flat_cuda`` (B2) is the counterpart of the JAX
package's ``parallel/region_step.py::phase_consensus_delta_flat``: it takes a
delta chunk's one uint8 buffer (``wire.delta_flat_layout``) on a CUDA device
and returns the same (G, bytes) uint8 results as the plain version,
``parallel/region_step.py::phase_consensus_delta_flat_plain``, in one launch
a chunk.  ``phase_consensus_rows_flat_cuda`` (B3) does the same for a dense
chunk (``wire.rows_flat_layout``), the counterpart of
``phase_consensus_rows_flat``, whose plain version is
``phase_consensus_rows_flat_plain``.  The notes in the CUDA source describe
the design.  There is no fallback: a buffer a kernel does not take, or a
refused launch, raises.
"""

from __future__ import annotations

import ctypes
import threading

import torch

from focalsv_tpu_torch.ops import _build
from focalsv_tpu_torch.ops.align_cuda import _check
from focalsv_tpu_torch.parallel.wire import (BLOCK, delta_flat_layout,
                                             flat_layout, flat_layout_rle,
                                             rows_flat_layout)

_lock = threading.Lock()
_fns: dict = {}
launches = 0             # launches of kernel B2
rows_launches = 0        # launches of kernel B3
# CTAs a region (a thread-block cluster of 1, 2 or 4 for B2, 1 to 8 for
# B3); 0 lets the kernel choose from the chunk's size and the card's SM
# count.  kernel_sweep and the card tests set it to run each size.
CLUSTER = 0
MAX_CLUSTER = 4          # B2's kMaxCluster
MAX_ROWS_CLUSTER = 8     # B3's kMaxRowsCluster
ROWS_CLUSTERS = (1, 2, 4, 6, 8)   # the cluster sizes the sweeps and tests run
MAX_READS = 32767        # the kernel's kMaxReads: a count fits 16 bits

_SIGNATURES = {
    "focalsv_region_step": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 19
                            + [ctypes.c_void_p]),
    "focalsv_region_step_plan": [ctypes.c_int] * 8 + [ctypes.c_void_p],
    "focalsv_region_rows": ([ctypes.c_void_p] * 3 + [ctypes.c_int] * 17
                            + [ctypes.c_void_p]),
    "focalsv_region_rows_plan": [ctypes.c_int] * 6 + [ctypes.c_void_p],
}
# the step's knobs after max_sites, in the order the C entries take them
KNOBS = ("mec_iters", "min_site_depth", "min_minor_count", "lo_num",
         "lo_den", "hi_num", "hi_den", "purify_window", "purify_min_pairs",
         "purify_num", "purify_den")


def _kernel(name: str):
    with _lock:
        if name not in _fns:
            fn = getattr(_build.load_library(), name)
            fn.argtypes = _SIGNATURES[name]
            fn.restype = ctypes.c_int
            _fns[name] = fn
        return _fns[name]


def reset_launches() -> None:
    """B2's and B3's launch counts to 0."""
    global launches, rows_launches
    with _lock:
        launches = rows_launches = 0


def _plan_dict(plan) -> dict:
    # events_in_smem: B2's events, or B3's read lists and staged qstart
    return dict(cluster=plan[0], smem_bytes=plan[1],
                planes_in_smem=bool(plan[2]), events_in_smem=bool(plan[3]),
                registers=plan[4], local_bytes=plan[5])


def launch_plan(G: int, R: int, L: int, Ds: int, Dd: int, Drle: int,
                S: int, cluster: int | None = None) -> dict:
    """How the kernel launches a chunk on the current card: CTAs a region
    (the thread-block cluster), dynamic shared memory a CTA, whether the
    bitplanes and the events live in shared memory, and the kernel's
    registers and local-memory bytes (stack frame and spills) a thread."""
    plan = (ctypes.c_int * 6)()
    err = _kernel("focalsv_region_step_plan")(
        G, R, L, Ds, Dd, Drle, S, CLUSTER if cluster is None else cluster,
        plan)
    if err != 0:
        raise RuntimeError(f"region_step kernel refuses G={G} R={R} L={L} "
                           f"Ds={Ds} Dd={Dd} Drle={Drle} S={S}: CUDA error "
                           f"{err}")
    return _plan_dict(plan)


def rows_launch_plan(G: int, R: int, L: int, W: int, S: int,
                     cluster: int | None = None) -> dict:
    """How B3 launches a dense chunk on the current card, as launch_plan
    says it for B2 (events_in_smem is False: B3 has no events)."""
    plan = (ctypes.c_int * 6)()
    err = _kernel("focalsv_region_rows_plan")(
        G, R, L, W, S, CLUSTER if cluster is None else cluster, plan)
    if err != 0:
        raise RuntimeError(f"region_rows kernel refuses G={G} R={R} L={L} "
                           f"W={W} S={S}: CUDA error {err}")
    return _plan_dict(plan)


def scratch_words(G: int, R: int, Ds: int, Dd: int, Drle: int,
                  S: int) -> int:
    """int32 words of the kernel's scratch, per region: the three bitplanes
    (covered, minor, block assignment) of S rows by ceil(R / 32) words, used
    where they do not fit in a CTA's shared memory; then for each CTA of the
    largest cluster its events (2R + 2Dd + Ds), used where they do not fit,
    and the runs it stages for both tracks (6 (Drle + 1))."""
    events = 2 * R + 2 * Dd + Ds
    return G * (3 * S * -(-R // 32)
                + MAX_CLUSTER * (events + 6 * (Drle + 1)))


TILE = 4096               # the kernels' columns a tile


def rows_scratch_words(G: int, R: int, L: int, W: int, S: int) -> int:
    """int32 words of B3's scratch, per region: the three bitplanes, then
    for each CTA of the largest cluster (8) its read lists (16-bit, at most R
    times the tiles a read can meet, an even count), each used where it does
    not fit in a CTA's shared memory (the kernel's rows_list_stride)."""
    lists = R * min(-(-L // TILE), 2 * (W // TILE + 2))
    return G * (3 * S * -(-R // 32) + MAX_ROWS_CLUSTER * -(-lists // 2))


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
    if R > MAX_READS:
        raise ValueError(f"R={R} is past the kernel's {MAX_READS} reads")
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
    scratch = torch.empty(scratch_words(G, R, Ds, Dd, Drle, S),
                          dtype=torch.int32, device=device)
    step = _kernel("focalsv_region_step")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = step(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   G, R, L, Ds, Dd, Drle, S, mec_iters, min_site_depth,
                   min_minor_count, lo_num, lo_den, hi_num, hi_den,
                   purify_window, purify_min_pairs, purify_num, purify_den,
                   CLUSTER, stream)
    if err != 0:
        raise RuntimeError(f"region_step kernel launch failed with CUDA "
                           f"error {err} (G={G}, R={R}, L={L}, S={S})")
    with _lock:
        launches += 1
    return out


def phase_consensus_rows_flat_cuda(
        buf: torch.Tensor, *, G: int, R: int, L: int, W: int,
        max_sites: int, mec_iters: int, min_site_depth: int,
        min_minor_count: int, lo_num: int, lo_den: int, hi_num: int,
        hi_den: int, purify_window: int, purify_min_pairs: int,
        purify_num: int, purify_den: int) -> torch.Tensor:
    """Kernel B3: (G, bytes) uint8 in ``wire.flat_layout(R, L, max_sites)``,
    as ``phase_consensus_rows_flat_plain`` computes them, from the dense
    chunk's contiguous 1-D uint8 buffer in ``wire.rows_flat_layout(G, R,
    W)`` on a CUDA device; one launch."""
    global rows_launches
    device = buf.device
    _check("buf", buf, torch.uint8, 1, device)
    S = int(max_sites)
    sizes = dict(G=G, R=R, L=L, W=W, S=S)
    if any(int(v) < 1 for v in sizes.values()):
        raise ValueError(f"G, R, L, W and max_sites must be positive: "
                         f"{sizes}")
    if L % BLOCK or W % BLOCK:
        raise ValueError(f"L={L} and W={W} must be multiples of {BLOCK}")
    if L >= 1 << 26:
        raise ValueError(f"L={L} is past the kernel's 2^26 columns")
    if R > MAX_READS:
        raise ValueError(f"R={R} is past the kernel's {MAX_READS} reads")
    lay = rows_flat_layout(G, R, W)
    if buf.numel() != lay["__total__"][1]:
        raise ValueError(f"buf holds {buf.numel()} bytes, the layout of "
                         f"G={G} R={R} W={W} {lay['__total__'][1]}")
    # the rows are copied 16 bytes at a time
    if (buf.data_ptr() % 16 or lay["qstart"][0] % 4
            or lay["ltrue"][0] % 4):
        raise ValueError("the rows of buf must be 16-byte aligned and its "
                         "int32 sections 4-byte aligned")
    nbytes = flat_layout(R, L, S)["__total__"][1]
    if device.type != "cuda":
        raise ValueError(f"phase_consensus_rows_flat_cuda needs a CUDA "
                         f"buffer, got {device}")
    knobs = dict(mec_iters=mec_iters, min_site_depth=min_site_depth,
                 min_minor_count=min_minor_count, lo_num=lo_num,
                 lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
                 purify_window=purify_window,
                 purify_min_pairs=purify_min_pairs, purify_num=purify_num,
                 purify_den=purify_den)
    out = torch.empty((G, nbytes), dtype=torch.uint8, device=device)
    scratch = torch.empty(rows_scratch_words(G, R, L, W, S),
                          dtype=torch.int32, device=device)
    step = _kernel("focalsv_region_rows")
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        err = step(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                   G, R, L, W, S, *(knobs[k] for k in KNOBS), CLUSTER,
                   stream)
    if err != 0:
        raise RuntimeError(f"region_rows kernel launch failed with CUDA "
                           f"error {err} (G={G}, R={R}, L={L}, W={W}, "
                           f"S={S})")
    with _lock:
        rows_launches += 1
    return out
