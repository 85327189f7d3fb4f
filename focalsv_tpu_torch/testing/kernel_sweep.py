"""Times kernel B1's launch configurations and kernel B4 on one NVIDIA GPU.

    python -m focalsv_tpu_torch.testing.kernel_sweep [--full] [--b4-only]

Builds the kernels, prints what ptxas reports (registers, spills, shared
memory), and for each band width of the main path runs B1 with every
cells-per-thread setting that fits, checks each against the plain version
byte for byte on a few pairs, and prints CUDA-event times at batches of 1,
2 and 128 pairs.  Then B4 (the traceback) on B1's direction bytes against
its plain version and against the host traceback, with its time at 1, 2 and
all pairs, on the HiFi shapes, a leading-insertion case and a noisy
(CLR-like) walk, and on the crafted long-gap walks of testing/dp_cases.py.
Beside each B4 time stands its latency floor: the dependent decisions of
the batch's longest walk (one per state change plus one per 32 ops of a
run) times one shared-memory load-to-use, which a pointer chase
(testing/smem_chase.cu) measures on the card.  ``--b4-only`` skips B1's
sweep.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import subprocess
import sys

import numpy as np
import torch

from focalsv_tpu_torch.ops import _build
from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.ops import align_cuda
from focalsv_tpu_torch.testing.dp_cases import (ALIGNER_SCORING, OLC_SCORING,
                                                UNIT_COSTS, dp_pairs,
                                                noisy_pairs, walk_cases,
                                                walk_decisions)


def time_ms(fn, reps: int) -> float:
    fn()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def smem_load_to_use() -> tuple[float, float]:
    """(cycles, nanoseconds) of one dependent shared-memory load on this
    card, from the pointer chase of testing/smem_chase.cu."""
    src = _build.PKG / "testing" / "smem_chase.cu"
    so = _build.BUILD_DIR / "libfocalsv_smem_chase.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS[:-2], "-shared", "-o",
                    str(so), str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).focalsv_smem_chase
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = torch.zeros(3, dtype=torch.int64, device="cuda")
    steps = 1 << 20
    best = None
    for _ in range(3):
        err = fn(out.data_ptr(), steps,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"pointer chase launch failed: CUDA error {err}")
        torch.cuda.synchronize()
        cyc, ns = (float(x) / steps for x in out[:2].tolist())
        best = (cyc, ns) if best is None else min(best, (cyc, ns))
    return best


def b4_case(name, dirs, q_len, t_len, d_lo, W, Lq, n_plain, batches,
            load_ns) -> bool:
    """B4 on one case's direction bytes: against its plain version on the
    first n_plain pairs and against the host traceback on up to 8 of them,
    and its time at each batch size beside the latency floor."""
    ops_k, n_k = align_cuda.traceback_cuda(dirs, q_len, t_len, d_lo, W, Lq)
    torch.cuda.synchronize()
    ops_p, n_p = talign.traceback_device(
        dirs[:n_plain], q_len[:n_plain], t_len[:n_plain], d_lo[:n_plain], W,
        Lq)
    same = (torch.equal(ops_k[:n_plain], ops_p)
            and torch.equal(n_k[:n_plain], n_p))
    ops_h, n_h = ops_k.cpu().numpy(), n_k.cpu().numpy()
    # a walk that stops inside the matrix has no host CIGAR to equal
    host = all(
        talign.ops_to_cigar(ops_h[b], int(n_h[b]))
        == talign.traceback(dirs[b].cpu().numpy(), int(q_len[b]),
                            int(t_len[b]), int(d_lo[b]))
        for b in range(min(8, n_plain)))
    out = ""
    for B in batches:
        sub = [a[:B].contiguous() for a in (dirs, q_len, t_len, d_lo)]
        ms = time_ms(lambda: align_cuda.traceback_cuda(*sub, W, Lq), 5)
        worst = max(walk_decisions(ops_h[b], int(n_h[b])) for b in range(B))
        out += (f" B{B}_ms={ms:.4f} B{B}_decisions={worst} "
                f"B{B}_floor_ms={worst * load_ns * 1e-6:.5f}")
    print(f"[b4] {name} Lq={Lq} W={W} equals_plain={same} "
          f"equals_host_traceback={host} "
          f"mean_ops={float(n_k.float().mean()):.0f}{out}", flush=True)
    return same and host


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also time the wide score-only bands")
    ap.add_argument("--b4-only", action="store_true",
                    help="skip B1's sweep of cells per thread")
    ap.add_argument("--sass", metavar="FILE",
                    help="write the kernels' machine code (cuobjdump -sass) "
                         "to FILE")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("kernel_sweep: no CUDA device is available", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip(), flush=True)
    _build.load_library()
    print(f"[build] nvcc {_build.build_seconds} s")
    for line in _build.build_log.splitlines():
        if any(w in line for w in ("registers", "spill", "Compiling",
                                   "error", "warning")):
            print(f"[build] {line.strip()}", flush=True)

    if args.sass:
        nvcc = _build._nvcc()
        dump = subprocess.run(
            [nvcc.replace("nvcc", "cuobjdump"), "-sass",
             str(_build.library_path)], capture_output=True, text=True)
        with open(args.sass, "w") as f:
            f.write(dump.stdout + dump.stderr)

    load_cycles, load_ns = smem_load_to_use()
    print(f"[chase] shared-memory load-to-use: {load_cycles:.2f} cycles, "
          f"{load_ns:.3f} ns", flush=True)

    rng = np.random.default_rng(0)
    shapes = [
        # name, Lq, W, shortest query, scoring, store_dirs, cells to try,
        # pair maker
        ("olc_polish", 16384, 512, 12000, OLC_SCORING, True, (4, 8, 16),
         dp_pairs),
        ("aligner_gap_fill", 1024, 128, 300, ALIGNER_SCORING, True,
         (4, 8), dp_pairs),
        ("leading_insertion", 1024, 128, 300, OLC_SCORING, True, (),
         lambda *a, **k: dp_pairs(*a, leading_ins=True, **k)),
        ("noisy_clr", 16384, 512, 12000, OLC_SCORING, True, (),
         lambda *a, **k: noisy_pairs(*a)),
        ("band_2048", 4096, 2048, 3000, OLC_SCORING, True, (4, 8, 16),
         dp_pairs),
    ]
    if args.full:
        shapes += [
            ("edit_sim_w8192", 16384, 8192, 12000, UNIT_COSTS, False, (16,),
             dp_pairs),
            ("edit_sim_w32768", 4096, 32768, 2000, UNIT_COSTS, False, (0,),
             dp_pairs),
        ]
    for name, Lq, W, q_lo, scoring, store, cells, make in shapes:
        big = [torch.from_numpy(a).to(dev)
               for a in make(rng, 128 if W <= 2048 else 4, Lq, W, q_lo,
                             edge=True)]
        small = [a[:4].contiguous() for a in big]
        if not args.b4_only:
            s_p, d_p = talign.banded_align_batch(*small, band=W,
                                                 store_dirs=store, **scoring)
        for C in () if args.b4_only else cells:
            s_k, d_k = align_cuda.banded_align_batch_cuda(
                *small, band=W, store_dirs=store, cells_per_thread=C,
                **scoring)
            torch.cuda.synchronize()
            same = torch.equal(s_k, s_p) and (not store
                                              or torch.equal(d_k, d_p))
            times = {}
            for B in (1, 2, len(big[0])):
                sub = [a[:B].contiguous() for a in big]
                times[B] = time_ms(
                    lambda: align_cuda.banded_align_batch_cuda(
                        *sub, band=W, store_dirs=store, cells_per_thread=C,
                        **scoring), 3)
            print(f"[b1] {name} Lq={Lq} W={W} cells={C} byte_exact={same} "
                  + " ".join(f"B{B}_ms={ms:.3f}" for B, ms in times.items()),
                  flush=True)
            if not same:
                return 1
        if not store:
            continue
        # B4 on these direction bytes (from pair 3 on: pairs 0 to 2 are the
        # edge pairs, which would make a lone pair's time that of a stub)
        _, dirs = align_cuda.banded_align_batch_cuda(*big, band=W, **scoring)
        order = list(range(3, len(dirs))) + [0, 1, 2]
        dirs, q_len, t_len, d_lo = (a[order].contiguous() for a in
                                    (dirs, big[1], big[3], big[4]))
        if not b4_case(name, dirs, q_len, t_len, d_lo, W, Lq, 4,
                       (1, 2, len(dirs)), load_ns):
            return 1
        del dirs
    for name, dirs, q_len, t_len, d_lo, W, M in walk_cases(with_stop=True):
        case = [torch.from_numpy(a).to(dev) for a in (dirs, q_len, t_len,
                                                      d_lo)]
        ops_k, n_k = align_cuda.traceback_cuda(*case, W, M)
        ops_p, n_p = talign.traceback_device(*case, W, M)
        torch.cuda.synchronize()
        same = torch.equal(ops_k, ops_p) and torch.equal(n_k, n_p)
        ms = time_ms(lambda: align_cuda.traceback_cuda(*case, W, M), 5)
        print(f"[b4] walk {name} M={M} W={W} equals_plain={same} "
              f"n={n_k.tolist()} ms={ms:.4f}", flush=True)
        if not same:
            return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
