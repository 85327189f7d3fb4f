"""Times kernel B1's launch configurations and kernels B4 and B2 on one
NVIDIA GPU.

    python -m focalsv_tpu_torch.testing.kernel_sweep [--full] [--b4-only]
    python -m focalsv_tpu_torch.testing.kernel_sweep --b2-only [--against DIR]
        [--phases]

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
sweep.

``--b2-only`` times B2 alone, at the four delta chunks of chip_smoke.py's
phase 4 (testing/region_cases.py::pipeline_delta_chunks) and on every case
of testing/region_cases.py: the kernel with the cluster size it chooses and
with each cluster size it can take, held against its plain version byte for
byte.  ``--against DIR`` builds DIR's focalsv_tpu_torch/csrc/region_step.cu
(another checkout of the repository, whose entry takes no cluster argument)
and times it in turns with this one (this, other, other, this), the two held
against each other byte for byte.  ``--phases`` adds B2's time by phase at
those chunks, from a build that stamps the card's clock at each boundary.  Needs a CUDA device; exits 1 without one.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import subprocess
import sys
from pathlib import Path

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


def other_region_step(tree: str):
    """B2 of another checkout, built from its csrc/region_step.cu, as a
    function of a chunk buffer and the step's arguments (that entry takes
    no cluster argument)."""
    from focalsv_tpu_torch.parallel.wire import flat_layout, flat_layout_rle
    src = Path(tree) / "focalsv_tpu_torch" / "csrc" / "region_step.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"libfocalsv_b2_against_{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not so.exists():
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared",
                              "-o", str(so), str(src)], capture_output=True,
                             text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[b2] against: {line.strip()}", flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    fn = ctypes.CDLL(str(so)).focalsv_region_step
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 18 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def step(buf, *, G, R, L, Ds, Dd, Drle, max_sites, mec_iters,
             min_site_depth, min_minor_count, lo_num, lo_den, hi_num, hi_den,
             purify_window, purify_min_pairs, purify_num, purify_den):
        S = max_sites
        lay = flat_layout_rle(R, S, Drle) if Drle else flat_layout(R, L, S)
        out = torch.empty((G, lay["__total__"][1]), dtype=torch.uint8,
                          device=buf.device)
        scratch = torch.empty(G * 3 * S * -(-R // 32), dtype=torch.int32,
                              device=buf.device)
        err = fn(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(), G, R, L,
                 Ds, Dd, Drle, S, mec_iters, min_site_depth, min_minor_count,
                 lo_num, lo_den, hi_num, hi_den, purify_window,
                 purify_min_pairs, purify_num, purify_den,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the other B2 failed: CUDA error {err}")
        return out
    return step


PHASES = ("bin", "sites", "middle", "carries", "votes", "runs")


def b2_phases() -> None:
    """B2 built with its phase stamps (-DFOCALSV_B2_PHASES; each CTA's
    thread 0 reads the card's clock at the phase boundaries): at each of
    phase 4's delta chunks, the median over the chunk's CTAs of each phase's
    time in us (the leader's alone for the middle section: compaction,
    alleles, purification, MEC, reads and sites; a CTA past the leader
    waits through it in `carries`), and the chunk's span from the first
    stamp to the last."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.parallel.wire import flat_layout, flat_layout_rle
    from focalsv_tpu_torch.testing import region_cases
    src = _build.CSRC / "region_step.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    so = _build.BUILD_DIR / f"libfocalsv_b2_phases_{tag}.so"
    if not so.exists():
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                        "-DFOCALSV_B2_PHASES", "-shared", "-o", str(so),
                        str(src)], check=True, capture_output=True)
    fn = ctypes.CDLL(str(so)).focalsv_region_step
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 19 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    for key, buf, args in region_cases.pipeline_delta_chunks():
        kw = {**rs.STEP_DEFAULTS, **args}
        G, R, L, S, D = (kw[k] for k in ("G", "R", "L", "max_sites", "Drle"))
        shape = {k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")}
        nc = region_cuda.launch_plan(**shape, S=S)["cluster"]
        dev = torch.from_numpy(buf).to("cuda")
        lay = flat_layout_rle(R, S, D) if D else flat_layout(R, L, S)
        out = torch.empty((G, lay["__total__"][1]), dtype=torch.uint8,
                          device="cuda")
        words = region_cuda.scratch_words(G, R, kw["Ds"], kw["Dd"], D, S)
        scratch = torch.zeros(words + G * region_cuda.MAX_CLUSTER * 16,
                              dtype=torch.int32, device="cuda")
        for _ in range(3):
            err = fn(dev.data_ptr(), out.data_ptr(), scratch.data_ptr(), G,
                     R, L, kw["Ds"], kw["Dd"], D, S, kw["mec_iters"],
                     kw["min_site_depth"], kw["min_minor_count"],
                     kw["lo_num"], kw["lo_den"], kw["hi_num"], kw["hi_den"],
                     kw["purify_window"], kw["purify_min_pairs"],
                     kw["purify_num"], kw["purify_den"], 0,
                     torch.cuda.current_stream().cuda_stream)
            if err != 0:
                raise RuntimeError(f"B2 with its phase stamps failed: {err}")
        torch.cuda.synchronize()
        same = torch.equal(out, rs.phase_consensus_delta_flat_plain(dev,
                                                                    **kw))
        t = scratch[words:].view(torch.int64)[:G * nc * 8].reshape(
            G * nc, 8)[:, :7].cpu().numpy().astype(np.float64)
        d = np.diff(t, axis=1) / 1e3
        leader = np.arange(G * nc) % nc == 0
        med = [float(np.median(d[leader if i == 2 else slice(None), i]))
               for i in range(len(PHASES))]
        span = (t[:, 6].max() - t[:, 0].min()) / 1e3
        print(f"[b2 phases] {key} G={G} cluster={nc} equals_plain={same} "
              + " ".join(f"{n}_us={v:.2f}" for n, v in zip(PHASES, med))
              + f" span_us={span:.2f}", flush=True)


def b2_sweep(against: str | None) -> bool:
    """B2 at phase 4's delta chunks and on every region case: its time at
    the cluster size it chooses and at every size it can take, against its
    plain version and (with ``against``) another checkout's B2, in turns."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.testing import region_cases
    other = other_region_step(against) if against else None
    cases = [(str(key), buf, args)
             for key, buf, args in region_cases.pipeline_delta_chunks()]
    cases += [(name, *region_cases.build(name))
              for name in sorted(region_cases.CASES)]
    ok = True
    for name, buf, args in cases:
        kw = {**rs.STEP_DEFAULTS, **args}
        dev = torch.from_numpy(buf).to("cuda")
        shape = {k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")}
        auto = region_cuda.launch_plan(**shape, S=kw["max_sites"])

        def kernel(cluster=0):
            region_cuda.CLUSTER = cluster
            try:
                return rs.phase_consensus_delta_flat(dev, **kw)
            finally:
                region_cuda.CLUSTER = 0

        want = rs.phase_consensus_delta_flat_plain(dev, **kw)
        same = torch.equal(kernel(), want)
        line = (f"[b2] {name} G={kw['G']} R={kw['R']} L={kw['L']} "
                f"Drle={kw['Drle']} cluster={auto['cluster']} "
                f"smem={auto['smem_bytes']} "
                f"planes_in_smem={auto['planes_in_smem']} "
                f"events_in_smem={auto['events_in_smem']}")
        if other is not None:
            same = same and torch.equal(other(dev, **kw), want)
            k1, o1 = time_ms(kernel, 10), time_ms(lambda: other(dev, **kw),
                                                  10)
            o2, k2 = time_ms(lambda: other(dev, **kw), 10), time_ms(kernel,
                                                                    10)
            line += (f" ms={(k1 + k2) / 2:.4f} ({k1:.4f},{k2:.4f}) "
                     f"against_ms={(o1 + o2) / 2:.4f} ({o1:.4f},{o2:.4f})")
        else:
            line += f" ms={time_ms(kernel, 10):.4f}"
        for nc in (1, 2, 4):
            plan = region_cuda.launch_plan(**shape, S=kw["max_sites"],
                                           cluster=nc)
            if plan["cluster"] != nc:
                continue
            same = same and torch.equal(kernel(nc), want)
            line += f" cluster{nc}_ms={time_ms(lambda: kernel(nc), 10):.4f}"
        print(f"{line} equals_plain={same}", flush=True)
        ok = ok and same
    return ok


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="also time the wide score-only bands")
    ap.add_argument("--b4-only", action="store_true",
                    help="skip B1's sweep of cells per thread")
    ap.add_argument("--b2-only", action="store_true",
                    help="time B2 alone (phase 4's delta chunks and the "
                         "region cases)")
    ap.add_argument("--phases", action="store_true",
                    help="with --b2-only: also time B2's phases at phase "
                         "4's delta chunks (a build with phase stamps)")
    ap.add_argument("--against", metavar="DIR",
                    help="with --b2-only: also time the B2 of the checkout "
                         "at DIR, in turns with this one")
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

    if args.b2_only:
        ok = b2_sweep(args.against)
        if args.phases:
            b2_phases()
        return 0 if ok else 1

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
