"""Times kernel B1's launch configurations and kernels B4, B2 and B3 on
one NVIDIA GPU.

    python -m focalsv_tpu_torch.testing.kernel_sweep [--full] [--b4-only]
    python -m focalsv_tpu_torch.testing.kernel_sweep --b2-only [--against DIR]
        [--phases]
    python -m focalsv_tpu_torch.testing.kernel_sweep --b3-only [--against DIR]
        [--phases]
    python -m focalsv_tpu_torch.testing.kernel_sweep --b6-only [--against DIR]

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
(another checkout of the repository, whose entry may or may not take a
cluster argument) and this checkout's, and calls both through the same bare
entry (no wrapper: its checks and launch plan cost host time at every
launch), timed in turns (this, other, other, this) and held against each
other byte for byte.  ``--phases`` adds B2's time by phase at
those chunks, from a build that stamps the card's clock at each boundary
(-DFOCALSV_PHASES).

``--b3-only`` does the same for B3 at chip_smoke.py's phase 6b chunks (8
noisy regions, one or two a chunk; testing/region_cases.py::
pipeline_rows_chunks), at a full chunk of the smallest and of the largest
noisy bucket (full_rows_chunk) and on every dense case, with each cluster
size of region_cuda.ROWS_CLUSTERS; ``--phases`` adds its time by phase at
the noisy chunks, over the CTAs of their real regions: the reads binned by
tile, the site sweep, the leader (sites, alleles, phasing), the reads'
classes and the vote sweep.  Both flags together run both.  Needs a CUDA
device; exits 1 without one.

``--b6-only`` times B6 (the pair-HMM forward pass) on batches shaped as the
realignment's calls (testing/pairhmm_cases.py::path_like: reads of 21 bases
against windows of 25, padded to 29) at 1, 528 and 800 reads (800: where the
wrapper goes from one pair a warp to two) and at the sizes of the smallest,
the median and the largest of chip_smoke.py phase 9c's calls (278, 967 and
2,605 reads), and at phase 9a's synthetic shapes, with 1, 2, 4 and 8 (read,
window) pairs a warp, each held to the plain version (terms byte for byte),
with the lane-steps a pair that B6 counts at each; then one pair a warp
against two from 600 to 1,100 reads (B6_CUT_SCAN).  ``--against DIR`` runs
B6 of the checkout at DIR and of this one, each through its own wrapper
(pairhmm.kernel_inputs, then pairhmm_cuda.pairhmm_cuda) in a process of its
own, on the same inputs in turns (this, other, other, this), held against
each other: terms byte for byte, results within 1e-5.  Then each checkout's
entry from numpy (site_allele_loglik: copies, launch, checks) at the
path-shaped sizes by the host clock, in the same turns; and run_target_mode
with use_pairhmm=True on chip_smoke.py's 32 HiFi regions (its simulation and
writer) in each checkout (regions/s and finish thread-seconds), in turns.

Every time here is taken with the calls queued behind a sleep of the
stream (time_ms), so it is the card's time alone; chip_smoke.py's ``ms``
is taken with the calls issued back to back, and reports the queued time
beside it as ``queued_ms``.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import json
import os
import shutil
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
    """Mean milliseconds of fn() over reps calls on the card (CUDA events),
    queued behind a sleep of the stream so that the card runs them back to
    back: the card's time, not the host's time to issue a call."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


# a lone read, a warp a scheduler (528), the wrapper's cut from one pair a
# warp to two (800), and the smallest, median and largest of chip_smoke.py
# phase 9c's calls
B6_PATH_SIZES = (1, 278, 528, 800, 967, 2605)
B6_PAIRS_A_WARP = (1, 2, 4, 8)
# batches of the path's shape around the wrapper's cut from one pair a warp
# to two (pairhmm_cuda.PAIRS_BY_BATCH)
B6_CUT_SCAN = tuple(range(600, 1101, 50))

# times B6 through a checkout's own wrapper (pairhmm.kernel_inputs, then
# pairhmm_cuda.pairhmm_cuda: the entries that this checkout and the one
# before B6's redesign share) on the card: argv is an output .npz, then the
# cases' .npz files; writes each case's results and terms to the output and
# prints {case: ms a launch, queued behind a sleep of the stream} as JSON
KERNEL_TIMING = """
import json, os, sys
import numpy as np, torch
from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
dev = torch.device("cuda")


def queued_ms(fn, reps=20):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(20_000_000)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


times, results = {}, {}
for path in sys.argv[2:]:
    name = os.path.basename(path)[:-4]
    z = np.load(path)
    haps = [(z[h], z[h + "_lens"], z[h].shape[1]) for h in ("ref", "alt")]
    args = pairhmm.kernel_inputs(z["reads"], z["read_lens"], haps,
                                 z["quals"] if "quals" in z else None,
                                 z["reads"].shape[1], dev)
    out, terms = pairhmm_cuda.pairhmm_cuda(*args, want_terms=True)
    results[name + "/out"] = out.cpu().numpy()
    for h, t in enumerate(terms):
        results[f"{name}/terms{h}"] = t.cpu().numpy()
    times[name] = queued_ms(lambda: pairhmm_cuda.pairhmm_cuda(*args))
np.savez(sys.argv[1], **results)
print(json.dumps(times))
"""

# times site_allele_loglik (B6's entry from numpy) in a checkout: argv is
# the inputs' .npz files; prints {B: host ms a call} as JSON
ENTRY_TIMING = """
import json, sys, time
import numpy as np, torch
from focalsv_tpu_torch.ops import pairhmm
dev = torch.device("cuda")
times = {}
for path in sys.argv[1:]:
    z = np.load(path)
    args = (z["reads"], z["read_lens"], z["ref"], z["ref_lens"], z["alt"],
            z["alt_lens"], z["quals"])
    for _ in range(5):
        pairhmm.site_allele_loglik(*args, device=dev)
    t0 = time.perf_counter()
    for _ in range(50):
        pairhmm.site_allele_loglik(*args, device=dev)
    times[len(z["read_lens"])] = (time.perf_counter() - t0) * 1e3 / 50
print(json.dumps(times))
"""


def in_checkout(tree: str, script: str, *argv: str) -> str:
    """The standard output of ``script`` run by Python in the checkout at
    ``tree`` (its package first on the path), a process of its own."""
    env = dict(os.environ, PYTHONPATH=str(Path(tree).resolve()))
    res = subprocess.run([sys.executable, "-c", script, *argv], cwd=tree,
                         env=env, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"timing failed in {tree}:\n{res.stderr[-3000:]}")
    return res.stdout


def b6_case_file(name: str, case: dict) -> str:
    """``case`` (two windows, the default gap costs) as an .npz file that
    KERNEL_TIMING and ENTRY_TIMING read."""
    (ref, rl), (alt, al) = case["haps"]
    assert case["reads"].shape[1] == case["max_read"]
    assert case["gaps"] == dict(gap_open=1e-3, gap_extend=0.1)
    path = _build.BUILD_DIR / "b6_cases" / f"{name}.npz"
    path.parent.mkdir(parents=True, exist_ok=True)
    extra = {} if case["quals"] is None else dict(quals=case["quals"])
    np.savez(path, reads=case["reads"], read_lens=case["read_lens"], ref=ref,
             ref_lens=rl, alt=alt, alt_lens=al, **extra)
    return str(path)


def b6_against(against: str, shapes: list) -> bool:
    """B6 of this checkout and of the one at ``against``, each through its
    own wrapper in a process of its own (KERNEL_TIMING), in turns (this,
    other, other, this) on ``shapes``: ms a launch queued, and the other's
    results held to this one's (terms byte for byte, results within 1e-5,
    -inf at the same places)."""
    from focalsv_tpu_torch.testing import pairhmm_cases
    files = [b6_case_file(name, case) for name, case in shapes]
    here = str(_build.PKG.parent)
    outs = [str(_build.BUILD_DIR / "b6_cases" / f"turn{i}.npz")
            for i in range(4)]
    runs = [json.loads(in_checkout(tree, KERNEL_TIMING, out, *files)
                       .strip().splitlines()[-1])
            for tree, out in zip([here, against, against, here], outs)]
    mine, other = np.load(outs[0]), np.load(outs[1])
    ok = True
    for name, case in shapes:
        n = len(case["haps"])
        d = pairhmm_cases.differences(
            (other[f"{name}/out"], [other[f"{name}/terms{h}"]
                                    for h in range(n)]),
            (mine[f"{name}/out"], [mine[f"{name}/terms{h}"]
                                   for h in range(n)]))
        same = d["terms_bytes_equal"] and d["same_inf"] and \
            d["out_err"] <= 1e-5
        k1, o1, o2, k2 = (r[name] for r in runs)
        print(f"[b6-against] {name} in turns, each checkout's own wrapper: "
              f"this_ms={(k1 + k2) / 2:.4f} ({k1:.4f},{k2:.4f}) "
              f"against_ms={(o1 + o2) / 2:.4f} ({o1:.4f},{o2:.4f}) "
              f"this_over_against={(k1 + k2) / (o1 + o2):.3f} "
              f"equals_against={same} (max_abs_err {d['out_err']:.3g})",
              flush=True)
        ok = ok and same
    return ok


def b6_entry_sweep(against: str | None) -> None:
    """B6's entry from numpy at the path-shaped sizes, this checkout's and
    (with ``against``) the other's, in turns (this, other, other, this)."""
    from focalsv_tpu_torch.testing import pairhmm_cases
    files = [b6_case_file(f"path_like_B{B}", pairhmm_cases.path_like(11, B))
             for B in B6_PATH_SIZES]
    here = str(_build.PKG.parent)
    turns = [here] + ([against, against] if against else []) + [here]
    runs = [json.loads(in_checkout(tree, ENTRY_TIMING, *files)
                       .strip().splitlines()[-1]) for tree in turns]
    for B in B6_PATH_SIZES:
        k = str(B)
        line = (f"[b6-entry] path_like_B{B} site_allele_loglik host ms a "
                f"call: this {runs[0][k]:.4f},{runs[-1][k]:.4f}")
        if against:
            ratio = ((runs[0][k] + runs[-1][k])
                     / (runs[1][k] + runs[2][k]))
            line += (f" against {runs[1][k]:.4f},{runs[2][k]:.4f} "
                     f"this_over_against={ratio:.3f}")
        print(line, flush=True)


# run_target_mode with use_pairhmm=True in a checkout, once to warm up and
# twice timed: argv bam, fasta, bed, out; prints [{rps, finish_s}] as JSON
TARGET_TIMING = """
import dataclasses, json, sys, time
from focalsv_tpu_torch.config import preset
from focalsv_tpu_torch.pipeline import main
bam, fa, bed, out = sys.argv[1:5]
n = sum(1 for _ in open(bed))
cfg = preset("HIFI")
cfg = cfg.replace(
    execution=dataclasses.replace(cfg.execution, mode="device"),
    phasing=dataclasses.replace(cfg.phasing, use_pairhmm=True))
main.run_target_mode(bam, fa, out + "_warm", cfg, target_bed=bed,
                     num_workers=8)
runs = []
for k in range(2):
    t0 = time.perf_counter()
    main.run_target_mode(bam, fa, f"{out}{k}", cfg, target_bed=bed,
                         num_workers=8)
    secs = time.perf_counter() - t0
    with open(f"{out}{k}/chr21/log/device_stats.json") as f:
        finish = json.load(f)["finish_s"]
    runs.append(dict(rps=n / secs, finish_s=finish))
print(json.dumps(runs))
"""


def b6_target_mode_sweep(against: str) -> None:
    """run_target_mode with use_pairhmm=True on chip_smoke.py's 32 HiFi
    regions (its own simulation and writer), this checkout and the other,
    each in processes of its own, in turns: regions/s and finish
    thread-seconds."""
    import importlib.util
    here = str(_build.PKG.parent)
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(here) / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    work = _build.BUILD_DIR / "b6_target_mode"
    shutil.rmtree(work, ignore_errors=True)
    work.mkdir(parents=True)
    bam, fasta, beds = smoke.write_chromosome(
        smoke._simulate(smoke.N_REGIONS), str(work))
    bed = beds[smoke.N_REGIONS]
    for i, tree in enumerate([here, against, against, here]):
        runs = json.loads(in_checkout(
            tree, TARGET_TIMING, bam, fasta, bed, str(work / f"out{i}_"))
            .strip().splitlines()[-1])
        print(f"[b6-target] {'this' if tree == here else 'against'} "
              f"use_pairhmm=True {smoke.N_REGIONS} HiFi regions: regions/s "
              + ", ".join(f"{r['rps']:.3f}" for r in runs)
              + " finish_s " + ", ".join(f"{r['finish_s']:.2f}" for r in runs),
              flush=True)


def b6_sweep(against: str | None) -> bool:
    """B6 on path-shaped batches and phase 9a's shapes: against its plain
    version, with each pairs-a-warp setting (ms queued, and the lane-steps
    a pair that B6 counts), and (with ``against``) against another
    checkout's B6 in turns (b6_against)."""
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    from focalsv_tpu_torch.testing import pairhmm_cases
    dev = torch.device("cuda")
    shapes = [(f"path_like_B{B}", pairhmm_cases.path_like(11, B))
              for B in B6_PATH_SIZES]
    shapes += [(name, build(9))
               for name, build in pairhmm_cases.CARD_SHAPES.items()]
    ok = True
    for name, case in shapes:
        B = len(case["read_lens"])
        args = pairhmm.kernel_inputs(
            case["reads"], case["read_lens"],
            [(hap, hl, hap.shape[1]) for hap, hl in case["haps"]],
            case["quals"], case["max_read"], dev, **case["gaps"])
        want = pairhmm_cases.plain(case, dev)
        out, terms = pairhmm_cuda.pairhmm_cuda(*args, want_terms=True)
        got = (out.cpu().numpy(), [t.cpu().numpy() for t in terms])
        d = pairhmm_cases.differences(got, want)
        same = d["terms_bytes_equal"] and d["same_inf"] and \
            d["out_err"] <= 1e-5
        K0 = pairhmm_cuda.choose_pairs_per_warp(B)
        pairs = B * len(case["haps"])

        def this(K=None, counter=None):
            return pairhmm_cuda.pairhmm_cuda(*args, pairs_per_warp=K,
                                             lane_steps=counter)

        steps = {}
        for K in B6_PAIRS_A_WARP:
            counter = torch.zeros(1, dtype=torch.int64, device=dev)
            this(K, counter)
            steps[K] = int(counter.item()) / pairs
        by_K = {K: time_ms(lambda: this(K), 20) for K in B6_PAIRS_A_WARP}
        print(f"[b6] {name} B={B} M={case['max_read']} "
              f"N={[hap.shape[1] for hap, _ in case['haps']]} "
              f"equals_plain={same} (max_abs_err {d['out_err']:.3g}) "
              f"pairs_a_warp={K0} lane_steps_a_pair (counted) "
              + " ".join(f"K{K}={v:.1f}" for K, v in steps.items())
              + " ms_by_pairs_a_warp "
              + " ".join(f"K{K}={v:.4f}" for K, v in by_K.items()),
              flush=True)
        ok = ok and same
    b6_cut_scan()
    if against:
        ok = b6_against(against, shapes) and ok
    return ok


def b6_cut_scan() -> None:
    """B6 at one and at two pairs a warp on batches of the path's shape
    from 600 to 1,100 reads (B6_CUT_SCAN), queued, in turns: where the
    wrapper's cut from one to two (pairhmm_cuda.PAIRS_BY_BATCH) belongs."""
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    from focalsv_tpu_torch.testing import pairhmm_cases
    dev = torch.device("cuda")
    for B in B6_CUT_SCAN:
        case = pairhmm_cases.path_like(11, B)
        args = pairhmm.kernel_inputs(
            case["reads"], case["read_lens"],
            [(hap, hl, hap.shape[1]) for hap, hl in case["haps"]],
            case["quals"], case["max_read"], dev, **case["gaps"])

        def run(K):
            return pairhmm_cuda.pairhmm_cuda(*args, pairs_per_warp=K)

        a1, b1 = time_ms(lambda: run(1), 20), time_ms(lambda: run(2), 20)
        b2, a2 = time_ms(lambda: run(2), 20), time_ms(lambda: run(1), 20)
        one, two = (a1 + a2) / 2, (b1 + b2) / 2
        print(f"[b6-cut] path_like_B{B} ms queued: 1 pair a warp {one:.4f} "
              f"({a1:.4f},{a2:.4f}), 2 pairs {two:.4f} ({b1:.4f},{b2:.4f}); "
              f"two_over_one={two / one:.3f}; the wrapper takes "
              f"{pairhmm_cuda.choose_pairs_per_warp(B)}", flush=True)


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


def tree_library(tree: str, phases: bool = False) -> ctypes.CDLL:
    """A checkout's csrc/region_step.cu (this one or another) built into a
    library of its own (with its phase stamps where ``phases``: each CTA's
    thread 0 reads the card's clock at the phase boundaries), ptxas's
    registers and spills printed at the first build."""
    src = Path(tree) / "focalsv_tpu_torch" / "csrc" / "region_step.cu"
    tag = hashlib.sha256(src.read_bytes()).hexdigest()[:16]
    kind = "phases" if phases else "bare"
    so = _build.BUILD_DIR / f"libfocalsv_region_{kind}_{tag}.so"
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    if not so.exists():
        res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS,
                              *(["-DFOCALSV_PHASES"] if phases else []),
                              "-shared", "-o", str(so), str(src)],
                             capture_output=True, text=True)
        for line in (res.stdout + res.stderr).splitlines():
            if "registers" in line or "spill" in line:
                print(f"[build] {tree} ({kind}): {line.strip()}", flush=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{res.stderr}")
    return ctypes.CDLL(str(so))


def other_region_step(tree: str, phases: bool = False):
    """B2 of a checkout (this one or another), built from its
    csrc/region_step.cu, as a function of a chunk buffer and the step's
    arguments, with no wrapper around the entry.  An entry that
    takes a cluster argument gets 0, the kernel's own choice, and the
    scratch of this checkout's scratch_words (with room for the phase
    stamps); one without it, the older layout, its planes alone."""
    from focalsv_tpu_torch.ops.region_cuda import MAX_CLUSTER, scratch_words
    from focalsv_tpu_torch.parallel.wire import flat_layout, flat_layout_rle
    src = Path(tree) / "focalsv_tpu_torch" / "csrc" / "region_step.cu"
    with_cluster = "int cluster, void* stream" in src.read_text()
    fn = tree_library(tree, phases).focalsv_region_step
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * (
        19 if with_cluster else 18) + [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def step(buf, *, G, R, L, Ds, Dd, Drle, max_sites, mec_iters,
             min_site_depth, min_minor_count, lo_num, lo_den, hi_num, hi_den,
             purify_window, purify_min_pairs, purify_num, purify_den,
             scratch=None):
        S = max_sites
        lay = flat_layout_rle(R, S, Drle) if Drle else flat_layout(R, L, S)
        out = torch.empty((G, lay["__total__"][1]), dtype=torch.uint8,
                          device=buf.device)
        words = (scratch_words(G, R, Ds, Dd, Drle, S) if with_cluster
                 else G * 3 * S * -(-R // 32))
        if scratch is None:
            scratch = torch.empty(words + 2 + G * MAX_CLUSTER * 16,
                                  dtype=torch.int32, device=buf.device)
        err = fn(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(), G, R, L,
                 Ds, Dd, Drle, S, mec_iters, min_site_depth, min_minor_count,
                 lo_num, lo_den, hi_num, hi_den, purify_window,
                 purify_min_pairs, purify_num, purify_den,
                 *((0,) if with_cluster else ()),
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the B2 of {tree} failed: CUDA error {err}")
        return out
    return step


def other_region_rows(tree: str, phases: bool = False):
    """B3 of a checkout, as other_region_step gives B2: the bare entry with
    the scratch of this checkout's rows_scratch_words (a superset of what
    an older B3 takes) and room for the phase stamps."""
    from focalsv_tpu_torch.ops.region_cuda import (KNOBS, MAX_ROWS_CLUSTER,
                                                   rows_scratch_words)
    from focalsv_tpu_torch.parallel.wire import flat_layout
    fn = tree_library(tree, phases).focalsv_region_rows
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 17 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def step(buf, *, G, R, L, W, max_sites, scratch=None, **knobs):
        S = max_sites
        out = torch.empty((G, flat_layout(R, L, S)["__total__"][1]),
                          dtype=torch.uint8, device=buf.device)
        if scratch is None:
            scratch = torch.empty(rows_scratch_words(G, R, L, W, S) + 2
                                  + G * MAX_ROWS_CLUSTER * 16,
                                  dtype=torch.int32, device=buf.device)
        err = fn(buf.data_ptr(), out.data_ptr(), scratch.data_ptr(), G, R, L,
                 W, S, *(knobs[k] for k in KNOBS), 0,
                 torch.cuda.current_stream().cuda_stream)
        if err != 0:
            raise RuntimeError(f"the B3 of {tree} failed: CUDA error {err}")
        return out
    return step


HERE = str(Path(__file__).resolve().parents[2])


def phase_split(scratch, words: int, G: int, nc: int, names, real: int):
    """The medians over a chunk's CTAs of each phase's time in us, from the
    stamps past the first ``words`` words of the scratch (the leader's alone
    for the third phase, the leader's work while the others wait, and for
    the part of it before the phasing: the merged sites and the allele
    matrix); only the CTAs of the first ``real`` regions count.  Also the
    chunk's span from the first stamp to the last, in us."""
    off = (words + 1) // 2 * 2
    t = scratch[off:].view(torch.int64)[:G * nc * 8].reshape(
        G * nc, 8)[:, :7].cpu().numpy().astype(np.float64)
    d = np.diff(t, axis=1) / 1e3
    cta = np.arange(G * nc)
    mine = cta // nc < real
    leader = mine & (cta % nc == 0)
    med = [float(np.median(d[leader if i == 2 else mine, i]))
           for i in range(len(names))]
    span = (t[:, 6].max() - t[:, 0].min()) / 1e3
    # the leader's stamp 7, after its sites and allele matrix
    t7 = scratch[off:].view(torch.int64)[:G * nc * 8].reshape(
        G * nc, 8)[:, 7].cpu().numpy().astype(np.float64)
    alleles = float(np.median((t7 - t[:, 2])[leader])) / 1e3
    return " ".join(f"{n}_us={v:.2f}" for n, v in zip(names, med)) + (
        f" of_which_sites_and_alleles_us={alleles:.2f} span_us={span:.2f}")


PHASES = ("bin", "sites", "middle", "carries", "votes", "runs")
B3_PHASES = ("bin", "sites", "leader", "classes", "votes", "tail")


def b2_phases() -> None:
    """B2 built with its phase stamps at each of phase 4's delta chunks:
    the median over the chunk's CTAs of each phase's time in us (the
    leader's alone for the middle section: compaction, alleles,
    purification, MEC, reads and sites; a CTA past the leader waits through
    it in `carries`), and the chunk's span from the first stamp to the
    last."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.testing import region_cases
    step = other_region_step(HERE, phases=True)
    for key, buf, args in region_cases.pipeline_delta_chunks():
        kw = {**rs.STEP_DEFAULTS, **args}
        G, R, S, D = (kw[k] for k in ("G", "R", "max_sites", "Drle"))
        shape = {k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")}
        nc = region_cuda.launch_plan(**shape, S=S)["cluster"]
        dev = torch.from_numpy(buf).to("cuda")
        words = region_cuda.scratch_words(G, R, kw["Ds"], kw["Dd"], D, S)
        scratch = torch.zeros(words + 2 + G * region_cuda.MAX_CLUSTER * 16,
                              dtype=torch.int32, device="cuda")
        for _ in range(3):
            out = step(dev, **kw, scratch=scratch)
        torch.cuda.synchronize()
        same = torch.equal(out, rs.phase_consensus_delta_flat_plain(dev,
                                                                    **kw))
        print(f"[b2 phases] {key} G={G} cluster={nc} equals_plain={same} "
              + phase_split(scratch, words, G, nc, PHASES, G), flush=True)


def rows_chunks():
    """B3's chunks: phase 6b's noisy chunks, a full chunk of each of
    FULL_ROWS_KEYS, then every dense case: [(name, real regions or None,
    buf, args)]."""
    from focalsv_tpu_torch.testing import region_cases as rc
    out = [(f"noisy {key} real={n}", n, buf, args)
           for key, n, buf, args in rc.pipeline_rows_chunks()]
    for key in rc.FULL_ROWS_KEYS:
        key, n, buf, args = rc.full_rows_chunk(key)
        out.append((f"noisy full {key} real={n}", n, buf, args))
    return out + [(name, None, *rc.build_rows(name))
                  for name in sorted(rc.ROWS_CASES)]


def b3_phases(chunks) -> None:
    """B3 built with its phase stamps at the noisy chunks: the median over
    the CTAs of the chunk's real regions of each phase's time in us (bin:
    the reads binned by tile; sites: the site sweep; leader: the leader's
    sites, alleles and phasing, while the others wait; classes: the reads'
    classes; votes: the vote sweep and the tracks), and the span."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    step = other_region_rows(HERE, phases=True)
    for name, n_real, buf, args in chunks:
        if n_real is None:
            continue
        kw = {**rs.STEP_DEFAULTS, **args}
        G, R, L, W, S = (kw[k] for k in ("G", "R", "L", "W", "max_sites"))
        plan = region_cuda.rows_launch_plan(G, R, L, W, S)
        nc = plan["cluster"]
        dev = torch.from_numpy(buf).to("cuda")
        words = region_cuda.rows_scratch_words(G, R, L, W, S)
        scratch = torch.zeros(words + 2
                              + G * region_cuda.MAX_ROWS_CLUSTER * 16,
                              dtype=torch.int32, device="cuda")
        for _ in range(3):
            out = step(dev, **kw, scratch=scratch)
        torch.cuda.synchronize()
        same = torch.equal(out, rs.phase_consensus_rows_flat_plain(dev,
                                                                   **kw))
        print(f"[b3 phases] {name} G={G} cluster={nc} "
              f"smem={plan['smem_bytes']} registers={plan['registers']} "
              f"equals_plain={same} "
              + phase_split(scratch, words, G, nc, B3_PHASES, n_real),
              flush=True)


def b3_sweep(chunks, against: str | None) -> bool:
    """B3 at phase 6b's noisy chunks, at the full chunks and on every dense
    case: its time through the wrapper at the cluster size it chooses and
    at every size it can take, and (with ``against``) this checkout's and
    the other's bare entries in turns, each held to the plain version byte
    for byte."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    other = mine = None
    if against:
        other = other_region_rows(against)
        mine = other_region_rows(HERE)
    ok = True
    for name, _n, buf, args in chunks:
        kw = {**rs.STEP_DEFAULTS, **args}
        dev = torch.from_numpy(buf).to("cuda")
        shape = {k: kw[k] for k in ("G", "R", "L", "W")}
        auto = region_cuda.rows_launch_plan(**shape, S=kw["max_sites"])

        def kernel(cluster=0):
            region_cuda.CLUSTER = cluster
            try:
                return rs.phase_consensus_rows_flat(dev, **kw)
            finally:
                region_cuda.CLUSTER = 0

        want = rs.phase_consensus_rows_flat_plain(dev, **kw)
        same = torch.equal(kernel(), want)
        line = (f"[b3] {name} G={kw['G']} R={kw['R']} L={kw['L']} "
                f"W={kw['W']} " + " ".join(f"{k}={v}"
                                           for k, v in auto.items()))
        line += f" ms={time_ms(kernel, 10):.4f}"
        if other is not None:
            same = (same and torch.equal(other(dev, **kw), want)
                    and torch.equal(mine(dev, **kw), want))
            k1, o1 = (time_ms(lambda: mine(dev, **kw), 10),
                      time_ms(lambda: other(dev, **kw), 10))
            o2, k2 = (time_ms(lambda: other(dev, **kw), 10),
                      time_ms(lambda: mine(dev, **kw), 10))
            line += (f" bare_ms={(k1 + k2) / 2:.4f} ({k1:.4f},{k2:.4f}) "
                     f"against_ms={(o1 + o2) / 2:.4f} ({o1:.4f},{o2:.4f}) "
                     f"bare_over_against={(k1 + k2) / (o1 + o2):.3f}")
        for nc in region_cuda.ROWS_CLUSTERS:
            plan = region_cuda.rows_launch_plan(**shape, S=kw["max_sites"],
                                                cluster=nc)
            if plan["cluster"] != nc:
                continue
            same = same and torch.equal(kernel(nc), want)
            line += f" cluster{nc}_ms={time_ms(lambda: kernel(nc), 10):.4f}"
        print(f"{line} equals_plain={same}", flush=True)
        ok = ok and same
    return ok


def b2_sweep(against: str | None) -> bool:
    """B2 at phase 4's delta chunks and on every region case: its time at
    the cluster size it chooses and at every size it can take, against its
    plain version and (with ``against``) another checkout's B2, in turns."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.testing import region_cases
    other = mine = None
    if against:
        other = other_region_step(against)
        mine = other_region_step(HERE)
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
        line += f" ms={time_ms(kernel, 10):.4f}"
        if other is not None:
            same = (same and torch.equal(other(dev, **kw), want)
                    and torch.equal(mine(dev, **kw), want))
            k1, o1 = (time_ms(lambda: mine(dev, **kw), 10),
                      time_ms(lambda: other(dev, **kw), 10))
            o2, k2 = (time_ms(lambda: other(dev, **kw), 10),
                      time_ms(lambda: mine(dev, **kw), 10))
            line += (f" bare_ms={(k1 + k2) / 2:.4f} ({k1:.4f},{k2:.4f}) "
                     f"against_ms={(o1 + o2) / 2:.4f} ({o1:.4f},{o2:.4f}) "
                     f"bare_over_against={(k1 + k2) / (o1 + o2):.3f}")
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
    ap.add_argument("--b3-only", action="store_true",
                    help="time B3 alone (phase 6b's noisy chunks, the full "
                         "noisy chunks and the dense cases); with --b2-only "
                         "both")
    ap.add_argument("--b6-only", action="store_true",
                    help="time B6 alone (path-shaped batches and phase "
                         "9a's shapes, with each reads-a-warp setting)")
    ap.add_argument("--phases", action="store_true",
                    help="with --b2-only or --b3-only: also time the "
                         "kernel's phases at its chunks (a build with "
                         "phase stamps)")
    ap.add_argument("--against", metavar="DIR",
                    help="with --b2-only, --b3-only or --b6-only: also "
                         "time the kernel of the checkout at DIR, in turns "
                         "with this one")
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

    if args.b6_only:
        ok = b6_sweep(args.against)
        b6_entry_sweep(args.against)
        if args.against:
            b6_target_mode_sweep(args.against)
        return 0 if ok else 1

    if args.b2_only or args.b3_only:
        ok = True
        if args.b2_only:
            ok = b2_sweep(args.against)
            if args.phases:
                b2_phases()
        if args.b3_only:
            chunks = rows_chunks()
            if args.phases:
                b3_phases(chunks)
            ok = b3_sweep(chunks, args.against) and ok
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
