"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives focalsv_tpu_torch's main path, HiFi target mode in device execution,
on the card in phases, and exits non-zero at the first phase that fails:

1. device check (a CUDA card must be present) and the card's name and power
   limit as nvidia-smi reports them; the port's g++-built host libraries
   (native/*.cpp) must build and load;
2. build the kernels (csrc/*.cu: B1, the banded DP, B4, its traceback, B2
   and B3, the delta and the dense region step, and B6, the pair-HMM
   forward pass) with nvcc for sm_90a, one nvcc per source;
3. B1 against its plain PyTorch version, both on the card, byte for byte
   (tolerance 0), at the shapes of the main path: OLC read polish at
   batches of 128, 2 and 1 pairs, aligner gap fill, a leading-insertion
   case, and the score-only wide bands of edit_similarity on each of B1's
   paths (register kernel with a warp group per pair; wide-band kernel with
   shared-memory state and with global scratch); B4 against its plain
   version and against the host traceback's CIGAR, byte for byte, on B1's
   direction bytes of the polish, gap-fill and leading-insertion cases,
   each with a pair along the band's edge, an empty query and an empty
   target, on a noisy (CLR-like) walk whose runs are a few ops long, and
   on crafted direction bytes with gap runs longer than 32 ops and longer
   than a tile (testing/dp_cases.py::walk_cases);
4. the region step on the card against the same step on the CPU, byte for
   byte: HiFi 30x delta chunks at 15-100 kb and noisy CLR tiles made dense;
   at every delta chunk and every delta case of testing/region_cases.py, B2
   against its plain version on the card and on the CPU, byte for byte,
   and at every dense chunk and every dense case B3 likewise, both timed on
   the card in turns, with the kernel's launch (CTAs a region, shared
   memory) beside its time; two dispatches of each delta chunk split into
   pinning, copy in, kernel and copy out;
5. the golden HIFI fixture through the port's CLI in device mode, equal to
   tests/data/golden/hifi/expected.vcf byte for byte;
6. 32 simulated HiFi regions (15-100 kb at 30x) as BAM + FASTA + BED through
   run_target_mode: guided consensus on all of them and OLC assembly on 4,
   in device mode with every DP job sent to the device batch, and in host
   mode; each device VCF must equal its host VCF, and both kernels must
   have been launched; regions/s beside tile_build_s in each mode, and the
   BAM fetch of the 32 regions by one scan against a scan restarted at
   every index chunk (records equal in order);
6b. the noisy-read slice: 8 simulated regions cycling the same sizes at 30x
   with 10 % substitutions, 3 % insertions and 3 % deletions (seeds 3000+i),
   whose tiles all take the dense encoding, as BAM + FASTA + BED through
   run_target_mode under the ONT preset in device mode on the card, in host
   mode, and in device mode on the CPU (FOCALSV_TORCH_DEVICE=cpu, the plain
   version, in a subprocess): the card's VCF must equal the CPU's, B3 must
   launch once per chunk and no region may fall back to the host; the host
   VCF is compared and the result printed; B3 against its plain version at
   every noisy chunk, timed in turns, and at a chunk of the smallest and
   one of the largest bucket that 16 further noisy regions fill (seeds
   4000+i);
7. the same 32 regions as per-region BAM and reference files through the
   multi-process executor (pipeline/mp_exec.py) with 8 children, two passes
   on the warm executor: records equal to the in-process build_tile ->
   run_device_step -> process_region_device path, and no child initialised
   CUDA;
8. complex SVs: an inversion and a translocation as typed windows and a
   tandem duplication carried as an INS record through complexsv.cli in
   target mode, and call_dup_from_contigs on phase 6's OLC contigs, with
   the host DP shortcut off so that every gap fill of the aligner runs B1
   and B4; the VCFs must equal those of the same run on the CPU
   (FOCALSV_TORCH_DEVICE=cpu, in a subprocess), and both kernels must
   have been launched;
9. the pair-HMM realignment (use_pairhmm=True).  9a: B6's emission table
   against the plain version's elementwise emissions on the card, byte for
   byte; B6 against its plain version on the card, on every case of the
   CPU tests (testing/pairhmm_cases.py: reads past 128 bases, several
   pairs a warp, workspaces in device scratch) and at synthetic shapes
   (4,000 windows padded to 29 bases against the ref and the alt window,
   one launch; a stress size of 15,000; a wide one, reads of 48, windows
   of 64 and 40): the per-diagonal terms byte for byte, the results within
   1e-5 with -inf at the same places; timed in turns, with the launches
   and copies of a call of each (torch.profiler, and for B6's entry the
   wrappers' counts, which must give 3: copy in, B6, copy out).  9b: run_target_mode with use_pairhmm=True in
   device mode on the card, on phase 6's 32 HiFi regions and phase 6b's 8
   noisy ones, and on the CPU (FOCALSV_TORCH_DEVICE=cpu, the plain version,
   in a subprocess; the HiFi run on the first 8 regions, two of each size,
   which the card runs too): equal VCFs, B6 launched on each path and the
   plain version never called on the card; regions/s beside phase 6's
   guided run.  9c: B6 on the path's own traffic, the inputs that the
   realignment handed the kernel in 9b's HiFi run (one call a region,
   recorded in the run through the plain version): each call held to the
   plain version as in 9a and timed, also with 1, 2 and 4 pairs a warp
   beside the wrapper's choice, its entry held to 3 launches and copies;
   the region of median windows is the kernels line's headline (with the
   lane-steps a pair that B6 counts there), and the sum over the 32 calls
   is B6's card time a run;
10. evaluation.cli bench of phase 6's device VCF against the simulation's
   truth; prints F1;
11. the multi-device and multi-process path on a mesh of every card present
   (two logical shards of the one card when there is one): the sharded
   delta and rows region steps on every chunk of phase 4 against the
   unsharded step, byte for byte; sharded_banded_align and
   sharded_sv_candidate_step (B1 once per shard) against the unsharded B1
   and the plain version; run_target_mode through the mesh on phase 6's 32
   guided regions, equal to phase 6's device VCF; dryrun_multichip (B2's
   and B3's launches counted); two dist_worker ranks on phase 6's BED
   through the collective gather (NCCL with a card each when there are two
   cards, else gloo with both ranks on the one card) against the file merge
   of two in-process hosts; and NCCL
   at world size 1 (initialize, an all_gather of phase 6's record payload,
   shutdown);
12. auto mode through the port's CLI (--auto): bench_auto.py's genome of two
   10 Mb chromosomes at 30x HiFi with 9 SVs a Mb and a prior VCF
   (testing/auto_cases.py), and one 2 Mb CLR chromosome without a prior, in
   device mode on the card and in host mode: the native step-0 scan over
   every chromosome, region detection, the BED, then target mode over each
   chromosome and the merged VCF.  The BED, the merged VCF and each
   chromosome's VCF of the device run must equal the host run's byte for
   byte, the scan must have been the native one, B2 must have launched, and
   the native scan's signatures must equal the Python scan's on every
   chromosome; the device runs' regions are tiled again, and a chunk of
   each bucket those runs dispatched goes through B2 (B3 for a dense one)
   and its plain version on the card and on the CPU, byte for byte.  Step
   0 by part (out/log/stage_times.json), target mode by chromosome (stage
   seconds, chunks, host fallbacks, bytes, the dispatch window), the
   buckets hit with B2's or B3's launch plan, the tiles by encoding, peak
   host RSS, the card's peak allocation and recall, precision and F1
   against the truth are printed, not gated;
13. the port's measurement modules (focalsv_tpu_torch/benches/) on the
   card.  13a: benches.bench at bench.py's full 256 regions (SIZE_MIX at
   30x, seeds 1000+i), threads (--mp 0), one timed device pass after its
   warm pass and one timed host pass (the host baseline, a subprocess on
   the CPU) -- the repeats are the one cut (bench: 5 and 3); the device
   records must equal the host records (each region's keys), no tile may
   fall back to the host and B2 must launch; then B2 against its plain
   version on the card and on the CPU, byte for byte, timed, with its
   bound and launch plan, at every bucket the device pass dispatched (the
   jobs tiled again, the first G tiles of each bucket at the run's G, as
   phase 12 holds auto mode's) and at the workload's largest bucket as the
   bench measures it (G up to 8).  13b: benches.bench_accuracy_complex at
   2 trials a type (12 by default), with the native host kernel's cap at 0
   as in phase 8 (at the bench's defaults every DP of the aligner fits
   under it), so that B1 and B4 must launch; then again with the cap as it
   is (every DP on the host), and each trial's calls, controls included,
   must equal the card run's.  13c: benches.bench_accuracy at 2 regions a
   (dtype, case) (20 by default), guided, in this process (--procs 1; 2 by
   default), each dtype's F1 printed beside PARITY.md's, and the encoding
   its noisy tiles take.  13d: benches.bench_scaling at 1 and 2 shards
   (two logical shards of the one card): each region's result equal at
   both and to the plain version's on the dispatched chunk, B2 held to its
   plain version on each chunk as in 13a, and B2 launched.

Phase 4 also prints the region step's card time by kernel name for one
delta and one rows chunk (torch.profiler); each must take at most 5
launches and copies.  B2's and B3's launches are read from their counts on
every path that runs the region step (phases 4, 5, 6, 6b, 7, 11, 12 and
13), B6's on each run of phases 9b, 12 and 13.  The
script runs unchanged on a machine with several cards: phase 11's mesh and
ranks take a card each.

The last two lines are the kernels' JSON record and the result line.  A
kernel's bound_ms is the larger of its bytes (each input read once, each
output written once) over the card's memory rate and its integer operations
over the card's int32 rate (B6: its FP32 instructions over the FP32 rate),
for this run's inputs.  A kernel's ms is the
mean of calls issued back to back through its wrapper; each also reports
queued_ms, the same calls queued behind a sleep of the stream, which
leaves out the host's time to issue a call.  All data is simulated
from fixed seeds; scratch files go under build/.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.abspath(__file__))
SIZE_MIX = (15_000, 30_000, 50_000, 100_000)   # bench.py's region sizes
COVERAGE = 30.0
N_REGIONS = 32
N_OLC_REGIONS = 4
OLC_SCORING = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
ALIGNER_SCORING = dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2)
UNIT_COSTS = dict(match=0, mismatch=-1, gap_open=-1, gap_extend=-1)
DEVICE = torch.device("cuda")
# the card's peak rates (HBM_BYTES_PER_S, INT32_OPS_PER_S) are those of
# benches/bench.py, which kernel B2's bound counts with
# integer operations of the recurrence per band cell (substitution, the F,
# G, E, H maxima and their adds, the prefix max, the direction bits)
B1_OPS_PER_CELL = 30
# integer operations per step of a walk (index, load, mask, state, emit)
B4_OPS_PER_STEP = 10
# kernel B3's integer operations per (read, column) cell of a row in each
# of its two sweeps: the nibble's shift and mask, its symbol's compare and
# its count's add; MEC entries as B2's (benches/bench.py::B2_OPS_PER_ENTRY)
B3_OPS_PER_CELL = 4
NOISE = {"HIFI": {},
         "CLR": dict(sub_rate=0.04, ins_rate=0.04, del_rate=0.02)}
# phase 6b's substitution-heavy noisy reads (region_cases.NOISY_READS):
# every tile takes the dense encoding on its own (the delta encoding costs 9
# bytes a substitution, 12 a deletion run and nothing an insertion, the rows
# half a byte a column)
N_NOISY_REGIONS = 8
# kernel B2's and B3's launches on each path that runs the region step, each
# read from its count, set to 0 just before the path
B2_LAUNCHES: dict = {}
B3_LAUNCHES: dict = {}


def reset_counts() -> None:
    """B2's and B3's launch counts to 0, just before a path."""
    from focalsv_tpu_torch.ops import region_cuda
    region_cuda.reset_launches()


def record_counts(path: str) -> None:
    """B2's and B3's launches on the path just driven."""
    from focalsv_tpu_torch.ops import region_cuda
    B2_LAUNCHES[path] = region_cuda.launches
    B3_LAUNCHES[path] = region_cuda.rows_launches


def log(msg: str) -> None:
    print(msg, flush=True)


def sync() -> None:
    if DEVICE.type == "cuda":        # not in a CPU rehearsal of the script
        torch.cuda.synchronize()


# -- phase 1 ----------------------------------------------------------------

def device_check() -> str:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        sys.exit(1)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    log(smi)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} "
        f"python {sys.version.split()[0]}")
    return smi


def host_libraries() -> None:
    """Build and load the port's g++-built host libraries.  The pipeline
    has Python fallbacks for them; the smoke run does not accept those."""
    from focalsv_tpu_torch import native
    t0 = time.perf_counter()
    loaded = {"DP/chain": native.get_lib() is not None,
              "BAM parse/tile": native.get_parse_lib() is not None,
              "BAM scan": native.get_scan_lib() is not None,
              "BAM write": native.get_write_lib() is not None}
    log(f"[host] native libraries in {native.BUILD_DIR}: {loaded} "
        f"({time.perf_counter() - t0:.1f} s)")
    missing = [k for k, ok in loaded.items() if not ok]
    if missing:
        raise AssertionError(f"host libraries did not load: {missing}")


# -- phase 2 ----------------------------------------------------------------

def build_kernels() -> None:
    from focalsv_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] kernel library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if "Compiling entry" in line:
            # the kernel's name out of its mangled symbol
            name = next(
                (name for k, name in (
                    ("banded_align_reg_kernelILi4E", "B1 registers, 4 cells"),
                    ("banded_align_reg_kernelILi8E", "B1 registers, 8 cells"),
                    ("banded_align_reg_kernelILi16E",
                     "B1 registers, 16 cells"),
                    ("banded_align_wide_kernel", "B1 wide band"),
                    ("traceback_kernel", "B4"),
                    ("region_step_kernelINS_8DeltaSrc", "B2"),
                    ("region_step_kernelINS_7RowsSrc", "B3"),
                    ("pairhmm_kernelILb1ELb0E", "B6 shared, one strip"),
                    ("pairhmm_kernelILb1ELb1E", "B6 shared, strips"),
                    ("pairhmm_kernelILb0ELb0E", "B6 scratch, one strip"),
                    ("pairhmm_kernelILb0ELb1E", "B6 scratch, strips"))
                 if k in line), line)
            line = f"kernel {name}"
        elif not ("registers" in line or "spill" in line):
            continue
        log(f"[build] {line.strip()}")


# -- phase 3 ----------------------------------------------------------------

def kernel_parity(rng, cases):
    """B1 against the plain version on the card, and B4 on B1's direction
    bytes against its plain version and the host traceback; returns the
    rows of both kernels."""
    from focalsv_tpu_torch.benches.bench import (HBM_BYTES_PER_S,
                                                 INT32_OPS_PER_S, time_ms)
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    from focalsv_tpu_torch.testing.dp_cases import dp_pairs, noisy_pairs
    b1_rows, b4_rows = [], []
    for name, B, Lq, W, q_lo, scoring, store, lead, also, tb_plain in cases:
        pairs = (noisy_pairs(rng, B, Lq, W, q_lo) if name == "noisy_clr" else
                 dp_pairs(rng, B, Lq, W, q_lo, leading_ins=lead, edge=store))
        args = [torch.from_numpy(a).to(DEVICE) for a in pairs]
        q, q_len, t, t_len, d_lo = args

        def kernel(a=args):
            return align_cuda.banded_align_batch_cuda(
                *a, band=W, store_dirs=store, **scoring)

        def plain():
            return talign.banded_align_batch(*args, band=W,
                                             store_dirs=store, **scoring)

        s_k, d_k = kernel()
        sync()
        ms = time_ms(kernel, 3)
        queued = time_ms(kernel, 3, queued=True)
        plain_ms = time_ms(plain, 1)
        s_p, d_p = plain()
        err = int((s_k.long() - s_p.long()).abs().max())
        if store:
            err = max(err, int((d_k.int() - d_p.int()).abs().max()))
        finite = int((s_p > talign.NEG).sum())
        # this run's work: the rows a pair really has, every byte once
        cells = int(q_len.clamp(0, Lq).sum()) * W
        nbytes = (q.numel() + t.numel() + 12 * B + 4 * B
                  + (B * Lq * W if store else 0))
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = cells * B1_OPS_PER_CELL / INT32_OPS_PER_S * 1e3
        row = dict(case=name, max_abs_err=err, ms=ms, queued_ms=queued,
                   plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations")
        extra = ""
        for b in also:               # the batches the main path sends
            sub = [a[:b].contiguous() for a in args]
            row[f"ms_B{b}"] = time_ms(lambda: kernel(sub), 3)
            extra += f" kernel_ms_B{b}={row[f'ms_B{b}']:.3f}"
        log(f"[b1] {name}: B={B} Lq={Lq} W={W} dirs={store} "
            f"max_abs_err={err} in_band={finite}/{B} kernel_ms={ms:.3f}"
            f" queued_ms={queued:.3f}{extra} plain_ms={plain_ms:.1f} "
            f"bound_ms={row['bound_ms']:.3f} bound_by={row['bound_by']}")
        if err != 0:
            raise AssertionError(f"B1 differs from its plain version ({name})")
        if finite == 0:
            raise AssertionError(f"no pair of {name} scored in band")
        b1_rows.append(row)
        if store:
            b4_rows.append(traceback_parity(name, d_k, s_k, q_len, t_len,
                                            d_lo, W, Lq, tb_plain))
        del args, s_k, d_k, s_p, d_p
    return b1_rows, b4_rows


def traceback_parity(name, dirs, scores, q_len, t_len, d_lo, W, Lq, n_plain):
    """B4 on one case's direction bytes: against its plain version on the
    first n_plain pairs (they hold the edge pairs) and against the host
    traceback's CIGAR on the pairs among them that scored."""
    from focalsv_tpu_torch.benches.bench import (HBM_BYTES_PER_S,
                                                 INT32_OPS_PER_S, time_ms)
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    from focalsv_tpu_torch.testing.dp_cases import walk_decisions
    B = dirs.shape[0]

    def kernel():
        return align_cuda.traceback_cuda(dirs, q_len, t_len, d_lo, W, Lq)

    ops_k, n_k = kernel()
    sync()
    ms = time_ms(kernel, 3)
    queued = time_ms(kernel, 3, queued=True)
    sub = [a[:n_plain].contiguous() for a in (dirs, q_len, t_len, d_lo)]
    t0 = time.perf_counter()
    ops_p, n_p = talign.traceback_device(*sub, W, Lq)
    sync()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err = max(int((ops_k[:n_plain].int() - ops_p.int()).abs().max()),
              int((n_k[:n_plain] - n_p).abs().max()))
    ops_h, n_h = ops_k.cpu().numpy(), n_k.cpu().numpy()
    host_same, host_n = True, 0
    for b in range(n_plain):
        if int(scores[b]) <= talign.NEG // 2:
            continue                # off the band: no alignment to walk
        host = talign.traceback(dirs[b].cpu().numpy(), int(q_len[b]),
                                int(t_len[b]), int(d_lo[b]))
        got = talign.ops_to_cigar(ops_h[b], int(n_h[b]))
        host_same = host_same and got == host
        host_n += 1
    steps = int(n_h.sum())
    # the walk's dependent decisions: one per 32 ops of each run
    decisions = max(walk_decisions(ops_h[b], int(n_h[b])) for b in range(B))
    nbytes = steps + ops_k.numel() + 16 * B     # a dirs byte a step, the ops
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = steps * B4_OPS_PER_STEP / INT32_OPS_PER_S * 1e3
    log(f"[b4] {name}: B={B} Lq={Lq} W={W} max_abs_err={err} "
        f"(plain on {n_plain} pairs) host_cigar_equal={host_same} "
        f"(on {host_n} pairs) mean_ops={steps / B:.0f} "
        f"longest_walk_decisions={decisions} kernel_ms={ms:.4f} "
        f"queued_ms={queued:.4f} plain_ms={plain_ms:.1f} "
        f"bound_ms={max(t_bytes, t_ops):.5f}")
    if err != 0 or not host_same or host_n == 0:
        raise AssertionError(f"B4 differs from its plain version or from "
                             f"the host traceback ({name})")
    return dict(case=name, max_abs_err=err, ms=ms, queued_ms=queued,
                plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                bound_by="bytes" if t_bytes > t_ops else "operations")


def walk_parity() -> int:
    """B4 against its plain version on crafted direction bytes: gap runs
    longer than 32 ops, than a tile's 64 rows and 128 columns, runs ending
    on the band's edge, a full op string, random bytes.  Returns the
    largest difference (0 or the run fails)."""
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    from focalsv_tpu_torch.testing.dp_cases import walk_cases
    worst = 0
    for name, dirs, q_len, t_len, d_lo, W, M in walk_cases(with_stop=True):
        case = [torch.from_numpy(a).to(DEVICE) for a in (dirs, q_len, t_len,
                                                         d_lo)]
        ops_k, n_k = align_cuda.traceback_cuda(*case, W, M)
        ops_p, n_p = talign.traceback_device(*case, W, M)
        sync()
        err = max(int((ops_k.int() - ops_p.int()).abs().max()),
                  int((n_k - n_p).abs().max()))
        log(f"[b4] walk {name}: B={len(dirs)} M={M} W={W} max_abs_err={err} "
            f"n={n_k.tolist()}")
        if err != 0:
            raise AssertionError(f"B4 differs from its plain version on the "
                                 f"crafted walk {name}")
        worst = max(worst, err)
    return worst


B1_CASES = [
    # name, B, Lq, W, shortest query, scoring, store_dirs, leading insertion,
    # smaller batches to time, pairs for B4's plain version
    ("olc_polish", 128, 16384, 512, 12000, OLC_SCORING, True, False, (2, 1),
     8),
    ("aligner_gap_fill", 128, 1024, 128, 300, ALIGNER_SCORING, True, False,
     (), 128),
    ("leading_insertion", 32, 1024, 128, 300, OLC_SCORING, True, True, (),
     32),
    # about 15 % error: the walk changes state every few ops
    ("noisy_clr", 16, 4096, 512, 3000, OLC_SCORING, True, False, (1,), 4),
    # register kernel, 16 warps a pair
    ("edit_sim_w8192", 4, 16384, 8192, 12000, UNIT_COSTS, False, False, (),
     0),
    # wide-band kernel, state in shared memory
    ("edit_sim_w10240_smem", 2, 4096, 10240, 2000, UNIT_COSTS, False, False,
     (), 0),
    # wide-band kernel, state in global scratch
    ("edit_sim_w32768_scratch", 2, 4096, 32768, 2000, UNIT_COSTS, False,
     False, (), 0),
]


# -- phase 4 ----------------------------------------------------------------

def _simulate(n, dtype="HIFI", seed0=1000, sizes=SIZE_MIX):
    from focalsv_tpu_torch.testing import simulate as sim
    noise = NOISE[dtype]
    out = []
    for i in range(n):
        L = sizes[i % len(sizes)]
        out.append(sim.simulate_region(seed=seed0 + i, ref_len=L,
                                       coverage=COVERAGE,
                                       n_snps=max(10, L // 1200), **noise))
    return out


def region_tiles(hifi_regions, n_clr):
    """[(config, tiles)]: HiFi tiles of the given regions and n_clr noisy CLR
    tiles made dense (the dense entry must run)."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel.wire import BLOCK, pack_row_tile
    from focalsv_tpu_torch.assembly.consensus import compact_pileup_rows
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg = preset("HIFI")
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in hifi_regions]
    ccfg = preset("CLR")
    ctiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, ccfg)
              for rg in _simulate(n_clr, "CLR", seed0=2000)]
    for t in ctiles:
        if t.encoding != "dense":
            rows, starts, _ = compact_pileup_rows(
                t.usable, list(range(len(t.usable))), 0, t.region_len)
            t.row_starts = starts.astype(np.int32)
            t.row_lens = np.array([len(r) for r in rows], np.int32)
            offs = (t.row_starts % BLOCK).astype(np.int32)
            t.W_pad = dx._wbucket(int((t.row_lens + offs).max()))
            t.nib = pack_row_tile(rows, t.W_pad, offsets=offs)
            t.q_starts = (t.row_starts // BLOCK).astype(np.int32)
            t.encoding = "dense"
    return [(cfg, tiles), (ccfg, ctiles)]


def region_chunks(jobs, n_devices):
    """One packed chunk per bucket of each job, at the production batch size
    for n_devices: (config, bucket key, G, count of real regions, buffer)."""
    from focalsv_tpu_torch.pipeline import device_exec as dx
    for cfg, tiles in jobs:
        buckets: dict = {}
        for i, t in enumerate(tiles):
            buckets.setdefault(dx._bucket_key(t, cfg), []).append(i)
        for key, idxs in sorted(buckets.items()):
            G = dx._batch_size(key, cfg, n_devices)
            chunk = idxs + [len(tiles)] * (G - len(idxs))
            yield cfg, key, G, len(idxs), dx.pack_chunk(tiles + [None], chunk,
                                                        key, G)


def rows_cells(buf: np.ndarray, kw) -> int:
    """The (read, column) cells of a dense chunk that its sweeps must
    decode and count: each valid read's row columns that fall in [0, L)."""
    from focalsv_tpu_torch.parallel.wire import BLOCK, rows_flat_layout
    G, R, L, W = (kw[k] for k in ("G", "R", "L", "W"))
    lay = rows_flat_layout(G, R, W)
    q = buf[slice(*lay["qstart"])].view(np.int32).astype(np.int64)
    rv = buf[slice(*lay["rv"])] != 0
    lo = np.maximum(q * BLOCK, 0)
    hi = np.minimum(q * BLOCK + W, L)
    return int(np.maximum(hi - lo, 0)[rv].sum())


def rows_bytes(buf: np.ndarray, kw) -> int:
    """The bytes of a dense chunk that B3 must read: each valid read's row
    bytes that hold a column in [0, L) (byte j of a row holds its columns j
    and j + W/2), and the qstart, rv and ltrue sections whole."""
    from focalsv_tpu_torch.parallel.wire import BLOCK, rows_flat_layout
    G, R, L, W = (kw[k] for k in ("G", "R", "L", "W"))
    lay = rows_flat_layout(G, R, W)
    q = buf[slice(*lay["qstart"])].view(np.int32).astype(np.int64)
    rv = buf[slice(*lay["rv"])] != 0
    half = W // 2
    # the row's columns in [0, L), relative to the row's first column
    lo = np.clip(-q * BLOCK, 0, W)
    hi = np.clip(L - q * BLOCK, lo, W)
    # bytes of the first half's columns, of the second half's, and both
    a0, a1 = np.minimum(lo, half), np.minimum(hi, half)
    b0, b1 = np.maximum(lo, half) - half, np.maximum(hi, half) - half
    both = np.maximum(np.minimum(a1, b1) - np.maximum(a0, b0), 0)
    touched = (a1 - a0) + (b1 - b0) - both
    small = sum(lay[k][1] - lay[k][0] for k in ("qstart", "rv", "ltrue"))
    return int(touched[rv].sum()) + small


def b3_bound(buf, dev_buf, out, kw) -> tuple[float, str]:
    """B3's least time on the card for one dense chunk: its bytes (the rows
    of its valid reads and its small sections read once, rows_bytes; the
    results written once) over the memory rate, against its
    integer operations over the int32 rate: B3_OPS_PER_CELL a cell of a row
    in each of the two sweeps (rows_cells counts this run's cells), and
    B2_OPS_PER_ENTRY a (read, site) entry of each MEC round the data needs
    (the fewest that give the same bytes) and of the final assignment."""
    from focalsv_tpu_torch.benches.bench import (B2_OPS_PER_ENTRY,
                                                 HBM_BYTES_PER_S,
                                                 INT32_OPS_PER_S)
    from focalsv_tpu_torch.parallel import region_step as rs
    n_sites = out[:, :4].contiguous().view(torch.int32).reshape(-1).long()
    rounds = kw["mec_iters"]
    for k in range(kw["mec_iters"]):
        if torch.equal(rs.phase_consensus_rows_flat(
                dev_buf, **dict(kw, mec_iters=k)), out):
            rounds = k
            break
    entries = int(n_sites.sum()) * kw["R"] * (rounds + 1)
    ops = (2 * rows_cells(buf, kw) * B3_OPS_PER_CELL
           + entries * B2_OPS_PER_ENTRY)
    t_bytes = (rows_bytes(buf, kw) + out.numel()) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


def rows_kwargs(key, G, cfg) -> dict:
    """The region step's arguments for a dense chunk, as dispatch_packed
    gives them."""
    from focalsv_tpu_torch.parallel import region_step as rs
    _, R, L, W = key
    return dict(rs.phase_consensus_kwargs(cfg.phasing), G=G, R=R, L=L, W=W)


def region_step_parity(jobs):
    """The port's region step on the card vs on the CPU, byte for byte, at
    production chunk sizes; at every delta chunk also kernel B2 against its
    plain version on the card, at every dense chunk B3, timed in turns.
    Returns B2's rows and B3's."""
    from focalsv_tpu_torch.benches.bench import delta_kwargs, time_ms
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    chunks = list(region_chunks(jobs, 1))
    # the path: every chunk through dispatch_packed once, counts from 0
    reset_counts()
    firsts = [np.asarray(dx.dispatch_packed(buf, key, G, cfg, DEVICE))
              for cfg, key, G, _n, buf in chunks]
    record_counts("region_step_chunks")
    n_delta = sum(key[0] == "delta" for _c, key, *_ in chunks)
    log(f"[region_step] launches on {len(chunks)} chunks through "
        f"dispatch_packed: B2 {region_cuda.launches} ({n_delta} delta "
        f"chunks), B3 {region_cuda.rows_launches} ({len(chunks) - n_delta} "
        f"dense chunks)")
    if region_cuda.launches != n_delta:
        raise AssertionError("B2 did not launch once per delta chunk")
    if region_cuda.rows_launches != len(chunks) - n_delta:
        raise AssertionError("B3 did not launch once per dense chunk")
    rows, b3_rows = [], []
    profiled = set()
    for (cfg, key, G, n_real, buf), got in zip(chunks, firsts):
        if key[0] == "delta":
            # the chunk's next two dispatches in parts: where the time of a
            # dispatch goes
            for turn in (2, 3):
                part = dispatch_split(buf, key, G, cfg)
                log(f"[dispatch] {key} G={G} dispatch {turn}: " + " ".join(
                    f"{k}={v:.3f}" for k, v in part.items()))
        ms = time_ms(lambda: dx.dispatch_packed(buf, key, G, cfg, DEVICE)
                     .host, 2)
        t0 = time.perf_counter()
        want = np.asarray(dx.dispatch_packed(buf, key, G, cfg,
                                             torch.device("cpu")))
        cpu_s = time.perf_counter() - t0
        same = got.shape == want.shape and np.array_equal(got, want)
        log(f"[region_step] {key} G={G} real={n_real} "
            f"card_ms_per_chunk={ms:.1f} cpu_s={cpu_s:.2f} "
            f"bytes_equal={same}")
        if not same:
            raise AssertionError(f"region step on the card differs from "
                                 f"the CPU for bucket {key}")
        if key[0] == "delta":
            rows.append(against_plain(str(key), buf, delta_kwargs(
                key, G, cfg), want))
        else:
            b3_rows.append(against_plain(f"clr {key}", buf, rows_kwargs(
                key, G, cfg), want))
        if key[0] not in profiled:           # one delta and one rows chunk
            profiled.add(key[0])
            profile_chunk(buf, key, G, cfg)
    return rows, b3_rows


def dispatch_split(buf, key, G, cfg) -> dict:
    """One delta chunk's dispatch as dispatch_packed issues it, in parts:
    pinning the host buffer (host clock), the copy in, the kernel and the
    copy out (CUDA events), and the whole until the result is on the host
    (host clock)."""
    from focalsv_tpu_torch.benches.bench import delta_kwargs
    from focalsv_tpu_torch.parallel import region_step as rs
    kw = delta_kwargs(key, G, cfg)
    if DEVICE.type != "cuda":            # a CPU rehearsal of the script
        t0 = time.perf_counter()
        rs.phase_consensus_delta_flat(torch.from_numpy(buf), **kw)
        return dict(wall_ms=(time.perf_counter() - t0) * 1e3)
    sync()
    t0 = time.perf_counter()
    src = torch.from_numpy(buf).pin_memory()
    t1 = time.perf_counter()
    ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
    ev[0].record()
    dev = src.to(DEVICE, non_blocking=True)
    ev[1].record()
    res = rs.phase_consensus_delta_flat(dev, **kw)
    ev[2].record()
    host = torch.empty(res.shape, dtype=res.dtype, pin_memory=True)
    host.copy_(res, non_blocking=True)
    ev[3].record()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3
    return dict(pin_ms=(t1 - t0) * 1e3, copy_in_ms=ev[0].elapsed_time(ev[1]),
                kernel_ms=ev[1].elapsed_time(ev[2]),
                copy_out_ms=ev[2].elapsed_time(ev[3]), wall_ms=wall)


def against_plain(case, buf, kw, cpu_out=None) -> dict:
    """B2 (a delta chunk) or B3 (a dense chunk: kw has W) on the card
    against its plain version on the card and on the CPU, byte for byte;
    ms a chunk of both on the card (CUDA events, in turns: kernel, plain,
    plain, kernel, each call issued as the last one returns), the kernel's
    ms with its calls queued behind a sleep of the stream (queued_ms: the
    card's time alone), its bound and its launch plan."""
    from focalsv_tpu_torch.benches.bench import b2_bound, time_ms
    from focalsv_tpu_torch.parallel import region_step as rs
    kw = {**rs.STEP_DEFAULTS, **kw}
    dense = "W" in kw
    name = "B3" if dense else "B2"
    entry, plain_entry = (
        (rs.phase_consensus_rows_flat, rs.phase_consensus_rows_flat_plain)
        if dense else
        (rs.phase_consensus_delta_flat, rs.phase_consensus_delta_flat_plain))
    dev = torch.from_numpy(buf).to(DEVICE)

    def kernel():
        return entry(dev, **kw)

    def plain():
        return plain_entry(dev, **kw)

    out = kernel()
    on_card = plain()
    sync()
    if cpu_out is None:
        cpu_out = entry(torch.from_numpy(buf), **kw).numpy()
    host = out.cpu().numpy()
    err = int(np.abs(host.astype(np.int16) - cpu_out.astype(np.int16)).max())
    err = max(err, int((out.int() - on_card.int()).abs().max()))
    k1, p1 = time_ms(kernel, 20), time_ms(plain, 2)
    p2, k2 = time_ms(plain, 2), time_ms(kernel, 20)
    queued = time_ms(kernel, 20, queued=True)
    bound, by = (b3_bound(buf, dev, out, kw) if dense
                 else b2_bound(dev, out, kw))
    plan = launch_plan(kw)
    row = dict(case=case, L=kw["L"], max_abs_err=err, ms=(k1 + k2) / 2,
               queued_ms=queued, plain_ms=(p1 + p2) / 2, bound_ms=bound,
               bound_by=by, **plan)
    shape = (f"W={kw['W']} cells={rows_cells(buf, kw)} "
             f"row_bytes={rows_bytes(buf, kw)}" if dense
             else f"Drle={kw['Drle']}")
    log(f"[{name.lower()}] {case}: G={kw['G']} R={kw['R']} L={kw['L']} "
        f"{shape} S={kw['max_sites']} max_abs_err={err} (card plain and "
        f"CPU) kernel_ms={k1:.4f},{k2:.4f} queued_ms={queued:.4f} "
        f"plain_ms={p1:.2f},{p2:.2f} "
        f"bound_ms={bound:.4f} bound_by={by} "
        f"share_of_bound={bound / ((k1 + k2) / 2):.3f} "
        + " ".join(f"{k}={v}" for k, v in plan.items()))
    if err != 0:
        raise AssertionError(f"{name} differs from its plain version "
                             f"({case})")
    return row


def launch_plan(kw) -> dict:
    """How B2 or B3 launches this chunk: CTAs a region, shared memory a
    CTA, and whether the planes and (B2) the events live in shared
    memory."""
    if DEVICE.type != "cuda":            # a CPU rehearsal of the script
        return {}
    from focalsv_tpu_torch.ops import region_cuda
    if "W" in kw:
        return region_cuda.rows_launch_plan(
            **{k: kw[k] for k in ("G", "R", "L", "W")}, S=kw["max_sites"])
    return region_cuda.launch_plan(
        **{k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")},
        S=kw["max_sites"])


def region_case_parity() -> tuple[list[dict], list[dict]]:
    """B2 against its plain version on every delta case of
    testing/region_cases.py, B3 on every dense case."""
    from focalsv_tpu_torch.testing import region_cases
    return ([against_plain(name, *region_cases.build(name))
             for name in sorted(region_cases.CASES)],
            [against_plain(name, *region_cases.build_rows(name))
             for name in sorted(region_cases.ROWS_CASES)])


PROFILE_TRIES = 8


def profile_chunk(buf, key, G, cfg, top: int = 10) -> None:
    """Print one chunk's card time by kernel name (torch.profiler): the top
    kernels by their summed time, and how many launches the chunk takes.
    The card's tracer sometimes hands the profiler no records, or only some
    of them, for a dispatch; a profile that does not list the region-step
    kernel is taken again, up to PROFILE_TRIES times."""
    from torch.profiler import ProfilerActivity, profile

    from focalsv_tpu_torch.pipeline import device_exec as dx
    for attempt in range(1, PROFILE_TRIES + 1):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            np.asarray(dx.dispatch_packed(buf, key, G, cfg, DEVICE))
            sync()
        rows = []
        for e in prof.key_averages():
            us = e.self_device_time_total
            if us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
                rows.append((us, e.count, e.key))
        if any("region_step_kernel" in name for _us, _n, name in rows):
            break
        log(f"[profile] {key}: try {attempt} of {PROFILE_TRIES} recorded "
            f"{len(rows)} names and not the region-step kernel")
    else:
        raise AssertionError(f"torch.profiler did not record the region "
                             f"step's kernel for bucket {key} in "
                             f"{PROFILE_TRIES} tries")
    rows.sort(reverse=True)
    total_us = sum(r[0] for r in rows)
    launches = sum(r[1] for r in rows)
    log(f"[profile] {key} G={G}: {launches} kernel launches and copies, "
        f"{total_us / 1e3:.2f} ms of card time; top {top} by name:")
    if launches > 5:
        raise AssertionError(f"a {key[0]} chunk took {launches} launches "
                             f"and copies; kernels B2 and B3 make the step "
                             f"one launch")
    for us, count, name in rows[:top]:
        for noise in ("void ", "at::native::", "(anonymous namespace)::",
                      "at::TensorIteratorBase&", "std::"):
            name = name.replace(noise, "")
        log(f"[profile]   {us / 1e3:8.3f} ms {100 * us / total_us:5.1f} % "
            f"x{count:<5d} {name[:150]}")


# -- phase 5 ----------------------------------------------------------------

def golden(work: str) -> None:
    from focalsv_tpu_torch.pipeline import cli
    d = os.path.join(ROOT, "tests", "data", "golden", "hifi")
    out = os.path.join(work, "golden")
    t0 = time.perf_counter()
    reset_counts()
    rc = cli.main(["--bam_file", f"{d}/reads.bam", "--ref_file",
                   f"{d}/ref.fa", "--target_bed", f"{d}/regions.bed",
                   "--out_dir", out, "--data_type", "HIFI",
                   "--num_threads", "4", "--execution", "device"])
    record_counts("golden_cli")
    with open(os.path.join(out, "FocalSV_Final_SV.vcf")) as f:
        got = f.read()
    with open(os.path.join(d, "expected.vcf")) as f:
        same = got == f.read()
    log(f"[golden] rc={rc} byte_exact={same} "
        f"seconds={time.perf_counter() - t0:.2f} "
        f"B2 launches {B2_LAUNCHES['golden_cli']}")
    if rc != 0 or not same:
        raise AssertionError("golden HIFI VCF differs from expected.vcf")


# -- phase 6 ----------------------------------------------------------------

def write_chromosome(regions, work: str):
    """Concatenate the regions into one chromosome: BAM + FASTA + a BED per
    region count (all of them, and the first N_OLC_REGIONS)."""
    import focalsv_tpu_torch.io.bam as bamio
    from focalsv_tpu_torch.io.fasta import write_fasta
    offs = np.cumsum([0] + [len(rg.ref) for rg in regions])
    chrom_ref = np.concatenate([rg.ref for rg in regions])
    bam_path = os.path.join(work, "reads.bam")
    recs = [dataclasses.replace(r, pos=r.pos + int(offs[i]))
            for i, rg in enumerate(regions) for r in rg.reads]
    recs.sort(key=lambda r: r.pos)
    w = bamio.BamWriter(bam_path, ["chr21"], [len(chrom_ref)])
    for r in recs:
        w.write(r)
    w.close()
    bamio.build_bai(bam_path)
    fa_path = os.path.join(work, "ref.fa")
    write_fasta(fa_path, [("chr21", chrom_ref)])
    beds = {}
    for n in (len(regions), min(N_OLC_REGIONS, len(regions))):
        beds[n] = os.path.join(work, f"regions_{n}.bed")
        with open(beds[n], "w") as f:
            for i in range(n):
                f.write(f"chr21\t{offs[i] + 100}\t{offs[i + 1] - 100}\n")
    return bam_path, fa_path, beds


def run_mode(bam, fa, bed, out, method, mode, n, mesh=None, dtype="HIFI",
             pairhmm=False):
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.pipeline import main
    cfg = preset(dtype)
    cfg = cfg.replace(
        assembly=dataclasses.replace(cfg.assembly, method=method),
        execution=dataclasses.replace(cfg.execution, mode=mode),
        phasing=dataclasses.replace(cfg.phasing, use_pairhmm=pairhmm))
    if pairhmm:
        method += " use_pairhmm"
    t0 = time.perf_counter()
    final = main.run_target_mode(bam, fa, out, cfg, target_bed=bed,
                                 num_workers=8, mesh=mesh)
    secs = time.perf_counter() - t0
    with open(final) as f:
        vcf = f.read()
    stats = {}
    path = os.path.join(out, "chr21", "log", "device_stats.json")
    if mode == "device":
        with open(path) as f:
            stats = json.load(f)
    with open(os.path.join(out, "chr21", "log", "stage_times.json")) as f:
        stages = {k: v["seconds"] for k, v in json.load(f).items()}
    stats["wall_s"] = secs
    stats["stages"] = stages
    if mode == "device":
        stages.update({k: round(stats[k], 3) for k in (
            "tile_build_s", "finish_s", "device_s")})
    log(f"[slice] {dtype} {method} {mode} stage seconds: "
        f"{json.dumps(stages)}")
    n_rec = sum(1 for line in vcf.splitlines() if not line.startswith("#"))
    log(f"[slice] {dtype} {method} {mode}"
        f"{f' on {mesh!r}' if mesh else ''}: "
        f"{n} regions in {secs:.2f} s = "
        f"{n / secs:.3f} regions/s, {n_rec} records"
        + (f", n_chunks={stats['n_chunks']} "
           f"n_host_fallback={stats['n_host_fallback']} "
           f"h2d_bytes={int(stats['h2d_bytes'])} "
           f"d2h_bytes={int(stats['d2h_bytes'])} "
           f"dp_jobs={stats.get('dp_jobs', 0)} "
           f"dp_batches={stats.get('dp_batches', 0)} "
           f"dp_d2h_bytes={stats.get('dp_d2h_bytes', 0)}"
           if mode == "device" else ""))
    return vcf, stats, n_rec


def slice_run(regions, work: str):
    """Device runs (the main path, with the launch counts) then host runs;
    each device VCF must equal its host VCF."""
    from focalsv_tpu_torch.ops import align_cuda
    bam, fa, beds = write_chromosome(regions, work)
    n_all, n_olc = len(regions), N_OLC_REGIONS
    os.environ["FOCALSV_DP_RT_MS"] = "0"    # every DP job to the device batch
    align_cuda.reset_launches()
    reset_counts()
    g_dev, g_stats, g_rec = run_mode(bam, fa, beds[n_all],
                                     f"{work}/guided_device", "guided",
                                     "device", n_all)
    launches_guided = align_cuda.launches
    record_counts("target_mode_guided")
    reset_counts()
    inputs = dict(fasta=fa, bam=bam, bed=beds[n_all],
                  guided_vcf=f"{work}/guided_device/FocalSV_Final_SV.vcf",
                  guided_rps=n_all / g_stats["wall_s"],
                  guided_b1=launches_guided)
    o_dev, o_stats, o_rec = run_mode(bam, fa, beds[n_olc],
                                     f"{work}/olc_device", "olc", "device",
                                     n_olc)
    launches = align_cuda.launches
    tb_launches = align_cuda.traceback_launches
    record_counts("target_mode_olc")
    log(f"[slice] launches on the main path: B1 {launches} "
        f"(guided {launches_guided}, olc {launches - launches_guided}), "
        f"B4 {tb_launches}, B2 guided {B2_LAUNCHES['target_mode_guided']} "
        f"olc {B2_LAUNCHES['target_mode_olc']}")
    jobs = max(o_stats.get("dp_jobs", 0), 1)
    log(f"[slice] batcher d2h bytes per job (olc): "
        f"{o_stats.get('dp_d2h_bytes', 0) / jobs:.0f} with the traceback on "
        f"the card, {(o_stats.get('dp_dirs_bytes_on_device', 0) + 4 * jobs) / jobs:.0f} "
        f"if the direction bytes crossed as before")
    del os.environ["FOCALSV_DP_RT_MS"]
    g_host, gh_stats, _ = run_mode(bam, fa, beds[n_all],
                                   f"{work}/guided_host", "guided", "host",
                                   n_all)
    o_host, oh_stats, _ = run_mode(bam, fa, beds[n_olc], f"{work}/olc_host",
                                   "olc", "host", n_olc)
    for method, n, dev, host in (("guided", n_all, g_stats, gh_stats),
                                 ("olc", n_olc, o_stats, oh_stats)):
        log(f"[slice] {method}: device {n / dev['wall_s']:.3f} regions/s "
            f"tile_build_s={dev['tile_build_s']:.3f} "
            f"device_s={dev['device_s']:.4f}; host "
            f"{n / host['wall_s']:.3f} regions/s regions_host_s="
            f"{host['stages'].get('regions_host', 0.0):.3f}")
    # the BAM fetch of the 32 regions, one thread: the scan from the first
    # index chunk against the scan restarted at every chunk it replaced
    from focalsv_tpu_torch.testing import fetch_timing
    with open(beds[n_all]) as f:
        queries = [(c, int(a), int(b)) for c, a, b in
                   (ln.split("\t") for ln in f.read().splitlines())]
    fetched = fetch_timing.time_fetches(bam, queries, reps=1)
    log(f"[slice] fetch of {len(queries)} regions: one scan "
        f"{fetched['one_scan_s']:.3f} s, a scan a chunk "
        f"{fetched['per_chunk_s']:.3f} s, {fetched['records']} records, "
        f"same: {fetched['same']}")
    checks = {
        "guided device VCF == host VCF": g_dev == g_host,
        "olc device VCF == host VCF": o_dev == o_host,
        "guided records > 0": g_rec > 0,
        "olc records > 0": o_rec > 0,
        "n_chunks > 0": g_stats["n_chunks"] > 0 and o_stats["n_chunks"] > 0,
        "dp batcher n_jobs > 0 (olc)": o_stats.get("dp_jobs", 0) > 0,
        "B1 launches > 0 (olc)": launches - launches_guided > 0,
        "B4 launches > 0 (olc)": tb_launches > 0,
        "B2 launches > 0 (guided)": B2_LAUNCHES["target_mode_guided"] > 0,
        "fetch: one scan == a scan a chunk": fetched["same"],
    }
    for name, ok in checks.items():
        log(f"[slice] check {name}: {ok}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return dict(inputs, b1=launches, b4=tb_launches,
                olc_out=f"{work}/olc_device")


# -- phase 6b ---------------------------------------------------------------

def noisy_cpu_run(bam, fa, bed, out) -> None:
    """Phase 6b's device-mode run on the CPU (the plain version), in the
    subprocess that the smoke run starts."""
    run_mode(bam, fa, bed, out, "guided", "device", N_NOISY_REGIONS,
             dtype="ONT")


def noisy_slice(work: str) -> tuple[list[dict], dict]:
    """Phase 6b: the noisy regions through run_target_mode (ONT preset) on
    the card, on the CPU and in host mode; then B3 against its plain
    version at every noisy chunk.  Returns B3's rows of those chunks and
    the run's BAM, FASTA and BED."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.testing import region_cases
    t0 = time.perf_counter()
    regions = region_cases.noisy_regions(N_NOISY_REGIONS, 3000)
    cfg = preset("ONT")
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in regions]
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    log(f"[noisy] {len(regions)} regions simulated and tiled in "
        f"{time.perf_counter() - t0:.1f} s; buckets {keys}")
    if any(k is None or k[0] != "dense" for k in keys):
        raise AssertionError("a noisy tile did not take the dense encoding")
    d = f"{work}/noisy"
    os.makedirs(d)
    bam, fa, beds = write_chromosome(regions, d)
    bed = beds[len(regions)]
    # the plain version's run on the CPU, beside the card's runs
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--noisy-cpu", bam, fa,
         bed, f"{d}/cpu"],
        env=dict(os.environ, FOCALSV_TORCH_DEVICE="cpu",
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        reset_counts()
        dev, dev_stats, dev_rec = run_mode(bam, fa, bed, f"{d}/device",
                                           "guided", "device", len(regions),
                                           dtype="ONT")
        record_counts("noisy_target_mode")
        host, host_stats, host_rec = run_mode(bam, fa, bed, f"{d}/host",
                                              "guided", "host",
                                              len(regions), dtype="ONT")
    finally:
        cpu_log = proc.communicate(timeout=900)[0]
    if proc.returncode != 0:
        raise AssertionError(f"phase 6b's CPU run failed:\n"
                             f"{cpu_log[-3000:]}")
    with open(f"{d}/cpu/FocalSV_Final_SV.vcf") as f:
        cpu = f.read()
    with open(f"{d}/cpu/chr21/log/device_stats.json") as f:
        cpu_stats = json.load(f)
    n = len(regions)
    b3 = B3_LAUNCHES["noisy_target_mode"]
    log(f"[noisy] device (card) {n / dev_stats['wall_s']:.3f} regions/s, "
        f"tile_build_s={dev_stats['tile_build_s']:.3f} "
        f"finish_s={dev_stats['finish_s']:.3f} "
        f"device_s={dev_stats['device_s']:.4f}; host "
        f"{n / host_stats['wall_s']:.3f} regions/s; device on the CPU "
        f"(plain version): finish_s={cpu_stats['finish_s']:.3f}; "
        f"launches B3 {b3}, B2 {B2_LAUNCHES['noisy_target_mode']}")
    host_same = dev == host
    log(f"[noisy] host VCF == device VCF: {host_same} ({host_rec} host "
        f"records, {dev_rec} device records)")
    if not host_same:
        got = [ln for ln in dev.splitlines() if not ln.startswith("#")]
        want = [ln for ln in host.splitlines() if not ln.startswith("#")]
        for ln in sorted(set(got) ^ set(want)):
            log(f"[noisy]   {'device' if ln in got else 'host'} only: "
                f"{ln[:300]}")
    checks = {
        "card device VCF == CPU device VCF": dev == cpu,
        "records > 0": dev_rec > 0,
        "n_host_fallback == 0": dev_stats["n_host_fallback"] == 0,
        "B3 launches == dense chunks": b3 == dev_stats["n_chunks"] > 0,
        "B2 launches == 0": B2_LAUNCHES["noisy_target_mode"] == 0,
    }
    for name, ok in checks.items():
        log(f"[noisy] check {name}: {ok}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"noisy slice checks failed: {failed}")
    # B3 at each noisy chunk, as the run packed them, and at a chunk that
    # noisy regions fill (launches not counted)
    rows = [against_plain(f"noisy {key} real={n_real}", buf,
                          rows_kwargs(key, G, cfg))
            for cfg, key, G, n_real, buf in region_chunks([(cfg, tiles)], 1)]
    return (rows + [full_noisy_chunk(key)
                    for key in region_cases.FULL_ROWS_KEYS],
            dict(bam=bam, fasta=fa, bed=bed))


def full_noisy_chunk(key) -> dict:
    """B3 against its plain version at one chunk of the bucket key with
    every slot a real noisy region (testing/region_cases.py::
    full_rows_chunk, seeds 4000+i, at the bucket's region size): phase 6b's
    chunks hold one or two regions each."""
    from focalsv_tpu_torch.testing import region_cases
    t0 = time.perf_counter()
    key, n_real, buf, args = region_cases.full_rows_chunk(key)
    log(f"[noisy] {n_real} regions simulated and tiled into one {key} "
        f"chunk in {time.perf_counter() - t0:.1f} s")
    return against_plain(f"noisy full {key} real={n_real}", buf, args)


# -- phase 7 ----------------------------------------------------------------

def _record_keys(res):
    return [(r.pos, r.ref, r.alt, r.gt) for r in res.records]


def mp_executor(regions, work: str, threaded_rps: float) -> None:
    """The regions as per-region BAM + .npy jobs through MpRegionExecutor
    (8 children, two passes) against the in-process path."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io.bam import BamReader
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.pipeline.mp_exec import MpRegionExecutor
    from focalsv_tpu_torch.testing import simulate as sim
    cfg = preset("HIFI")
    os.makedirs(f"{work}/mp", exist_ok=True)
    jobs = []
    t0 = time.perf_counter()
    for i, rg in enumerate(regions):
        bam, ref = f"{work}/mp/r{i}.bam", f"{work}/mp/r{i}.npy"
        sim.write_region_bam(rg, bam)
        np.save(ref, rg.ref)
        jobs.append((bam, ref, rg.chrom))
    t1 = time.perf_counter()
    reset_counts()
    want = []
    for bam, ref, chrom in jobs:
        tile = dx.build_tile(list(BamReader(bam)), np.load(ref), 0, chrom,
                             cfg)
        dev = dx.run_device_step([tile], cfg, device=DEVICE)
        want.append(_record_keys(dx.process_region_device(tile, dev.get(0),
                                                          cfg)))
    t2 = time.perf_counter()
    log(f"[mp] {len(jobs)} region files written in {t1 - t0:.1f} s; "
        f"in-process path, one region at a time: {t2 - t1:.2f} s = "
        f"{len(jobs) / (t2 - t1):.3f} regions/s, "
        f"{sum(map(len, want))} records")
    t0 = time.perf_counter()
    with MpRegionExecutor(cfg, n_children=8, device=DEVICE) as ex:
        for n_pass in (1, 2):
            stats: dict = {}
            t1 = time.perf_counter()
            out = ex.run(jobs, collect="records", stats=stats)
            secs = time.perf_counter() - t1
            got = [_record_keys(res) for _n, res in out]
            log(f"[mp] pass {n_pass}: {len(jobs)} regions in {secs:.2f} s = "
                f"{len(jobs) / secs:.3f} regions/s with 8 children"
                + (f" ({time.perf_counter() - t0:.2f} s with their start)"
                   if n_pass == 1 else "")
                + f"; threaded run_target_mode in phase 6: "
                f"{threaded_rps:.3f} regions/s; records_equal={got == want} "
                f"n_chunks={stats['n_chunks']} "
                f"n_host_fallback={stats['n_host_fallback']} "
                f"children_with_cuda={stats['cuda_initialized']} "
                f"tile_build_s={stats['tile_build_s']:.2f} "
                f"finish_s={stats['finish_s']:.2f} "
                f"device_s={stats['device_s']:.4f}")
            if got != want:
                raise AssertionError("the multi-process executor's records "
                                     "differ from the in-process path")
            if stats["cuda_initialized"] != 0:
                raise AssertionError("a child of the executor initialised "
                                     "CUDA")
            if stats["n_chunks"] == 0:
                raise AssertionError("no chunk reached the region step")
    record_counts("mp_executor_parent")
    log(f"[mp] B2 launches in the parent (in-process path and both "
        f"passes): {region_cuda.launches}")
    if any(p.is_alive() for p in ex.procs):
        raise AssertionError("a child of the executor outlived close()")


# -- phase 8 ----------------------------------------------------------------

def complex_inputs(work: str) -> None:
    """One BAM with an inversion on chr21 and a translocation between chr1
    and chr2, a FASTA, a typed BED and an INS VCF whose first record is a
    tandem duplication."""
    from focalsv_tpu_torch.io.fasta import write_fasta
    from focalsv_tpu_torch.io.vcf import write_vcf
    from focalsv_tpu_torch.testing import complex_cases as cc
    d = f"{work}/complex"
    os.makedirs(d, exist_ok=True)
    ref, reads = cc.inversion_reads()
    rng = np.random.default_rng(77)
    others = [rng.integers(0, 4, 200_000).astype(np.uint8) for _ in range(2)]
    inv = cc.align_reads(ref, reads)
    for r in inv:
        r.ref_id = 2
    cc.write_bam(f"{d}/reads.bam", cc.translocation_records() + inv,
                 ["chr1", "chr2", "chr21"], [200_000, 200_000, len(ref)])
    write_fasta(f"{d}/ref.fa", [("chr1", others[0]), ("chr2", others[1]),
                                ("chr21", ref)])
    with open(f"{d}/typed.bed", "w") as f:
        f.write("chr21\t15000\t27000\tINV\n"
                "chr1\t95000\t105000\tTRA\n")
    write_vcf(f"{d}/ins.vcf", cc.dup_as_ins_records(ref=ref)[1])


def complex_run(work: str, tag: str, olc_out: str, fasta: str) -> None:
    """The complex-SV CLI in target mode on complex_inputs' files, and the
    contig DUP caller on the OLC run's contigs; VCFs under work/complex/tag.
    Runs on the card in the smoke run and on the CPU in its subprocess."""
    import io
    from contextlib import redirect_stdout

    from focalsv_tpu_torch.complexsv import cli as ccli
    from focalsv_tpu_torch.complexsv.target import call_dup_from_contigs
    from focalsv_tpu_torch.io.fasta import FastaFile
    from focalsv_tpu_torch.io.vcf import write_vcf
    d = f"{work}/complex"
    with redirect_stdout(io.StringIO()):
        rc = ccli.main(["--mode", "target", "--bam_file", f"{d}/reads.bam",
                        "--bed_file", f"{d}/typed.bed", "--ref_file",
                        f"{d}/ref.fa", "--indel_vcf", f"{d}/ins.vcf", "-d",
                        "HIFI", "-o", f"{d}/{tag}", "--min_support", "2"])
    if rc != 0:
        raise AssertionError(f"complexsv.cli returned {rc}")
    dups = call_dup_from_contigs(olc_out, FastaFile.load(fasta), "HIFI",
                                 min_support=1)
    write_vcf(f"{d}/{tag}/contig_dups.vcf", dups)


def complex_svs(work: str, olc_out: str, fasta: str) -> tuple[int, int]:
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    complex_inputs(work)
    t0 = time.perf_counter()
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--complex-cpu", work,
         olc_out, fasta],
        env=dict(os.environ, FOCALSV_TORCH_DEVICE="cpu",
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    # on the card every gap fill of the aligner takes the device route (the
    # CPU run keeps the host DP, whose results are the same bytes)
    cap = talign.NATIVE_DP_MAX_CELLS
    talign.NATIVE_DP_MAX_CELLS = 0
    align_cuda.reset_launches()
    try:
        complex_run(work, "card", olc_out, fasta)
    finally:
        talign.NATIVE_DP_MAX_CELLS = cap
        cpu_log = proc.communicate(timeout=600)[0]
    b1, b4 = align_cuda.launches, align_cuda.traceback_launches
    if proc.returncode != 0:
        raise AssertionError(f"the CPU run of phase 8 failed:\n"
                             f"{cpu_log[-3000:]}")
    same = {}
    types = ""
    for name in ("FocalSV_TRA_INV_DUP.vcf", "contig_dups.vcf"):
        with open(f"{work}/complex/card/{name}") as f:
            card = f.read()
        with open(f"{work}/complex/cpu/{name}") as f:
            same[name] = card == f.read()
        types += card
    found = {t: f"SVTYPE={t}" in types for t in ("INV", "TRA", "DUP")}
    log(f"[complex] target mode + contig DUPs in "
        f"{time.perf_counter() - t0:.2f} s: card VCF == CPU VCF {same}, "
        f"types called {found}, launches on this path: B1 {b1}, B4 {b4}")
    if not all(same.values()) or not all(found.values()) or not (b1 and b4):
        raise AssertionError("complex-SV phase failed")
    return b1, b4


# -- phase 9 ----------------------------------------------------------------

# kernel B6's FP32 instructions per cell the data needs (read row i <=
# read_len, haplotype column j <= hap_len): 7 expf and 3 logf (libdevice,
# some 8 and 20 instructions) and some 30 adds, maxima and selects
B6_OPS_PER_CELL = 150
# one FP32 instruction a lane a cycle: 67 TFLOP/s counts an FMA as two
FP32_INSTR_PER_S = 67e12 / 2
# phase 9b's HiFi run on the CPU takes the first 8 of phase 6's 32 regions
# (two of each size): the plain version there is the time limit's concern
N_PAIRHMM_CPU_REGIONS = 8
# (read, window) pairs a warp of B6 that phase 9c times on the path's
# calls beside the wrapper's choice
PAIRS_A_WARP = (1, 2, 4)
# kernel B6's launches, the windows they computed and the plain version's
# calls on each path that runs the pair-HMM, each read from its count, set
# to 0 just before the path
B6_LAUNCHES: dict = {}
B6_WINDOWS: dict = {}
B6_PLAIN_CALLS: dict = {}


def reset_b6_counts() -> None:
    """B6's counts and the plain version's to 0, just before a path (no
    thread of the port runs then)."""
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    pairhmm_cuda.reset_launches()
    pairhmm.plain_calls = 0


def record_b6_counts(path: str) -> None:
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    B6_LAUNCHES[path] = pairhmm_cuda.launches
    B6_WINDOWS[path] = pairhmm_cuda.windows
    B6_PLAIN_CALLS[path] = pairhmm.plain_calls


def b6_bound(case) -> tuple[float, str]:
    """The least time of B6 on this batch: its bytes (the reads, their
    emissions and lengths, each window and length, each result) over the
    memory rate against the cells the data needs times B6_OPS_PER_CELL over
    the FP32 instruction rate."""
    from focalsv_tpu_torch.benches.bench import HBM_BYTES_PER_S
    M = case["max_read"]
    B = len(case["read_lens"])
    rl = np.clip(case["read_lens"].astype(np.int64), 0, M)
    cells = sum(int((rl * np.clip(hl.astype(np.int64), 0, hap.shape[1])
                     ).sum()) for hap, hl in case["haps"])
    nbytes = B * M * (1 + 2 * 4) + 4 * B + sum(
        B * hap.shape[1] + 8 * B for hap, _ in case["haps"])
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = cells * B6_OPS_PER_CELL / FP32_INSTR_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def profiled_launches(fn, must_show: str | None = None) -> int | None:
    """Kernel launches and copies of one call of fn on the card
    (torch.profiler); a profile that does not list ``must_show`` (or lists
    nothing) is taken again, up to PROFILE_TRIES times (see
    profile_chunk), and None when none does: the count is a measurement,
    and the kernel's own count shows that it launched."""
    from torch.profiler import ProfilerActivity, profile
    for _ in range(PROFILE_TRIES):
        sync()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            fn()
            sync()
        rows = [(e.key, e.count) for e in prof.key_averages()
                if e.self_device_time_total > 0
                and str(getattr(e, "device_type", "")).endswith("CUDA")]
        if rows and (must_show is None
                     or any(must_show in k for k, _n in rows)):
            return sum(n for _k, n in rows)
    log(f"[profile] torch.profiler recorded no launch"
        f"{f' of {must_show}' if must_show else ''} in {PROFILE_TRIES} "
        f"tries")
    return None


def b6_entry(case: dict):
    """B6's entry from the numpy inputs as the realignment calls it
    (site_allele_loglik: copy in, B6, copy out)."""
    from focalsv_tpu_torch.ops import pairhmm
    (ref, rhl), (alt, ahl) = case["haps"]
    return pairhmm.site_allele_loglik(
        case["reads"], case["read_lens"], ref, rhl, alt, ahl, case["quals"],
        device=DEVICE, **case["gaps"])


def b6_entry_counted(case: dict) -> int:
    """Launches and copies of one call of B6's entry, from the wrappers'
    counts: B6's launches and the entry's copies between host and card.
    Fails if the call built an emission table (a launch that no count
    sees): every call after the device's first finds it built."""
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    tables = len(pairhmm._tables)
    launches, copies = pairhmm_cuda.launches, pairhmm.copies
    b6_entry(case)
    if len(pairhmm._tables) != tables:
        raise AssertionError("B6's entry built an emission table again")
    return (pairhmm_cuda.launches - launches) + (pairhmm.copies - copies)


def b6_against_plain(name: str, case: dict, timed: bool) -> dict:
    """B6 against its plain version on the card, both from the same numpy
    inputs: the terms byte for byte, the results within 1e-5 (B6 sums the
    terms in another order than torch.sum), -inf at the same places.
    ``timed``: ms of the wrapper's calls on the inputs already on the card
    (back to back, and queued behind a sleep of the stream), of the plain
    version's calls (a call a haplotype, from the numpy inputs), in turns;
    the bound; the launches and copies of one call of B6's entry from the
    numpy inputs (b6_entry: copy in, B6, copy out), from the wrappers'
    counts (must be 3) and from torch.profiler (may lose or cut the
    record), and of the plain version's call (torch.profiler)."""
    from focalsv_tpu_torch.benches.bench import time_ms
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    from focalsv_tpu_torch.testing import pairhmm_cases
    before = pairhmm_cuda.launches
    got = pairhmm_cases.kernel(case, DEVICE)
    one_launch = pairhmm_cuda.launches == before + 1
    d = pairhmm_cases.differences(got, pairhmm_cases.plain(case, DEVICE))
    widths = [hap.shape[1] for hap, _ in case["haps"]]
    row = dict(case=name, B=len(case["read_lens"]), M=case["max_read"],
               N=widths, max_abs_err=d["out_err"], **d)
    timing = ""
    if timed:
        args = pairhmm.kernel_inputs(
            case["reads"], case["read_lens"],
            [(hap, hl, hap.shape[1]) for hap, hl in case["haps"]],
            case["quals"], case["max_read"], DEVICE, **case["gaps"])

        def kernel():
            return pairhmm_cuda.pairhmm_cuda(*args)

        def plain():
            return pairhmm_cases.plain(case, DEVICE)

        kernel()
        k1, p1 = time_ms(kernel, 20), time_ms(plain, 1)
        p2, k2 = time_ms(plain, 1), time_ms(kernel, 20)
        queued = time_ms(kernel, 20, queued=True)
        bound, by = b6_bound(case)
        row.update(
            ms=(k1 + k2) / 2, queued_ms=queued, plain_ms=(p1 + p2) / 2,
            bound_ms=bound, bound_by=by,
            pairs_per_warp=pairhmm_cuda.choose_pairs_per_warp(row["B"]),
            entry_launches=b6_entry_counted(case),
            entry_launches_profiled=profiled_launches(
                lambda: b6_entry(case), "pairhmm_kernel"),
            plain_launches=profiled_launches(plain))
        timing = (f" kernel_ms={k1:.4f},{k2:.4f} queued_ms={queued:.4f} "
                  f"plain_ms={p1:.2f},{p2:.2f} bound_ms={bound:.4f} "
                  f"bound_by={by} share_of_bound={bound / queued:.3f} "
                  f"(queued) pairs a warp {row['pairs_per_warp']}; "
                  f"launches and copies a call: B6's entry "
                  f"{row['entry_launches']} (the wrappers' counts), "
                  f"{row['entry_launches_profiled']} (torch.profiler; None: "
                  f"not recorded), plain {row['plain_launches']} "
                  f"(torch.profiler)")
    log(f"[b6] {name}: B={row['B']} M={row['M']} N={widths} terms "
        f"byte-equal={d['terms_bytes_equal']} -inf at the same places="
        f"{d['same_inf']} max_abs_err={d['out_err']:.3g} (tolerance 1e-5) "
        f"one launch of B6: {one_launch}" + timing)
    if not (d["terms_bytes_equal"] and d["same_inf"]
            and d["out_err"] <= 1e-5 and one_launch):
        raise AssertionError(f"B6 differs from its plain version ({name})")
    # the profiler may lose or cut a record, never add one
    if timed and (row["entry_launches"] != 3
                  or (row["entry_launches_profiled"] or 0) > 3):
        raise AssertionError(
            f"B6's entry took {row['entry_launches']} launches and copies "
            f"by the wrappers' counts, {row['entry_launches_profiled']} by "
            f"torch.profiler, not 3 ({name})")
    return row


def emission_table_check() -> None:
    """B6's emission table on the card, indexed by the clamped quality,
    against the plain version's elementwise emissions on the card, byte for
    byte, for every int32 quality in [-50, 400)."""
    from focalsv_tpu_torch.ops import pairhmm
    rng = np.random.default_rng(4)
    q = rng.integers(-50, 400, (997, 29)).astype(np.int32)
    q.ravel()[: 450] = np.arange(-50, 400)
    lm_match, lm_mis = pairhmm._emissions(q, *q.shape, DEVICE)
    table = pairhmm.emission_table(DEVICE)
    idx = torch.from_numpy(pairhmm.qual_bytes(q, *q.shape).astype(
        np.int64)).to(DEVICE)
    same = (torch.equal(table[0][idx], lm_match)
            and torch.equal(table[1][idx], lm_mis))
    log(f"[b6] emission table (2, 256) against the elementwise emissions "
        f"on the card, qualities -50..399 on a (997, 29) array: byte-equal "
        f"{same}")
    if not same:
        raise AssertionError("B6's emission table differs from the "
                             "elementwise emissions on the card")


def pairhmm_phase() -> list[dict]:
    """Phase 9a: B6 against its plain version on the card, on every case of
    the CPU tests and at phase 9's shapes (timed); the emission table
    against the elementwise emissions; the forward pass of one haplotype
    by the host clock, copies included."""
    from focalsv_tpu_torch.ops import pairhmm
    from focalsv_tpu_torch.testing import pairhmm_cases
    emission_table_check()
    rows = [b6_against_plain(name, pairhmm_cases.build(name), False)
            for name in sorted(pairhmm_cases.CASES)]
    rows += [b6_against_plain(name, build(9), True)
             for name, build in pairhmm_cases.CARD_SHAPES.items()]
    case = pairhmm_cases.CARD_SHAPES["realign_B4000"](9)
    ref, hl = case["haps"][0]
    args = (case["reads"], case["read_lens"], ref, hl, case["quals"])
    kw = dict(max_read=29, max_hap=29, device=DEVICE)
    pairhmm.pairhmm_forward_batch(*args, **kw)
    t0 = time.perf_counter()
    pairhmm.pairhmm_forward_batch(*args, **kw)
    card_ms = (time.perf_counter() - t0) * 1e3
    log(f"[b6] forward pass of one haplotype, B=4000 L=29, by the host "
        f"clock with copies included: {card_ms:.2f} ms")
    return rows


def pairhmm_cpu_run(args) -> None:
    """Phase 9b's runs on the CPU (the plain version), in the subprocess
    that the smoke run starts: the HiFi regions, then the noisy ones."""
    hifi_bam, hifi_fa, hifi_bed, hifi_out, bam, fa, bed, out = args
    run_mode(hifi_bam, hifi_fa, hifi_bed, hifi_out, "guided", "device",
             N_PAIRHMM_CPU_REGIONS, pairhmm=True)
    run_mode(bam, fa, bed, out, "guided", "device", N_NOISY_REGIONS,
             dtype="ONT", pairhmm=True)


@contextlib.contextmanager
def plain_realignment(record: list):
    """The yardstick of phase 9b: the realignment as it ran before B6, the
    plain version's two calls a region (ref and alt windows) on the card.
    Each call's inputs go to ``record`` as a case of
    testing/pairhmm_cases.py (phase 9c times B6 on them)."""
    from focalsv_tpu_torch.ops import pairhmm
    from focalsv_tpu_torch.phasing import realign

    def two_calls(read_segs, seg_lens, ref_windows, window_lens_ref,
                  alt_windows, window_lens_alt, quals=None):
        record.append(dict(
            reads=read_segs.copy(), read_lens=seg_lens.copy(),
            quals=None if quals is None else quals.copy(),
            haps=[(ref_windows.copy(), window_lens_ref.copy()),
                  (alt_windows.copy(), window_lens_alt.copy())],
            max_read=read_segs.shape[1],
            gaps=dict(gap_open=1e-3, gap_extend=0.1)))
        return tuple(pairhmm.pairhmm_forward_batch_plain(
            read_segs, seg_lens, hap, lens, quals,
            max_read=read_segs.shape[1], max_hap=hap.shape[1],
            device=DEVICE) for hap, lens in ((ref_windows, window_lens_ref),
                                             (alt_windows, window_lens_alt)))

    kernel = realign.site_allele_loglik
    realign.site_allele_loglik = two_calls
    try:
        yield
    finally:
        realign.site_allele_loglik = kernel


def pairhmm_slice(work: str, main_path: dict, noisy: dict) -> list:
    """Phase 9b: run_target_mode with use_pairhmm=True in device execution
    on the card, on phase 6's 32 HiFi regions (timed alone, B6's runs in
    turns with one through the plain version on the card) and phase 6b's 8
    noisy regions; the same runs on the CPU in a subprocess (the HiFi run
    on the first 8 regions, which the card runs too): equal VCFs, B6
    launched and the plain version never called on the card."""
    d = f"{work}/pairhmm"
    os.makedirs(d)
    with open(main_path["bed"]) as f:
        lines = f.read().splitlines()
    bed8 = f"{d}/regions_{N_PAIRHMM_CPU_REGIONS}.bed"
    with open(bed8, "w") as f:
        f.write("".join(f"{ln}\n" for ln in lines[:N_PAIRHMM_CPU_REGIONS]))
    n_all = len(lines)
    reset_b6_counts()
    full, full_stats, full_rec = run_mode(
        main_path["bam"], main_path["fasta"], main_path["bed"],
        f"{d}/hifi_card", "guided", "device", n_all, pairhmm=True)
    record_b6_counts("pairhmm_target_mode_hifi")
    traffic: list = []
    with plain_realignment(traffic):
        plain, plain_stats, _ = run_mode(
            main_path["bam"], main_path["fasta"], main_path["bed"],
            f"{d}/hifi_card_plain", "guided", "device", n_all, pairhmm=True)
    reset_b6_counts()
    again, again_stats, _ = run_mode(
        main_path["bam"], main_path["fasta"], main_path["bed"],
        f"{d}/hifi_card_again", "guided", "device", n_all, pairhmm=True)
    record_b6_counts("pairhmm_target_mode_hifi_again")
    proc = subprocess.Popen(
        [sys.executable, os.path.abspath(__file__), "--pairhmm-cpu",
         main_path["bam"], main_path["fasta"], bed8, f"{d}/hifi_cpu",
         noisy["bam"], noisy["fasta"], noisy["bed"], f"{d}/noisy_cpu"],
        env=dict(os.environ, FOCALSV_TORCH_DEVICE="cpu",
                 CUDA_VISIBLE_DEVICES=""),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    t0 = time.perf_counter()
    try:
        reset_b6_counts()
        hifi, _, hifi_rec = run_mode(
            main_path["bam"], main_path["fasta"], bed8, f"{d}/hifi8_card",
            "guided", "device", N_PAIRHMM_CPU_REGIONS, pairhmm=True)
        record_b6_counts("pairhmm_target_mode_hifi_8")
        reset_b6_counts()
        nz, nz_stats, nz_rec = run_mode(
            noisy["bam"], noisy["fasta"], noisy["bed"], f"{d}/noisy_card",
            "guided", "device", N_NOISY_REGIONS, dtype="ONT", pairhmm=True)
        record_b6_counts("pairhmm_target_mode_noisy")
    finally:
        cpu_log = proc.communicate(timeout=900)[0]
    cpu_s = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"phase 9b's CPU run failed:\n"
                             f"{cpu_log[-3000:]}")
    with open(f"{d}/hifi_cpu/FocalSV_Final_SV.vcf") as f:
        hifi_cpu = f.read()
    with open(f"{d}/noisy_cpu/FocalSV_Final_SV.vcf") as f:
        nz_cpu = f.read()
    paths = list(B6_LAUNCHES)
    windows = B6_WINDOWS["pairhmm_target_mode_hifi"] // 2
    log(f"[pairhmm] HiFi use_pairhmm=True device on the card: "
        f"{n_all / full_stats['wall_s']:.3f} regions/s ({n_all} regions, "
        f"{full_rec} records, finish_s={full_stats['finish_s']:.3f} "
        f"n_host_fallback={full_stats['n_host_fallback']}) beside phase 6's "
        f"guided device run without the pair-HMM "
        f"{main_path['guided_rps']:.3f} regions/s; {windows} read windows, "
        f"{windows / n_all:.0f} a region, in "
        f"{B6_LAUNCHES['pairhmm_target_mode_hifi']} launches of B6; noisy "
        f"(ONT) {N_NOISY_REGIONS / nz_stats['wall_s']:.3f} regions/s "
        f"({nz_rec} records, beside the CPU run)")
    log(f"[pairhmm] HiFi use_pairhmm=True in turns: B6 "
        f"{n_all / full_stats['wall_s']:.3f} regions/s finish_s="
        f"{full_stats['finish_s']:.3f}; the plain version on the card (two "
        f"calls a region, as before B6) {n_all / plain_stats['wall_s']:.3f} "
        f"regions/s finish_s={plain_stats['finish_s']:.3f}, VCF equal to "
        f"B6's: {plain == full}; B6 again "
        f"{n_all / again_stats['wall_s']:.3f} regions/s finish_s="
        f"{again_stats['finish_s']:.3f}, VCF equal: {again == full}")
    log(f"[pairhmm] launches of B6 by path {json.dumps(B6_LAUNCHES)}, "
        f"windows {json.dumps(B6_WINDOWS)}, calls of the plain version "
        f"{json.dumps(B6_PLAIN_CALLS)}; the CPU runs (the HiFi run on the "
        f"first {N_PAIRHMM_CPU_REGIONS} of the {n_all} regions, two of each "
        f"size, to keep the plain version within the time limit; then the "
        f"noisy run) ended {cpu_s:.1f} s after they were started")
    checks = {
        f"HiFi card VCF == CPU VCF ({N_PAIRHMM_CPU_REGIONS} regions)":
            hifi == hifi_cpu,
        "noisy card VCF == CPU VCF": nz == nz_cpu,
        "records > 0": min(full_rec, hifi_rec, nz_rec) > 0,
        "B6 launches > 0 on every path": all(B6_LAUNCHES[p] > 0
                                             for p in paths),
        "the plain version not called on the card": all(
            B6_PLAIN_CALLS[p] == 0 for p in paths),
    }
    for name, ok in checks.items():
        log(f"[pairhmm] check {name}: {ok}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"pair-HMM slice checks failed: {failed}")
    if len(traffic) != B6_LAUNCHES["pairhmm_target_mode_hifi"]:
        raise AssertionError(f"the plain run made {len(traffic)} calls, B6's "
                             f"run {B6_LAUNCHES['pairhmm_target_mode_hifi']}")
    return traffic


def b6_lane_steps(args, pairs: int, K: int | None = None) -> float:
    """Lane-steps a pair that B6 took in one launch on these inputs (its
    counter: 32 times each warp's steps, idle lanes included), at K pairs
    a warp (the wrapper's choice when None)."""
    from focalsv_tpu_torch.ops import pairhmm_cuda
    counted = torch.zeros(1, dtype=torch.int64, device=DEVICE)
    pairhmm_cuda.pairhmm_cuda(*args, pairs_per_warp=K, lane_steps=counted)
    return int(counted.item()) / pairs


def b6_on_path_traffic(traffic: list) -> tuple[list[dict], dict]:
    """Phase 9c: B6 on the inputs that the realignment handed it in 9b's
    HiFi run, one call a region.  Each call is held to the plain version as
    in 9a (terms byte for byte, results within 1e-5, -inf at the same
    places, one launch) and timed: its launch back to back and queued
    behind a sleep of the stream (20 calls each), queued again with each
    of PAIRS_A_WARP pairs a warp, and the entry from the numpy inputs
    (site_allele_loglik: copy in, B6, copy out; 5 calls, CUDA events, the
    host's time inside), whose launches and copies the wrappers' counts
    hold to 3.  The region of median windows is also timed as 9a times its
    shapes, and B6's lane-steps counted there: the kernels line's headline.
    Returns its row and a summary of the run's calls."""
    from focalsv_tpu_torch.benches.bench import time_ms
    from focalsv_tpu_torch.ops import pairhmm, pairhmm_cuda
    from focalsv_tpu_torch.testing import pairhmm_cases
    sizes = [len(c["read_lens"]) for c in traffic]
    median = sorted(range(len(traffic)), key=sizes.__getitem__)[
        len(traffic) // 2]
    head = b6_against_plain("path_median_region", traffic[median], True)
    calls = []
    for k, case in enumerate(traffic):
        before = pairhmm_cuda.launches
        got = pairhmm_cases.kernel(case, DEVICE)
        one_launch = pairhmm_cuda.launches == before + 1
        d = pairhmm_cases.differences(got, pairhmm_cases.plain(case, DEVICE))
        if not (d["terms_bytes_equal"] and d["same_inf"]
                and d["out_err"] <= 1e-5 and one_launch):
            raise AssertionError(f"B6 differs from its plain version on the "
                                 f"path's call {k}: {d}")
        args = pairhmm.kernel_inputs(
            case["reads"], case["read_lens"],
            [(hap, hl, hap.shape[1]) for hap, hl in case["haps"]],
            case["quals"], case["max_read"], DEVICE, **case["gaps"])

        def launch(K=None):
            return pairhmm_cuda.pairhmm_cuda(*args, pairs_per_warp=K)

        launch()
        entry_launches = b6_entry_counted(case)
        if entry_launches != 3:
            raise AssertionError(f"B6's entry took {entry_launches} launches "
                                 f"and copies on the path's call {k}, not 3")
        calls.append(dict(
            B=sizes[k], err=d["out_err"], ms=time_ms(launch, 20),
            queued_ms=time_ms(launch, 20, queued=True),
            queued_ms_by_pairs_a_warp={
                K: time_ms(lambda: launch(K), 20, queued=True)
                for K in PAIRS_A_WARP},
            entry_ms=time_ms(lambda: b6_entry(case), 5),
            entry_launches=entry_launches, bound_ms=b6_bound(case)[0]))
        if k == median:
            pairs = sizes[k] * len(case["haps"])
            lanes = dict(
                measured=b6_lane_steps(args, pairs),
                by_pairs_a_warp={K: b6_lane_steps(args, pairs, K)
                                 for K in PAIRS_A_WARP},
                modelled=pairhmm_cases.lane_steps(
                    case["read_lens"], [hl for _h, hl in case["haps"]],
                    case["max_read"], [h.shape[1] for h, _ in case["haps"]],
                    pairhmm_cuda.choose_pairs_per_warp(sizes[k])) / pairs)
    reads = np.concatenate([c["read_lens"] for c in traffic])
    wins = np.concatenate([hl for c in traffic for _h, hl in c["haps"][:1]])
    largest = max(calls, key=lambda c: c["B"])

    def spread(key):
        v = sorted(c[key] for c in calls)
        return dict(min=v[0], median=v[len(v) // 2], max=v[-1])

    fastest = [(c["B"], min(PAIRS_A_WARP,
                            key=c["queued_ms_by_pairs_a_warp"].__getitem__))
               for c in sorted(calls, key=lambda c: c["B"])]
    summary = dict(
        regions=len(calls), windows_a_region=dict(
            mean=float(np.mean(sizes)), **spread("B")),
        read_lens=dict(zip(*map(np.ndarray.tolist,
                                np.unique(reads, return_counts=True)))),
        window_lens=dict(zip(*map(np.ndarray.tolist,
                                  np.unique(wins, return_counts=True)))),
        launch_ms=spread("ms"), queued_ms=spread("queued_ms"),
        entry_ms=spread("entry_ms"), bound_ms=spread("bound_ms"),
        largest_region=largest,
        # B6's card time for the run's calls, and the entries' time
        card_ms_a_run=sum(c["queued_ms"] for c in calls),
        back_to_back_ms_a_run=sum(c["ms"] for c in calls),
        entry_ms_a_run=sum(c["entry_ms"] for c in calls),
        bound_ms_a_run=sum(c["bound_ms"] for c in calls),
        # the pairs a warp: the wrapper's choice against fixed ones, queued
        card_ms_a_run_by_pairs_a_warp={
            K: sum(c["queued_ms_by_pairs_a_warp"][K] for c in calls)
            for K in PAIRS_A_WARP},
        median_queued_ms_by_pairs_a_warp=calls[median][
            "queued_ms_by_pairs_a_warp"],
        # counted by B6 at the median call, with the wrapper's choice
        lane_steps_a_pair=lanes["measured"])
    log(f"[b6-path] 9b's HiFi run handed B6 {len(calls)} calls, windows a "
        f"call {json.dumps(summary['windows_a_region'])}; read lengths "
        f"(bases: windows) {json.dumps(summary['read_lens'])}, window "
        f"lengths {json.dumps(summary['window_lens'])}; all held to the "
        f"plain version (terms byte for byte, max_abs_err "
        f"{max(c['err'] for c in calls):.3g})")
    log(f"[b6-path] a launch, ms back to back "
        f"{json.dumps(summary['launch_ms'])}, queued "
        f"{json.dumps(summary['queued_ms'])}, bound "
        f"{json.dumps(summary['bound_ms'])}; the entry from numpy "
        f"(copies, CUDA events) "
        f"{json.dumps(summary['entry_ms'])}; the largest call "
        f"{json.dumps(largest)}; over the run's {len(calls)} calls: B6 "
        f"{summary['card_ms_a_run']:.4f} ms queued, "
        f"{summary['back_to_back_ms_a_run']:.4f} back to back, bound "
        f"{summary['bound_ms_a_run']:.4f}, entries "
        f"{summary['entry_ms_a_run']:.3f} ms")
    by_k = summary["median_queued_ms_by_pairs_a_warp"]
    K = pairhmm_cuda.choose_pairs_per_warp(sizes[median])
    log(f"[b6-path] pairs a warp (queued): the run's calls "
        f"{json.dumps(summary['card_ms_a_run_by_pairs_a_warp'])} ms, the "
        f"median call {json.dumps(by_k)} ms, the wrapper chose {K} there; "
        f"the fastest of {list(PAIRS_A_WARP)} by call (B, pairs a warp) "
        f"{json.dumps(fastest)}")
    log(f"[b6-path] lane-steps a pair at the median call, counted by B6: "
        f"{lanes['measured']:.1f} at {K} pairs a warp, by pairs a warp "
        f"{json.dumps(lanes['by_pairs_a_warp'])}; modelled "
        f"(pairhmm_cases.lane_steps) {lanes['modelled']:.1f}")
    return [head], summary


# -- phase 10 ---------------------------------------------------------------

def evaluation_phase(regions, work: str, call_vcf: str) -> None:
    import io
    from contextlib import redirect_stdout

    from focalsv_tpu_torch.evaluation import cli as ecli
    from focalsv_tpu_torch.evaluation.compare import truth_from_sim
    from focalsv_tpu_torch.io.vcf import write_vcf
    offs = np.cumsum([0] + [len(rg.ref) for rg in regions])
    truth = []
    for i, rg in enumerate(regions):
        for rec in truth_from_sim(rg.svs, "chr21", rg.ref):
            rec.pos += int(offs[i])
            truth.append(rec)
    write_vcf(f"{work}/truth.vcf", truth)
    buf = io.StringIO()
    with redirect_stdout(buf):
        rc = ecli.main(["bench", "--call", call_vcf, "--truth",
                        f"{work}/truth.vcf"])
    res = json.loads(buf.getvalue())
    log("[eval] guided device VCF against the simulation's truth: "
        + ", ".join(f"{t} tp={v['tp']} fp={v['fp']} fn={v['fn']} "
                    f"F1={v['f1']}" for t, v in sorted(res.items())
                    if isinstance(v, dict) and "f1" in v))
    f1s = [v["f1"] for v in res.values() if isinstance(v, dict) and "f1" in v]
    if rc != 0 or not f1s or min(f1s) < 0.5:
        raise AssertionError(f"evaluation phase failed: {res}")


# -- phase 11 ---------------------------------------------------------------

RANK_TIMEOUT_S = 420


def smoke_mesh():
    """A mesh of every card present; two logical shards of the one card
    when there is one."""
    from focalsv_tpu_torch.parallel.mesh import make_mesh
    cards = torch.cuda.device_count()
    if cards >= 2:
        mesh = make_mesh()
        log(f"[mesh] {mesh!r}: one shard on each of the {cards} cards")
    else:
        mesh = make_mesh(devices=[torch.device("cuda", 0)] * 2)
        log(f"[mesh] {mesh!r}: this machine has one card, so the mesh is two "
            "logical shards of it, each with a stream of its own")
    return mesh


def time_pending_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() -> PendingResult by CUDA events on the
    current stream, which waits for the result's own events (a sharded
    result's copies run on the shards' streams)."""
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    stream = torch.cuda.current_stream()
    start.record()
    for _ in range(reps):
        for e in fn().events:
            stream.wait_event(e)
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def sharded_region_steps(jobs, mesh) -> None:
    """Every chunk of phase 4 at the mesh's batch size: the sharded step
    against the unsharded one, byte for byte.  B2's launches are counted on
    one sharded pass over the chunks (one a shard of each delta chunk)."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.pipeline import device_exec as dx
    chunks = list(region_chunks(jobs, mesh.size))
    reset_counts()
    firsts = [np.asarray(dx.dispatch_packed(buf, key, G, cfg, None, mesh))
              for cfg, key, G, _n, buf in chunks]
    record_counts("sharded_region_step")
    n_delta = sum(key[0] == "delta" for _c, key, *_ in chunks)
    n_dense = len(chunks) - n_delta
    log(f"[mesh] launches on one sharded pass over {len(chunks)} chunks: "
        f"B2 {region_cuda.launches} ({n_delta} delta chunks x {mesh.size} "
        f"shards), B3 {region_cuda.rows_launches} ({n_dense} dense chunks "
        f"x {mesh.size} shards)")
    if (region_cuda.launches != n_delta * mesh.size
            or region_cuda.rows_launches != n_dense * mesh.size):
        raise AssertionError("the sharded step did not launch B2 and B3 "
                             "once per shard of each chunk")
    for (cfg, key, G, n_real, buf), got in zip(chunks, firsts):
        def one():
            return dx.dispatch_packed(buf, key, G, cfg, DEVICE)

        def sharded():
            return dx.dispatch_packed(buf, key, G, cfg, None, mesh)

        want = np.asarray(one())
        same = got.shape == want.shape and np.array_equal(got, want)
        ms_one = time_pending_ms(one, 2)
        ms_sharded = time_pending_ms(sharded, 2)
        again = np.array_equal(np.asarray(sharded()), want)
        log(f"[mesh] region step {key} G={G} real={n_real} over "
            f"{mesh.size} shards: bytes_equal={same and again} "
            f"sharded_ms_per_chunk={ms_sharded:.1f} "
            f"unsharded_ms_per_chunk={ms_one:.1f}")
        if not (same and again):
            raise AssertionError(f"the sharded region step differs from the "
                                 f"unsharded one for bucket {key}")


def sharded_dp(rng, mesh) -> tuple[int, int]:
    """sharded_banded_align at the OLC-polish shape and
    sharded_sv_candidate_step against the unsharded B1 and the plain
    version; returns B1's and B4's launches on the sharded path with the
    dry run (B1: one per shard and sharded call)."""
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    from focalsv_tpu_torch.parallel import mesh as pmesh
    from focalsv_tpu_torch.testing import dryrun
    from focalsv_tpu_torch.testing.dp_cases import dp_pairs
    B = 4 * mesh.size
    polish = dp_pairs(rng, B, 16384, 512, 12000, leading_ins=False, edge=True)
    fill = dp_pairs(rng, B, 1024, 128, 300, leading_ins=False, edge=True)
    # the path: counts at 0, the sharded calls and the dry run, counts read
    align_cuda.reset_launches()
    t0 = time.perf_counter()
    s_sh, d_sh = pmesh.sharded_banded_align(*polish, mesh=mesh, band=512,
                                            **OLC_SCORING)
    sync()
    sharded_s = time.perf_counter() - t0
    scores, cand, global_cand = pmesh.sharded_sv_candidate_step(*fill,
                                                                mesh=mesh)
    sync()
    launches_dp = align_cuda.launches
    reset_counts()
    t0 = time.perf_counter()
    dryrun.dryrun_multichip(mesh.size, devices=list(mesh.devices))
    record_counts("dry_run")
    log(f"[mesh] dryrun_multichip on {mesh!r}: passed in "
        f"{time.perf_counter() - t0:.2f} s")
    launches = align_cuda.launches
    tb = align_cuda.traceback_launches
    # the comparisons (their launches are not the path's)
    args = [torch.from_numpy(a).to(DEVICE) for a in polish]
    s_k, d_k = align_cuda.banded_align_batch_cuda(*args, band=512,
                                                  **OLC_SCORING)
    s_p, d_p = talign.banded_align_batch(*args, band=512, **OLC_SCORING)
    sync()
    dev0 = mesh.devices[0]
    err_k = max(int((s_sh.to(dev0).long() - s_k.to(dev0).long()).abs().max()),
                int((d_sh.to(dev0).int() - d_k.to(dev0).int()).abs().max()))
    err_p = max(int((s_sh.to(dev0).long() - s_p.to(dev0).long()).abs().max()),
                int((d_sh.to(dev0).int() - d_p.to(dev0).int()).abs().max()))
    del d_sh, d_k, d_p
    fargs = [torch.from_numpy(a).to(DEVICE) for a in fill]
    fs_p, fd_p = talign.banded_align_batch(*fargs, band=128)
    hdir = fd_p & talign.DIR_H_MASK
    want = torch.stack([fs_p, (hdir == 1).sum(dim=(1, 2), dtype=torch.int32),
                        (hdir == 2).sum(dim=(1, 2), dtype=torch.int32)], 1)
    cand_same = (torch.equal(cand.to(dev0), want.to(dev0))
                 and torch.equal(scores.to(dev0), fs_p.to(dev0))
                 and len(global_cand) == mesh.size
                 and all(torch.equal(c.to(dev0), want.to(dev0))
                         and c.device == d
                         for c, d in zip(global_cand, mesh.devices)))
    log(f"[mesh] sharded_banded_align B={B} Lq=16384 W=512 dirs=True over "
        f"{mesh.size} shards: max_abs_err vs unsharded B1 {err_k}, vs the "
        f"plain version {err_p}; {sharded_s * 1e3:.1f} ms by the host clock, "
        f"copies from the host included")
    log(f"[mesh] sharded_sv_candidate_step B={B} Lq=1024 W=128: scores, D/I "
        f"counts and every shard's copy of the table equal the plain "
        f"version's: {cand_same}")
    log(f"[mesh] launches on the sharded DP path: B1 {launches} "
        f"({launches_dp} by the two sharded calls = 2 x {mesh.size} shards, "
        f"{launches - launches_dp} by the dry run), B4 {tb}")
    if err_k or err_p or not cand_same or launches_dp != 2 * mesh.size:
        raise AssertionError("the sharded DP differs from the unsharded one "
                             "or did not launch B1 once per shard")
    return launches, tb


def run_ranks(commands, envs) -> tuple[list[str], float]:
    """One process per command; all must exit 0 within RANK_TIMEOUT_S.  Every
    one of them is killed when one fails or the limit passes.  Returns
    their outputs and the wall seconds."""
    t0 = time.perf_counter()
    procs = [subprocess.Popen(cmd, cwd=ROOT, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd, env in zip(commands, envs)]
    outputs = [""] * len(procs)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        pending = set(range(len(procs)))
        while pending:
            for i in sorted(pending):
                if procs[i].poll() is not None:
                    outputs[i] = procs[i].communicate()[0]
                    pending.discard(i)
                    if procs[i].returncode != 0:
                        raise AssertionError(f"rank {i} failed:\n"
                                             f"{outputs[i][-3000:]}")
            if time.monotonic() > deadline:
                raise AssertionError("the ranks timed out")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outputs, time.perf_counter() - t0


def two_ranks(main_path, work: str) -> None:
    """Two dist_worker ranks in device mode on phase 6's BED through the
    collective gather, against the file merge of two in-process hosts."""
    import socket
    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io.vcf import read_vcf
    from focalsv_tpu_torch.pipeline import main
    cards = torch.cuda.device_count()
    backend = "nccl" if cards >= 2 else "gloo"
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    out = f"{work}/ranks"
    cmds, envs = [], []
    for rank in range(2):
        cmds.append([sys.executable, "-m",
                     "focalsv_tpu_torch.testing.dist_worker", "--pid",
                     str(rank), "--nprocs", "2", "--port", str(port), "--bam",
                     main_path["bam"], "--ref", main_path["fasta"], "--bed",
                     main_path["bed"], "--out", out, "--device", "cuda",
                     "--backend", backend])
        env = dict(os.environ, PYTHONPATH=ROOT, FOCALSV_MERGE_TIMEOUT_S="120")
        if cards >= 2:
            env["CUDA_VISIBLE_DEVICES"] = str(rank)    # a card a rank
        envs.append(env)
    outputs, secs = run_ranks(cmds, envs)
    gathered = next((ln.split("] ", 1)[-1] for ln in outputs[0].splitlines()
                     if "bytes on the wire" in ln), "")
    collective = "final VCF (collective gather)" in outputs[0]
    _, dist_recs = read_vcf(f"{out}/FocalSV_Final_SV.vcf")
    # the file-merge branch on the same input: two hosts as threads of this
    # process, no process group
    os.environ["FOCALSV_MERGE_TIMEOUT_S"] = "120"
    try:
        t0 = time.perf_counter()
        with ThreadPoolExecutor(max_workers=2) as ex:
            futs = [ex.submit(main.run_target_mode, main_path["bam"],
                              main_path["fasta"], f"{work}/hosts",
                              preset("HIFI"), target_bed=main_path["bed"],
                              process_index=i, process_count=2)
                    for i in range(2)]
            merged = futs[0].result(timeout=RANK_TIMEOUT_S)
            futs[1].result(timeout=RANK_TIMEOUT_S)
        merge_s = time.perf_counter() - t0
    finally:
        del os.environ["FOCALSV_MERGE_TIMEOUT_S"]
    _, merge_recs = read_vcf(merged)
    same = ([r.to_line() for r in dist_recs]
            == [r.to_line() for r in merge_recs])
    where = ("a card each" if cards >= 2 else
             "both on the one card: two NCCL ranks cannot share a card")
    log(f"[ranks] 2 dist_worker ranks over {backend} ({where}), device "
        f"mode, {N_REGIONS} regions: {secs:.2f} s wall with their start; "
        f"rank 0 took the collective branch: {collective}; {gathered}; "
        f"{len(dist_recs)} records, equal to the file-merge branch's "
        f"({merge_s:.2f} s, two in-process hosts): {same}")
    if not (collective and same and dist_recs and gathered):
        raise AssertionError("the two-rank run failed:\n"
                             + outputs[0][-2000:])


def nccl_single(main_path) -> None:
    """NCCL on the card at world size 1: join, all_gather phase 6's record
    payload, leave."""
    import socket

    from focalsv_tpu_torch.io.vcf import read_vcf
    from focalsv_tpu_torch.parallel import distributed, gather
    _, recs = read_vcf(main_path["guided_vcf"])
    flat, lens = gather.encode_records(recs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    t0 = time.perf_counter()
    try:
        rank_world = distributed.initialize(f"localhost:{port}", 1, 0,
                                            backend="nccl")
        import torch.distributed as dist
        backend = dist.get_backend()
        g_flat = gather._process_allgather(flat)
        g_lens = gather._process_allgather(lens)
    finally:
        distributed.shutdown()
    same = (g_flat.shape == (1, flat.size) and np.array_equal(g_flat[0], flat)
            and np.array_equal(g_lens[0], lens)
            and [r.to_line() for r in gather.decode_records(g_flat[0],
                                                            g_lens[0])]
            == [r.to_line() for r in recs])
    log(f"[ranks] {backend} at world size 1 on the card: initialize -> "
        f"{rank_world}, all_gather of {len(recs)} records ({flat.size} "
        f"bytes) returned them unchanged: {same}; group left: "
        f"{distributed.world_size() == 1} "
        f"({time.perf_counter() - t0:.2f} s)")
    if not same or backend != "nccl" or distributed.world_size() != 1:
        raise AssertionError("the NCCL phase failed")


def multi_device(rng, jobs, main_path, work: str) -> dict:
    """Phase 11; returns the (B1, B4) launches of its two paths in this
    process: the sharded DP with the dry run, and run_target_mode through
    the mesh.  (The two ranks launch in processes of their own.)"""
    from focalsv_tpu_torch.ops import align_cuda
    mesh = smoke_mesh()
    sharded_region_steps(jobs, mesh)
    dp = sharded_dp(rng, mesh)
    with open(main_path["guided_vcf"]) as f:
        want = f.read()
    os.environ["FOCALSV_DP_RT_MS"] = "0"    # as phase 6's guided run had it
    align_cuda.reset_launches()
    reset_counts()
    try:
        got, stats, _ = run_mode(main_path["bam"], main_path["fasta"],
                                 main_path["bed"], f"{work}/guided_mesh",
                                 "guided", "device", N_REGIONS, mesh=mesh)
    finally:
        del os.environ["FOCALSV_DP_RT_MS"]
    through_mesh = (align_cuda.launches, align_cuda.traceback_launches)
    record_counts("target_mode_through_mesh")
    log(f"[mesh] run_target_mode through the mesh: VCF equal to phase 6's "
        f"device VCF byte for byte: {got == want}; "
        f"{N_REGIONS / stats['wall_s']:.3f} regions/s beside phase 6's "
        f"{main_path['guided_rps']:.3f} "
        + ("on one device" if torch.cuda.device_count() < 2 else
           "on the mesh that run_target_mode builds itself of every card")
        + f", same run; launches "
        f"B1 {through_mesh[0]} (phase 6's guided run: "
        f"{main_path['guided_b1']}), B4 {through_mesh[1]}, "
        f"B2 {B2_LAUNCHES['target_mode_through_mesh']}")
    if got != want or stats["n_chunks"] == 0:
        raise AssertionError("the mesh run's VCF differs from phase 6's")
    two_ranks(main_path, work)
    nccl_single(main_path)
    return {"sharded_dp_and_dry_run": dp,
            "target_mode_through_mesh": through_mesh}


# -- phase 12 ---------------------------------------------------------------

# auto mode's genome: two chromosomes of 10 Mb at 30x HiFi with 9 SVs a Mb
# (the reference's HG002 HiFi auto BED holds 26,834 regions over some 3.1
# Gb, 8.7 a Mb), cut from a chr21-sized chromosome (46.7 Mb) to fit the
# run's time; a prior with a record at each true SV and a decoy a Mb.  The
# CLR genome, one chromosome of 2 Mb at the same density and no prior,
# takes the branch in which detection's min_sig follows the coverage.
AUTO_N_CHROMS = 2
AUTO_CHROM_LEN = 10_000_000
AUTO_SVS_PER_MB = 9
AUTO_CLR_CHROM_LEN = 2_000_000


def auto_genome(work: str, dtype: str, n_chroms: int, chrom_len: int,
                prior: bool) -> dict:
    """bench_auto.py's genome (testing/auto_cases.py), with a prior."""
    from focalsv_tpu_torch.testing import auto_cases
    d = os.path.join(work, f"auto_{dtype.lower()}")
    os.makedirs(d)
    n_svs = AUTO_SVS_PER_MB * chrom_len // 1_000_000
    t0 = time.perf_counter()
    bam, fa, truth = auto_cases.build_genome(d, n_chroms, chrom_len,
                                             COVERAGE, n_svs, dtype)
    secs = time.perf_counter() - t0
    g = dict(dtype=dtype, bam=bam, fasta=fa, truth=truth, prior=None,
             chrom_lens={f"chr{i + 1}": chrom_len for i in range(n_chroms)})
    n_prior = 0
    if prior:
        g["prior"] = os.path.join(d, "prior.vcf")
        n_prior = auto_cases.write_prior(g["prior"], truth, g["chrom_lens"])
    log(f"[auto] {dtype} genome: {n_chroms} x {chrom_len} bp at {COVERAGE}x, "
        f"{len(truth)} SVs, built in {secs:.1f} s, BAM "
        f"{os.path.getsize(bam) / 1e6:.1f} MB, prior "
        f"{f'{n_prior} records' if prior else 'none'}")
    return g


def _rss_mb() -> float:
    """This process's resident size now (/proc/self/status, VmRSS), MB."""
    with open("/proc/self/status") as f:
        for line in f:
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) / 1024
    raise RuntimeError("/proc/self/status has no VmRSS line")


@contextlib.contextmanager
def sampled_peak_rss(out: dict, every_s: float = 0.05):
    """This process's resident size at the start of the span and the
    largest over it, sampled every ``every_s`` by a thread (ru_maxrss
    covers the process's whole life, earlier phases included)."""
    import threading
    stop = threading.Event()
    out["start_rss_mb"] = _rss_mb()

    def sample():
        while True:
            out["peak_rss_mb"] = max(out.get("peak_rss_mb", 0.0), _rss_mb())
            if stop.wait(every_s):
                return

    thread = threading.Thread(target=sample, daemon=True)
    thread.start()
    try:
        yield out
    finally:
        stop.set()
        thread.join()


STEP0_STAGES = ("load", "coverage", "scan", "prior", "detect", "bed")


def auto_run(g: dict, out: str, mode: str) -> dict:
    """One run of the port's CLI with --auto over genome g, with the
    kernels' counts set to 0 just before it and read just after.  The
    native scan's cache is cleared first, so that each run pays for its own
    scan.  Step 0's parts come from out/log/stage_times.json, each
    chromosome's from out/<chrom>/log/."""
    import io
    import resource
    from contextlib import redirect_stdout

    from focalsv_tpu_torch.ops import align_cuda, pairhmm_cuda, region_cuda
    from focalsv_tpu_torch.pipeline import cli, main
    argv = ["--bam_file", g["bam"], "--ref_file", g["fasta"], "--out_dir",
            out, "--data_type", g["dtype"], "--auto", "--execution", mode,
            "--num_threads", "8"]
    if g["prior"]:
        argv += ["--prior_file", g["prior"]]
    main._native_scan_cache.clear()
    align_cuda.reset_launches()
    reset_counts()
    reset_b6_counts()
    if DEVICE.type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    rss: dict = {}
    t0 = time.perf_counter()
    with sampled_peak_rss(rss), redirect_stdout(io.StringIO()):
        rc = cli.main(argv)
    wall = time.perf_counter() - t0
    if rc != 0:
        raise AssertionError(f"auto mode ({g['dtype']} {mode}) returned {rc}")
    launches = {"B1": align_cuda.launches,
                "B4": align_cuda.traceback_launches,
                "B2": region_cuda.launches, "B3": region_cuda.rows_launches,
                "B6": pairhmm_cuda.launches}
    native = main._native_scan_cache.get(g["bam"])
    main._native_scan_cache.clear()
    with open(os.path.join(out, "log", "stage_times.json")) as f:
        spans = {k: v["seconds"] for k, v in json.load(f).items()}
    step0 = sum(spans.get(k, 0.0) for k in STEP0_STAGES)
    run = dict(out=out, mode=mode, wall_s=wall, launches=launches,
               spans=spans, native_scan=native is not None, step0_s=step0,
               target_s=wall - step0,
               peak_rss_mb=rss["peak_rss_mb"],
               start_rss_mb=rss["start_rss_mb"],
               ru_maxrss_mb=(resource.getrusage(resource.RUSAGE_SELF)
                             .ru_maxrss / 1024),
               max_allocated_mb=(torch.cuda.max_memory_allocated() / 2 ** 20
                                 if DEVICE.type == "cuda" else 0.0))
    bed = f"SV_Regions_{g['dtype']}.bed"
    with open(os.path.join(out, bed)) as f:
        run["regions"] = [(c, int(a), int(b)) for c, a, b in
                          (ln.split("\t") for ln in f.read().splitlines())]
    run["files"] = {}
    for name in [bed, "FocalSV_Final_SV.vcf"] + [
            os.path.join(c, "FocalSV_Final_SV.vcf") for c in g["chrom_lens"]]:
        with open(os.path.join(out, name), "rb") as f:
            run["files"][name] = f.read()
    run["chroms"] = {}
    run["buckets"], run["tiles"] = {}, {}
    for c in g["chrom_lens"]:
        log_dir = os.path.join(out, c, "log")
        with open(os.path.join(log_dir, "stage_times.json")) as f:
            stages = {k: v["seconds"] for k, v in json.load(f).items()}
        stats = {}
        if mode == "device":
            with open(os.path.join(log_dir, "device_stats.json")) as f:
                stats = json.load(f)
            for name, b in stats["buckets"].items():
                m = run["buckets"].setdefault(name, dict(
                    key=tuple(b["key"]), G=b["G"], chunks=0, regions=0))
                if m["G"] != b["G"]:
                    raise AssertionError(f"bucket {name}: G {m['G']} and "
                                         f"{b['G']} in one run")
                m["chunks"] += b["chunks"]
                m["regions"] += b["regions"]
            for kind, n in stats["tiles_by_encoding"].items():
                run["tiles"][kind] = run["tiles"].get(kind, 0) + n
        run["chroms"][c] = dict(stages=stages, stats=stats)
    return run


def auto_report(g: dict, run: dict) -> None:
    """Print one auto run: step 0 by part, target mode by chromosome, the
    buckets and tiles, memory, launches and accuracy against the truth."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.evaluation.compare import match_records
    from focalsv_tpu_torch.io.vcf import read_vcf
    tag = f"[auto] {g['dtype']} {run['mode']}"
    n = len(run["regions"])
    widths = sorted(b - a for _, a, b in run["regions"])
    sp = run["spans"]
    log(f"{tag}: step 0 {run['step0_s']:.3f} s ("
        + "; ".join(f"{k} {sp[k]:.4f}" for k in STEP0_STAGES if k in sp)
        + f"; the native scan paid by this run: {run['native_scan']}), "
        f"the rest of the run (target mode) {run['target_s']:.3f} s, wall "
        f"{run['wall_s']:.3f} s; {n} regions, widths {widths[0]}-"
        f"{widths[len(widths) // 2]}-{widths[-1]} bp (least, median, most): "
        f"{n / run['wall_s']:.3f} regions/s over the run, "
        f"{n / run['target_s']:.3f} over target mode")
    for c, r in run["chroms"].items():
        st = r["stats"]
        dev = (f"; n_chunks={st['n_chunks']} "
               f"n_host_fallback={st['n_host_fallback']} "
               f"h2d_bytes={int(st['h2d_bytes'])} "
               f"d2h_bytes={int(st['d2h_bytes'])} "
               f"device_s={st['device_s']:.4f} (the chunks' span on the "
               f"stream, CUDA events) "
               f"tile_build_s={st['tile_build_s']:.3f} "
               f"finish_s={st['finish_s']:.3f} "
               f"dp_jobs={st.get('dp_jobs', 0)}" if st else "")
        log(f"{tag} {c}: {sum(1 for rc, _, _ in run['regions'] if rc == c)} "
            f"regions, stage seconds {json.dumps(r['stages'])}{dev}")
    if run["mode"] == "device":
        cfg = preset(g["dtype"])
        for b in sorted(run["buckets"].values(),
                        key=lambda b: (b["key"][0], b["key"][2], b["key"])):
            plan = launch_plan(chunk_kwargs(b["key"], b["G"], cfg))
            log(f"{tag} bucket {b['key']}: {b['chunks']} chunks, "
                f"{b['regions']} regions, G {b['G']}, launch plan "
                f"{json.dumps(plan)}")
        log(f"{tag} tiles by encoding: {json.dumps(run['tiles'])}")
    log(f"{tag}: host RSS {run['start_rss_mb']:.0f} MB at the run's start, "
        f"{run['peak_rss_mb']:.0f} MB at most during it (sampled every 0.05 "
        f"s); ru_maxrss of the process, earlier phases included, "
        f"{run['ru_maxrss_mb']:.0f} MB; torch.cuda.max_memory_allocated "
        f"{run['max_allocated_mb']:.1f} MiB; launches "
        f"{json.dumps(run['launches'])}")
    _, calls = read_vcf(os.path.join(run["out"], "FocalSV_Final_SV.vcf"))
    b = match_records(calls, g["truth"])
    log(f"{tag}: {len(calls)} calls against {len(g['truth'])} true SVs: "
        f"recall {b.recall:.4f} precision {b.precision:.4f} F1 {b.f1:.4f} "
        f"(reported, not gated)")


def chunk_kwargs(key, G, cfg) -> dict:
    """The region step's arguments for a chunk of bucket key."""
    from focalsv_tpu_torch.benches.bench import delta_kwargs
    return (delta_kwargs(key, G, cfg) if key[0] == "delta"
            else rows_kwargs(key, G, cfg))


def dispatched_chunks(tag: str, tiles: list, cfg, buckets: dict,
                      n_host: int) -> list[tuple]:
    """One packed chunk for each bucket that a device run dispatched
    (``buckets``: its stats' buckets by name, each with its key, G and
    regions), from the run's regions tiled again as the run tiled them,
    which must give the run's buckets region for region and its n_host
    tiles for the host: the first G tiles of each bucket, padded as the run
    pads a tail.  Returns (case, buffer, kwargs) for against_plain."""
    from focalsv_tpu_torch.pipeline import device_exec as dx
    by_key: dict = {}
    for i, t in enumerate(tiles):
        by_key.setdefault(dx._bucket_key(t, cfg), []).append(i)
    got = {k: len(v) for k, v in by_key.items() if k is not None}
    want = {tuple(b["key"]): b["regions"] for b in buckets.values()}
    if got != want or len(by_key.get(None, [])) != n_host:
        raise AssertionError(f"{tag}: the regions tiled again give buckets "
                             f"{got}, the run dispatched {want}")
    out = []
    for b in sorted(buckets.values(),
                    key=lambda b: (b["key"][0], b["key"][2], b["key"])):
        key, G = tuple(b["key"]), b["G"]
        idxs = by_key[key][:G]
        chunk = idxs + [len(tiles)] * (G - len(idxs))
        out.append((f"{tag} {key} real={len(idxs)}",
                    dx.pack_chunk(tiles + [None], chunk, key, G),
                    chunk_kwargs(key, G, cfg)))
    log(f"[chunks] {tag}: the run's regions tiled again give its "
        f"{len(want)} buckets, each held to the plain version at the run's "
        f"G")
    return out


def auto_chunks(g: dict, run: dict) -> list[tuple]:
    """dispatched_chunks of an auto run, its buckets as its
    device_stats.json files name them, its regions tiled as target mode
    tiles them."""
    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io import bam as bamio
    from focalsv_tpu_torch.io.fasta import FastaFile
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg = preset(g["dtype"])
    bam = bamio.ensure_indexed(g["bam"])
    fasta = FastaFile.load(g["fasta"])

    def tile(region):
        c, a, b = region
        return dx.build_tile(list(bam.fetch(c, a, b)), fasta.fetch(c, a, b),
                             a, c, cfg)

    with ThreadPoolExecutor(max_workers=8) as ex:
        tiles = list(ex.map(tile, run["regions"]))
    return dispatched_chunks(f"auto {g['dtype']}", tiles, cfg,
                             run["buckets"], run["tiles"].get("host", 0))


def bench_chunks(res: dict) -> list[tuple]:
    """dispatched_chunks of a device run of benches.bench (its reported
    pass's buckets), its jobs tiled as the bench tiles them."""
    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.benches import bench
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg, st = res["cfg"], res["stats"]

    def tile(job):
        reads, ref, chrom = bench._load_job(job)
        return dx.build_tile(reads, ref, 0, chrom, cfg)

    with ThreadPoolExecutor(max_workers=8) as ex:
        tiles = list(ex.map(tile, res["jobs"]))
    return dispatched_chunks("bench", tiles, cfg, st["buckets"],
                             st.get("tiles_by_encoding", {}).get("host", 0))


def auto_mode(work: str, smi: str) -> dict:
    """Phase 12: auto mode on the card and on the host, HiFi with a prior
    and CLR without; B2 (B3 for a dense tile) against its plain version at
    each bucket the device runs dispatched.  Returns the
    kernels' launches of each device run and the kernel rows."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.testing import auto_cases
    t_phase = time.perf_counter()
    log(f"[auto] card: {smi}")
    hifi = auto_genome(work, "HIFI", AUTO_N_CHROMS, AUTO_CHROM_LEN, True)
    clr = auto_genome(work, "CLR", 1, AUTO_CLR_CHROM_LEN, False)
    checks = {}
    launches = {}
    b2, b3 = [], []
    for g, path in ((hifi, "auto_mode"), (clr, "auto_mode_clr")):
        runs = {}
        for mode in ("device", "host"):
            out = os.path.join(work, f"auto_{g['dtype'].lower()}_{mode}")
            runs[mode] = auto_run(g, out, mode)
            auto_report(g, runs[mode])
        dev, host = runs["device"], runs["host"]
        launches[path] = dev["launches"]
        tag = g["dtype"]
        for name in dev["files"]:
            checks[f"{tag} device {name} == host"] = (
                dev["files"][name] == host["files"][name])
        checks[f"{tag} native scan ran (device, host)"] = (
            dev["native_scan"] and host["native_scan"])
        checks[f"{tag} regions > 0"] = len(dev["regions"]) > 0
        checks[f"{tag} device chunks > 0"] = all(
            r["stats"]["n_chunks"] > 0 for r in dev["chroms"].values())
        checks[f"B2 launched on {path}"] = dev["launches"]["B2"] > 0
        for case, buf, kw in auto_chunks(g, dev):
            # raises where the kernel differs from its plain version
            (b3 if "W" in kw else b2).append(against_plain(case, buf, kw))
    parity = auto_cases.scan_parity_check(hifi["bam"], preset("HIFI"))
    log(f"[auto] native scan against the Python scan over "
        f"{len(hifi['chrom_lens'])} chromosomes: {parity['checked']} "
        f"signatures, differing (chromosome, kind) sets {parity['differ']}; "
        f"native {parity['native_s']:.3f} s, Python "
        f"{parity['python_s']:.3f} s")
    checks["native scan == Python scan"] = (not parity["differ"]
                                            and parity["checked"] > 0)
    for name, ok in checks.items():
        log(f"[auto] check {name}: {ok}")
    log(f"[auto] phase 12 took {time.perf_counter() - t_phase:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"auto mode checks failed: {failed}")
    return dict(launches=launches, b2=b2, b3=b3)


# -- phase 13 ---------------------------------------------------------------

# bench.py's workload at its full 256 regions, one timed pass of each mode
BENCH_REGIONS = 256
# the accuracy matrix's regions a (dtype, case) and the complex-SV trials a
# type that the smoke runs (the benches' defaults: 20 and 12)
ACCURACY_REGIONS = 2
COMPLEX_TRIALS = 2
# PARITY.md's round-5 guided F1 of each dtype (12 regions a class)
PARITY_F1 = {"HIFI": 0.979, "CLR": 0.987, "ONT": 0.983}


def bench_launches(path: str, before: dict) -> dict:
    """The kernels' launches on a path since ``before`` (a launch_counts()
    taken just before it)."""
    from focalsv_tpu_torch.benches.bench_accuracy import launch_counts
    now = launch_counts()
    out = {k: now[k] - before[k] for k in now}
    log(f"[bench] launches on {path}: {json.dumps(out)}")
    return out


def bench_modules(work: str, smi: str) -> dict:
    """Phase 13: the port's measurement modules (focalsv_tpu_torch/benches)
    on the card.  13a bench at 256 regions, threads (--mp 0), one timed
    device and one timed host pass, then B2 against its plain version at
    every bucket the device pass dispatched (a chunk of each at the run's
    G) and at the largest bucket as the bench measures it; 13b
    bench_accuracy_complex, 2 trials a type, every DP of the aligner on the
    card, each trial's calls equal to a run with the host's DP; 13c
    bench_accuracy, 2 regions a (dtype, case), guided, one process; 13d
    bench_scaling at 1 and 2 shards, each dispatch's results equal to the
    plain version's on its chunk.  Returns the kernels' launches by path
    and B2's rows."""
    from focalsv_tpu_torch.benches import (bench, bench_accuracy,
                                           bench_accuracy_complex,
                                           bench_scaling)
    from focalsv_tpu_torch.benches.bench_accuracy import launch_counts
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    t_phase = time.perf_counter()
    log(f"[bench] card: {smi}")
    checks, launches = {}, {}

    # 13a: bench.py's 256 regions through the threaded device path and the
    # host baseline (a subprocess on the CPU)
    args = bench.parse_args(["--regions", str(BENCH_REGIONS), "--mp", "0",
                             "--repeats", "1", "--base-repeats", "1",
                             "--jobs-dir", os.path.join(work, "bench")])
    t0 = time.perf_counter()
    os.makedirs(args.jobs_dir)
    jobs = bench._make_jobs(args.jobs_dir, args.regions, args.coverage)
    log(f"[bench] {len(jobs)} regions simulated and written in "
        f"{time.perf_counter() - t0:.1f} s")
    before = launch_counts()
    res = bench.run(args)
    launches["bench_256"] = bench_launches("bench_256", before)
    line = res["json"]
    log(json.dumps(line))
    with contextlib.redirect_stderr(sys.stdout):
        bench.report(args, res)
    ks = bench.measure_kernel_compute(jobs[3 : 3 + 16 : 4], res["cfg"],
                                      DEVICE)
    with contextlib.redirect_stderr(sys.stdout):
        bench.report_kernel(args, ks, res["stats"])
    checks["bench device records == host records"] = (
        line["records_equal"] and line["records"] > 0)
    checks["bench n_host_fallback == 0"] = line["n_host_fallback"] == 0
    checks["B2 launched on bench_256"] = launches["bench_256"]["B2"] > 0
    b2 = [dict(case=f"bench largest {tuple(ks['shape'])} G={ks['G']}",
               L=ks["shape"][2], max_abs_err=ks["max_abs_err"], ms=ks["ms"],
               queued_ms=ks["queued_ms"], plain_ms=ks["plain_ms"],
               bound_ms=ks["bound_ms"], bound_by=ks["bound_by"],
               **(ks["plan"] or {}))]
    for case, buf, kw in bench_chunks(res):
        # raises where the kernel differs from its plain version
        b2.append(against_plain(case, buf, kw))

    # 13b: the complex-SV trials through the port's aligner; its DPs fit the
    # native host kernel's cap at the bench's defaults, so the cap goes to
    # 0 as in phase 8, and every DP of the aligner runs B1 and B4; then the
    # same trials with the cap as it is (every DP on the host), whose calls
    # the card's must equal, trial for trial
    trials: dict = {"card": [], "host": []}
    cap = talign.NATIVE_DP_MAX_CELLS
    talign.NATIVE_DP_MAX_CELLS = 0
    before = launch_counts()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stderr(sys.stdout):
            rows = bench_accuracy_complex.main(
                ["--trials", str(COMPLEX_TRIALS)], trials=trials["card"])
    finally:
        talign.NATIVE_DP_MAX_CELLS = cap
    launches["bench_accuracy_complex"] = bench_launches(
        "bench_accuracy_complex", before)
    log(f"[bench] bench_accuracy_complex, {COMPLEX_TRIALS} trials a type, "
        f"every DP on the card, in {time.perf_counter() - t0:.1f} s: " +
        ", ".join(f"{r['metric']} {r['value']}" for r in rows))
    t0 = time.perf_counter()
    with contextlib.redirect_stderr(sys.stdout):
        host_rows = bench_accuracy_complex.main(
            ["--trials", str(COMPLEX_TRIALS)], trials=trials["host"])
    same = [a == b for a, b in zip(trials["card"], trials["host"])]
    log(f"[bench] bench_accuracy_complex again, every DP on the host, in "
        f"{time.perf_counter() - t0:.1f} s: {sum(same)} of "
        f"{len(trials['host'])} trials (controls included) give the card "
        f"run's calls; rows equal: {rows == host_rows}")
    for k in ("B1", "B4"):
        checks[f"{k} launched on bench_accuracy_complex"] = (
            launches["bench_accuracy_complex"][k] > 0)
    checks["bench_accuracy_complex calls on the card == on the host"] = (
        trials["card"] == trials["host"] and len(trials["card"]) > 0
        and rows == host_rows)

    # 13c: the accuracy matrix, guided, in this process
    before = launch_counts()
    t0 = time.perf_counter()
    rows = bench_accuracy.main(["--regions", str(ACCURACY_REGIONS),
                                "--procs", "1"])
    launches["bench_accuracy"] = bench_launches("bench_accuracy", before)
    for r in rows:
        if r["case"] == "ALL":
            log(f"[bench] bench_accuracy {r['dtype']}, "
                f"{ACCURACY_REGIONS} regions a class: F1 {r['f1']} "
                f"(recall {r['recall']}, precision {r['precision']}, GT "
                f"concordance {r['gt_concordance']}) beside PARITY.md's "
                f"{PARITY_F1[r['dtype']]} at 12 regions a class")
    log(f"[bench] bench_accuracy in {time.perf_counter() - t0:.1f} s")
    checks["bench_accuracy rows"] = len(rows) == 3 * 8
    # which encoding the matrix's noisy tiles take (B3 runs dense ones)
    enc: dict = {}
    for dtype in ("CLR", "ONT"):
        cfg = preset(dtype)
        for case in bench_accuracy.CASES:
            rg = bench_accuracy.make_case(4000, case,
                                          bench_accuracy.ERR_MODELS[dtype])
            key = dx._bucket_key(dx.build_tile(rg.reads, rg.ref, 0,
                                               rg.chrom, cfg), cfg)
            kinds = enc.setdefault(dtype, {})
            kind = "host" if key is None else key[0]
            kinds[kind] = kinds.get(kind, 0) + 1
    log(f"[bench] bench_accuracy's noisy tiles by encoding (seed 4000, "
        f"every class): {json.dumps(enc)}")

    # 13d: the sharded region step at 1 and 2 shards; each dispatch's
    # results against the plain version on its chunk (on the CPU), and B2
    # against the plain version on that chunk as against_plain holds it
    before = launch_counts()
    tempdir = tempfile.tempdir
    tempfile.tempdir = work              # the sweep's jobs
    try:
        doc, outputs = bench_scaling.sweep(bench_scaling.parse_args(
            ["--devices", "1", "2"]))
    finally:
        tempfile.tempdir = tempdir
    launches["bench_scaling"] = bench_launches("bench_scaling", before)
    key = tuple(doc["bucket"])
    for n, (buf, got) in outputs.items():
        kw = chunk_kwargs(key, len(got), preset("HIFI"))
        want = rs.phase_consensus_delta_flat_plain(torch.from_numpy(buf),
                                                   **kw).numpy()
        checks[f"bench_scaling n={n}: results == the plain version's"] = (
            np.array_equal(got, want))
        b2.append(against_plain(f"bench_scaling n={n} {key} G={len(got)}",
                                buf, kw, want))
    for r in doc["rows"]:
        log(f"[bench] bench_scaling n={r['n_devices']} {r['shards']}: "
            f"{r['regions_per_dispatch']} regions, wall "
            f"{r['wall_ms_median']} ms (min {r['wall_ms_min']}), "
            f"{r['core_ms_per_region']} unit-ms a region, results equal "
            f"to one shard's: {r['records_equal']}")
    checks["bench_scaling records equal at 1 and 2 shards"] = (
        doc["records_equal"])
    checks["B2 launched on bench_scaling"] = (
        launches["bench_scaling"]["B2"] > 0)
    for name, ok in checks.items():
        log(f"[bench] check {name}: {ok}")
    log(f"[bench] phase 13 took {time.perf_counter() - t_phase:.1f} s")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"phase 13 checks failed: {failed}")
    return dict(launches=launches, b2=b2)


def child_pids() -> list[int]:
    """The processes whose parent is this one, zombies left out."""
    me, out = os.getpid(), []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                state, ppid = f.read().rsplit(")", 1)[1].split()[:2]
        except OSError:              # ended while we looked
            continue
        if int(ppid) == me and state != "Z":
            out.append(int(name))
    return out


def stop_helpers() -> list[int]:
    """End what the run started besides its own children: the process in
    which multiprocessing tracks the executor's semaphores would otherwise
    outlive this one by a moment.  Returns the processes that were still
    running after that, each of them killed."""
    import gc
    import signal
    from multiprocessing import resource_tracker
    gc.collect()                     # the executor's queues unregister
    tracker = resource_tracker._resource_tracker
    if getattr(tracker, "_pid", None) is not None:
        if hasattr(tracker, "_stop"):
            tracker._stop()
        else:
            os.close(tracker._fd)
            os.waitpid(tracker._pid, 0)
            tracker._fd = tracker._pid = None
    left = child_pids()
    deadline = time.monotonic() + 10.0
    while left and time.monotonic() < deadline:
        time.sleep(0.1)
        for pid in left:
            try:
                os.waitpid(pid, os.WNOHANG)
            except ChildProcessError:
                pass
        left = child_pids()
    for pid in left:
        os.kill(pid, signal.SIGKILL)
        try:
            os.waitpid(pid, 0)
        except ChildProcessError:
            pass
    return left


def main() -> int:
    smi = device_check()
    if not os.path.isdir(os.path.join(ROOT, "focalsv_tpu_torch")):
        print("chip_smoke: run from a checkout of the repository",
              file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    host_libraries()
    build_kernels()
    rng = np.random.default_rng(0)
    b1, b4 = kernel_parity(rng, B1_CASES)
    b4.append(dict(case="crafted_walks", max_abs_err=walk_parity()))
    t0 = time.perf_counter()
    regions = _simulate(N_REGIONS)
    log(f"[data] simulated {len(regions)} HiFi regions at {COVERAGE}x in "
        f"{time.perf_counter() - t0:.1f} s")
    jobs = region_tiles(regions[: 2 * len(SIZE_MIX)], n_clr=2)
    b2, b3 = region_step_parity(jobs)
    b2_cases, b3_cases = region_case_parity()
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "build"))
    try:
        golden(work)
        main_path = slice_run(regions, work)
        b3_noisy, noisy_inputs = noisy_slice(work)
        mp_executor(regions, work, main_path["guided_rps"])
        complex_b1, complex_b4 = complex_svs(work, main_path["olc_out"],
                                             main_path["fasta"])
        b6 = pairhmm_phase()
        traffic = pairhmm_slice(work, main_path, noisy_inputs)
        path_rows, b6_path = b6_on_path_traffic(traffic)
        b6 += path_rows
        evaluation_phase(regions, work, main_path["guided_vcf"])
        mesh = multi_device(rng, jobs, main_path, work)
        auto = auto_mode(work, smi)
        benches = bench_modules(work, smi)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    left = stop_helpers()
    log(f"[exit] processes of this run still running: {left}")
    if left:
        raise AssertionError(f"the run left processes behind: {left}")
    kernels = []
    for k, name, source, replaces, rows, n, n_complex in (
            (0, "banded_align (B1)", "focalsv_tpu_torch/csrc/banded_align.cu",
             "focalsv_tpu/ops/align_pallas.py:122", b1, main_path["b1"],
             complex_b1),
            (1, "traceback (B4)", "focalsv_tpu_torch/csrc/traceback.cu",
             "focalsv_tpu/ops/align.py:308", b4, main_path["b4"],
             complex_b4)):
        polish = next(r for r in rows if r["case"] == "olc_polish")
        # each path was driven with the counts at 0 just before it and read
        # just after (B4 is not on the sharded DP path, which stores and
        # counts the direction bytes and walks none: its count there reads 0)
        by_path = {"target_mode_guided_and_olc": n,
                   "complex_sv_target": n_complex,
                   **{path: counts[k] for path, counts in mesh.items()},
                   **{path: counts[("B1", "B4")[k]]
                      for path, counts in {**auto["launches"],
                                           **benches["launches"]}.items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": polish["ms"], "queued_ms": polish["queued_ms"],
            "plain_ms": polish["plain_ms"],
            "bound_ms": polish["bound_ms"], "bound_by": polish["bound_by"],
            # no single PyTorch call computes a banded affine-gap DP or
            # walks its direction bytes
            "library_ms": None})
    for path, counts in {**auto["launches"],
                         **benches["launches"]}.items():
        B2_LAUNCHES[path] = counts["B2"]
        B3_LAUNCHES[path] = counts["B3"]
        B6_LAUNCHES[path] = counts["B6"]
    for path in ("golden_cli", "target_mode_guided", "sharded_region_step",
                 "auto_mode", "bench_256", "bench_scaling"):
        if B2_LAUNCHES.get(path, 0) == 0:
            raise AssertionError(f"B2 was not launched on the path {path}")
    hifi = min(b2, key=lambda r: r["L"])    # the HiFi chunk at L 16384
    kernels.append({
        "name": "region_step (B2)", "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/region_step.cu",
        "replaces": "focalsv_tpu/parallel/region_step.py:657",
        "launches": sum(B2_LAUNCHES.values()),
        "launches_by_path": dict(B2_LAUNCHES),
        "max_abs_err": max(r["max_abs_err"] for r in
                           b2 + b2_cases + auto["b2"] + benches["b2"]),
        "ms": hifi["ms"], "plain_ms": hifi["plain_ms"],
        "bound_ms": hifi["bound_ms"], "bound_by": hifi["bound_by"],
        # no single PyTorch call computes the region step
        "library_ms": None,
        "cluster": hifi.get("cluster"), "smem_bytes": hifi.get("smem_bytes"),
        "queued_ms": hifi["queued_ms"],
        # phase 4's chunks by L, then phase 12's and 13's by case
        **{f"{k}_by_chunk": {
            **{f"L{r['L']}": r[k] for r in b2},
            **{r["case"]: r[k] for r in auto["b2"] + benches["b2"]}}
            for k in ("ms", "queued_ms", "plain_ms", "bound_ms")}})
    for path in ("region_step_chunks", "noisy_target_mode",
                 "sharded_region_step", "dry_run"):
        if B3_LAUNCHES.get(path, 0) == 0:
            raise AssertionError(f"B3 was not launched on the path {path}")
    # the full noisy chunk at L 16384
    noisy = next(r for r in b3_noisy
                 if r["case"].startswith("noisy full") and r["L"] == 16384)
    kernels.append({
        "name": "region_rows (B3)", "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/region_step.cu",
        "replaces": "focalsv_tpu/parallel/region_step.py:866",
        "launches": sum(B3_LAUNCHES.values()),
        "launches_by_path": dict(B3_LAUNCHES),
        "max_abs_err": max(r["max_abs_err"]
                           for r in b3 + b3_cases + b3_noisy + auto["b3"]),
        "ms": noisy["ms"], "plain_ms": noisy["plain_ms"],
        "bound_ms": noisy["bound_ms"], "bound_by": noisy["bound_by"],
        # no single PyTorch call computes the region step
        "library_ms": None,
        "cluster": noisy.get("cluster"), "smem_bytes": noisy.get("smem_bytes"),
        "queued_ms": noisy["queued_ms"],
        **{f"{k}_by_chunk": {r["case"]: r[k]
                             for r in b3 + b3_noisy + auto["b3"]}
           for k in ("ms", "queued_ms", "plain_ms", "bound_ms")}})
    for path in ("pairhmm_target_mode_hifi", "pairhmm_target_mode_noisy"):
        if B6_LAUNCHES.get(path, 0) == 0:
            raise AssertionError(f"B6 was not launched on the path {path}")
    head = next(r for r in b6 if r["case"] == "path_median_region")
    timed = [r for r in b6 if "ms" in r]
    kernels.append({
        "name": "pairhmm (B6)", "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/pairhmm.cu",
        "replaces": "focalsv_tpu/ops/pairhmm.py:44",
        "launches": sum(B6_LAUNCHES.values()),
        "launches_by_path": dict(B6_LAUNCHES),
        "max_abs_err": max(r["max_abs_err"] for r in b6),
        # the headline: the HiFi run's region of median windows (9c)
        "ms": head["ms"], "queued_ms": head["queued_ms"],
        "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"],
        # no single PyTorch call computes a pair-HMM forward pass
        "library_ms": None,
        "headline_windows": head["B"],
        "redesigned": "PR 11",
        # lane-steps a pair of the headline call, counted by B6
        "lane_steps_a_pair": b6_path["lane_steps_a_pair"],
        "path": b6_path,
        # launches and copies of one call: B6's entry by the wrappers'
        # counts and by torch.profiler, the plain version's by
        # torch.profiler (None where it recorded none)
        "launches_a_call": {r["case"]: {
            k: r[k] for k in ("entry_launches", "entry_launches_profiled",
                              "plain_launches")} for r in timed},
        "ms_by_case": {r["case"]: r["ms"] for r in timed},
        "queued_ms_by_case": {r["case"]: r["queued_ms"] for r in timed},
        "plain_ms_by_case": {r["case"]: r["plain_ms"] for r in timed},
        "bound_ms_by_case": {r["case"]: r["bound_ms"] for r in timed}})
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    if len(sys.argv) == 5 and sys.argv[1] == "--complex-cpu":
        # phase 8's run on the CPU, started by the smoke run itself
        sys.path.insert(0, ROOT)
        complex_run(sys.argv[2], "cpu", sys.argv[3], sys.argv[4])
        sys.exit(0)
    if len(sys.argv) == 10 and sys.argv[1] == "--pairhmm-cpu":
        # phase 9b's runs on the CPU, started by the smoke run itself
        sys.path.insert(0, ROOT)
        pairhmm_cpu_run(sys.argv[2:])
        sys.exit(0)
    if len(sys.argv) == 6 and sys.argv[1] == "--noisy-cpu":
        # phase 6b's run on the CPU, started by the smoke run itself
        sys.path.insert(0, ROOT)
        noisy_cpu_run(*sys.argv[2:])
        sys.exit(0)
    try:
        code = main()
    finally:
        stop_helpers()               # on a failed phase too
    sys.exit(code)
