"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives focalsv_tpu_torch's main path, HiFi target mode in device execution,
on the card in phases, and exits non-zero at the first phase that fails:

1. device check (a CUDA card must be present) and the card's name and power
   limit as nvidia-smi reports them; the port's g++-built host libraries
   (native/*.cpp) must build and load;
2. build the kernels (csrc/*.cu: B1, the banded DP, B4, its traceback, and
   B2 and B3, the delta and the dense region step) with nvcc for sm_90a, one
   nvcc per source;
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
   every noisy chunk, timed in turns, and at one chunk of the smallest
   bucket that 16 further noisy regions fill (seeds 4000+i);
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
9. the pair-HMM forward pass on the card against the CPU at the
   realignment shape (4,000 windows of 29 bases) within 1e-3, and one
   host-mode region with use_pairhmm=True on the card against the CPU;
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
   shutdown).

Phase 4 also prints the region step's card time by kernel name for one
delta and one rows chunk (torch.profiler); each must take at most 5
launches and copies.  B2's and B3's launches are read from their counts on
every path that runs the region step (phases 4, 5, 6, 6b, 7 and 11).  The
script runs unchanged on a machine with several cards: phase 11's mesh and
ranks take a card each.

The last two lines are the kernels' JSON record and the result line.  A
kernel's bound_ms is the larger of its bytes (each input read once, each
output written once) over the card's memory rate and its integer operations
over the card's int32 rate, for this run's inputs.  All data is simulated
from fixed seeds; scratch files go under build/.
"""

from __future__ import annotations

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
# published peaks of one H100 SXM: 3.35 TB/s of HBM3; 67 TFLOP/s of float32
# outside the tensor cores is 33.5e12 fused multiply-adds a second on 128
# lanes an SM, and int32 has half those lanes
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# integer operations of the recurrence per band cell (substitution, the F,
# G, E, H maxima and their adds, the prefix max, the direction bits)
B1_OPS_PER_CELL = 30
# integer operations per step of a walk (index, load, mask, state, emit)
B4_OPS_PER_STEP = 10
# kernel B2's integer operations: per column of a region, over its three
# sweeps (events into the tile, two scans, the counts, the het test and the
# strip key; the two votes, their argmax and the track), and per (read,
# site) entry of a MEC round (the assignment's and the vote's bit tests)
B2_OPS_PER_COLUMN = 100
B2_OPS_PER_ENTRY = 10
# kernel B3's integer operations per (read, column) cell of a row in each
# of its two sweeps: the nibble's shift and mask, its symbol's compare and
# its count's add; MEC entries as B2's
B3_OPS_PER_CELL = 4
NOISE = {"HIFI": {},
         "CLR": dict(sub_rate=0.04, ins_rate=0.04, del_rate=0.02),
         # substitution-heavy noisy reads: every tile takes the dense
         # encoding on its own (the delta encoding costs 9 bytes a
         # substitution, 12 a deletion run and nothing an insertion, the
         # rows half a byte a column)
         "NOISY": dict(sub_rate=0.10, ins_rate=0.03, del_rate=0.03)}
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


def time_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() on the card over reps calls (CUDA events)."""
    if DEVICE.type != "cuda":        # a CPU rehearsal of the script
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) * 1e3 / reps
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


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
              "BAM scan": native.get_scan_lib() is not None}
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
            line = "kernel " + next(
                (name for k, name in (
                    ("banded_align_reg_kernelILi4E", "B1 registers, 4 cells"),
                    ("banded_align_reg_kernelILi8E", "B1 registers, 8 cells"),
                    ("banded_align_reg_kernelILi16E",
                     "B1 registers, 16 cells"),
                    ("banded_align_wide_kernel", "B1 wide band"),
                    ("traceback_kernel", "B4"),
                    ("region_step_kernelINS_8DeltaSrc", "B2"),
                    ("region_step_kernelINS_7RowsSrc", "B3"))
                 if k in line), line)
        elif not ("registers" in line or "spill" in line):
            continue
        log(f"[build] {line.strip()}")


# -- phase 3 ----------------------------------------------------------------

def kernel_parity(rng, cases):
    """B1 against the plain version on the card, and B4 on B1's direction
    bytes against its plain version and the host traceback; returns the
    rows of both kernels."""
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
        row = dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=max(t_bytes, t_ops),
                   bound_by="bytes" if t_bytes > t_ops else "operations")
        extra = ""
        for b in also:               # the batches the main path sends
            sub = [a[:b].contiguous() for a in args]
            row[f"ms_B{b}"] = time_ms(lambda: kernel(sub), 3)
            extra += f" kernel_ms_B{b}={row[f'ms_B{b}']:.3f}"
        log(f"[b1] {name}: B={B} Lq={Lq} W={W} dirs={store} "
            f"max_abs_err={err} in_band={finite}/{B} kernel_ms={ms:.3f}"
            f"{extra} plain_ms={plain_ms:.1f} bound_ms={row['bound_ms']:.3f} "
            f"bound_by={row['bound_by']}")
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
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    from focalsv_tpu_torch.testing.dp_cases import walk_decisions
    B = dirs.shape[0]

    def kernel():
        return align_cuda.traceback_cuda(dirs, q_len, t_len, d_lo, W, Lq)

    ops_k, n_k = kernel()
    sync()
    ms = time_ms(kernel, 3)
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
        f"plain_ms={plain_ms:.1f} bound_ms={max(t_bytes, t_ops):.5f}")
    if err != 0 or not host_same or host_n == 0:
        raise AssertionError(f"B4 differs from its plain version or from "
                             f"the host traceback ({name})")
    return dict(case=name, max_abs_err=err, ms=ms, plain_ms=plain_ms,
                bound_ms=max(t_bytes, t_ops),
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


def delta_kwargs(key, G, cfg) -> dict:
    """The region step's arguments for a delta chunk, as dispatch_packed
    gives them."""
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    _, R, L, Ds, Dd = key
    return dict(rs.phase_consensus_kwargs(cfg.phasing), G=G, R=R, L=L, Ds=Ds,
                Dd=Dd, Drle=dx.drle_of(key))


def b2_bound(dev_buf, out, kw) -> tuple[float, str]:
    """B2's least time on the card for one chunk: its bytes (the chunk read
    once, the results written once) over the memory rate, against its
    integer operations over the int32 rate.  The operations count this
    run's data: every column, and the (read, site) entries of the MEC
    rounds the data needs (the fewest rounds that give the same bytes) plus
    the final assignment."""
    from focalsv_tpu_torch.parallel import region_step as rs
    n_sites = out[:, :4].contiguous().view(torch.int32).reshape(-1).long()
    rounds = kw["mec_iters"]
    for k in range(kw["mec_iters"]):
        if torch.equal(rs.phase_consensus_delta_flat(
                dev_buf, **dict(kw, mec_iters=k)), out):
            rounds = k
            break
    entries = int(n_sites.sum()) * kw["R"] * (rounds + 1)
    ops = (kw["G"] * kw["L"] * B2_OPS_PER_COLUMN
           + entries * B2_OPS_PER_ENTRY)
    t_bytes = (dev_buf.numel() + out.numel()) / HBM_BYTES_PER_S * 1e3
    t_ops = ops / INT32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations"


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
    plain, kernel), its bound and its launch plan."""
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
    bound, by = (b3_bound(buf, dev, out, kw) if dense
                 else b2_bound(dev, out, kw))
    plan = launch_plan(kw)
    row = dict(case=case, L=kw["L"], max_abs_err=err, ms=(k1 + k2) / 2,
               plain_ms=(p1 + p2) / 2, bound_ms=bound, bound_by=by, **plan)
    shape = (f"W={kw['W']} cells={rows_cells(buf, kw)} "
             f"row_bytes={rows_bytes(buf, kw)}" if dense
             else f"Drle={kw['Drle']}")
    log(f"[{name.lower()}] {case}: G={kw['G']} R={kw['R']} L={kw['L']} "
        f"{shape} S={kw['max_sites']} max_abs_err={err} (card plain and "
        f"CPU) kernel_ms={k1:.4f},{k2:.4f} plain_ms={p1:.2f},{p2:.2f} "
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


def run_mode(bam, fa, bed, out, method, mode, n, mesh=None, dtype="HIFI"):
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.pipeline import main
    cfg = preset(dtype)
    cfg = cfg.replace(
        assembly=dataclasses.replace(cfg.assembly, method=method),
        execution=dataclasses.replace(cfg.execution, mode=mode))
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
            "tile_build_s", "device_wait_s", "finish_s", "device_busy_s")})
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
            f"device_busy_s={dev['device_busy_s']:.3f}; host "
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


def noisy_slice(work: str) -> list[dict]:
    """Phase 6b: the noisy regions through run_target_mode (ONT preset) on
    the card, on the CPU and in host mode; then B3 against its plain
    version at every noisy chunk.  Returns B3's rows of those chunks."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.pipeline import device_exec as dx
    t0 = time.perf_counter()
    regions = _simulate(N_NOISY_REGIONS, "NOISY", seed0=3000)
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
        f"device_busy_s={dev_stats['device_busy_s']:.3f}; host "
        f"{n / host_stats['wall_s']:.3f} regions/s; device on the CPU "
        f"(plain version): device_busy_s={cpu_stats['device_busy_s']:.3f}; "
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
    return rows + [full_noisy_chunk(cfg, keys[0])]


def full_noisy_chunk(cfg, key) -> dict:
    """B3 against its plain version at one chunk of the bucket key with
    every slot a real noisy region (seeds 4000+i, at the bucket's region
    size): phase 6b's chunks hold one or two regions each."""
    from focalsv_tpu_torch.pipeline import device_exec as dx
    G = dx._batch_size(key, cfg, 1)
    size = next(s for s in SIZE_MIX if dx._len_bucket(s) == key[2])
    t0 = time.perf_counter()
    regions = _simulate(G, "NOISY", seed0=4000, sizes=(size,))
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in regions]
    chunks = list(region_chunks([(cfg, tiles)], 1))
    log(f"[noisy] {G} regions of {size} bp simulated and tiled in "
        f"{time.perf_counter() - t0:.1f} s: chunks "
        f"{[(k, g, n) for _c, k, g, n, _b in chunks]}")
    if len(chunks) != 1 or chunks[0][1] != key or chunks[0][3] != G:
        raise AssertionError(f"the noisy regions did not fill one {key} "
                             f"chunk")
    _c, key, G, n_real, buf = chunks[0]
    return against_plain(f"noisy full {key} real={n_real}", buf,
                         rows_kwargs(key, G, cfg))


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
                f"device_busy_s={stats['device_busy_s']:.2f}")
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

def pairhmm_phase(region) -> None:
    import dataclasses as dc

    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.ops import pairhmm
    from focalsv_tpu_torch.pipeline.region import process_region
    rng = np.random.default_rng(9)
    B, L = 4000, 29
    haps = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads = np.full((B, L), 5, np.uint8)
    reads[:, :21] = haps[:, 4:25]
    flip = rng.random((B, 21)) < 0.05
    reads[:, :21][flip] = (reads[:, :21][flip] + 1) % 4
    quals = rng.integers(5, 41, (B, L)).astype(np.int32)
    rl, hl = np.full(B, 21, np.int32), np.full(B, L, np.int32)
    kw = dict(max_read=L, max_hap=L)
    card = pairhmm.pairhmm_forward_batch(reads, rl, haps, hl, quals,
                                         device=DEVICE, **kw)
    t0 = time.perf_counter()
    pairhmm.pairhmm_forward_batch(reads, rl, haps, hl, quals, device=DEVICE,
                                  **kw)
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    cpu = pairhmm.pairhmm_forward_batch(reads, rl, haps, hl, quals,
                                        device="cpu", **kw)
    cpu_ms = (time.perf_counter() - t0) * 1e3
    err = float(np.abs(card - cpu).max())
    log(f"[pairhmm] forward B={B} L={L}: card vs CPU max_abs_err={err:.2e} "
        f"(tolerance 1e-3) finite={bool(np.isfinite(card).all())} "
        f"card_ms={card_ms:.1f} (host clock, copies included) "
        f"cpu_ms={cpu_ms:.1f}")
    if not (np.isfinite(card).all() and err <= 1e-3):
        raise AssertionError("pair-HMM on the card differs from the CPU")
    cfg = preset("HIFI")
    cfg = cfg.replace(phasing=dc.replace(cfg.phasing, use_pairhmm=True))
    t0 = time.perf_counter()
    on_card = process_region(region.reads, region.ref, 0, region.chrom, cfg)
    secs = time.perf_counter() - t0
    os.environ["FOCALSV_TORCH_DEVICE"] = "cpu"
    try:
        on_cpu = process_region(region.reads, region.ref, 0, region.chrom,
                                cfg)
    finally:
        del os.environ["FOCALSV_TORCH_DEVICE"]
    same = (_record_keys(on_card) == _record_keys(on_cpu)
            and np.array_equal(on_card.phase_hp, on_cpu.phase_hp))
    log(f"[pairhmm] host-mode region of {len(region.ref)} bp with "
        f"use_pairhmm=True: {secs:.2f} s, {on_card.n_phased}/"
        f"{on_card.n_reads} reads phased, {len(on_card.records)} records, "
        f"card == CPU {same}")
    if not same or on_card.n_phased == 0:
        raise AssertionError("use_pairhmm region on the card differs from "
                             "the CPU")


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
    device_check()
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
        b3_noisy = noisy_slice(work)
        mp_executor(regions, work, main_path["guided_rps"])
        complex_b1, complex_b4 = complex_svs(work, main_path["olc_out"],
                                             main_path["fasta"])
        pairhmm_phase(regions[0])
        evaluation_phase(regions, work, main_path["guided_vcf"])
        mesh = multi_device(rng, jobs, main_path, work)
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
                   **{path: counts[k] for path, counts in mesh.items()}}
        kernels.append({
            "name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": sum(by_path.values()),
            "launches_by_path": by_path,
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "ms": polish["ms"], "plain_ms": polish["plain_ms"],
            "bound_ms": polish["bound_ms"], "bound_by": polish["bound_by"],
            # no single PyTorch call computes a banded affine-gap DP or
            # walks its direction bytes
            "library_ms": None})
    for path in ("golden_cli", "target_mode_guided", "sharded_region_step"):
        if B2_LAUNCHES.get(path, 0) == 0:
            raise AssertionError(f"B2 was not launched on the path {path}")
    hifi = min(b2, key=lambda r: r["L"])    # the HiFi chunk at L 16384
    kernels.append({
        "name": "region_step (B2)", "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/region_step.cu",
        "replaces": "focalsv_tpu/parallel/region_step.py:657",
        "launches": sum(B2_LAUNCHES.values()),
        "launches_by_path": dict(B2_LAUNCHES),
        "max_abs_err": max(r["max_abs_err"] for r in b2 + b2_cases),
        "ms": hifi["ms"], "plain_ms": hifi["plain_ms"],
        "bound_ms": hifi["bound_ms"], "bound_by": hifi["bound_by"],
        # no single PyTorch call computes the region step
        "library_ms": None,
        "cluster": hifi.get("cluster"), "smem_bytes": hifi.get("smem_bytes"),
        "ms_by_chunk": {f"L{r['L']}": r["ms"] for r in b2},
        "bound_ms_by_chunk": {f"L{r['L']}": r["bound_ms"] for r in b2}})
    for path in ("region_step_chunks", "noisy_target_mode",
                 "sharded_region_step", "dry_run"):
        if B3_LAUNCHES.get(path, 0) == 0:
            raise AssertionError(f"B3 was not launched on the path {path}")
    noisy = b3_noisy[-1]           # the full noisy chunk at L 16384
    kernels.append({
        "name": "region_rows (B3)", "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/region_step.cu",
        "replaces": "focalsv_tpu/parallel/region_step.py:866",
        "launches": sum(B3_LAUNCHES.values()),
        "launches_by_path": dict(B3_LAUNCHES),
        "max_abs_err": max(r["max_abs_err"]
                           for r in b3 + b3_cases + b3_noisy),
        "ms": noisy["ms"], "plain_ms": noisy["plain_ms"],
        "bound_ms": noisy["bound_ms"], "bound_by": noisy["bound_by"],
        # no single PyTorch call computes the region step
        "library_ms": None,
        "cluster": noisy.get("cluster"), "smem_bytes": noisy.get("smem_bytes"),
        "ms_by_chunk": {r["case"]: r["ms"] for r in b3 + b3_noisy},
        "plain_ms_by_chunk": {r["case"]: r["plain_ms"]
                              for r in b3 + b3_noisy},
        "bound_ms_by_chunk": {r["case"]: r["bound_ms"]
                              for r in b3 + b3_noisy}})
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
