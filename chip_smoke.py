"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives focalsv_tpu_torch's main path, HiFi target mode in device execution,
on the card in phases, and exits non-zero at the first phase that fails:

1. device check (a CUDA card must be present) and the card's name and power
   limit as nvidia-smi reports them;
2. build kernel B1 (csrc/banded_align.cu) with nvcc for sm_90a;
3. B1 against its plain PyTorch version, both on the card, byte for byte
   (tolerance 0), at the shapes of the main path: OLC read polish, aligner
   gap fill, a leading-insertion case, and the score-only wide bands of
   edit_similarity (shared-memory and global-scratch state);
4. the region step on the card against the same step on the CPU, byte for
   byte: HiFi 30x delta chunks at 15-100 kb and one noisy CLR dense chunk;
5. the golden HIFI fixture through the port's CLI in device mode, equal to
   tests/data/golden/hifi/expected.vcf byte for byte;
6. 32 simulated HiFi regions (15-100 kb at 30x) as BAM + FASTA + BED through
   run_target_mode: guided consensus on all of them and OLC assembly on 8,
   in device mode with every DP job sent to the device batch, and in host
   mode; each device VCF must equal its host VCF.

The last two lines are the kernels' JSON record and the result line.  All
data is simulated from fixed seeds; scratch files go under build/.
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
N_OLC_REGIONS = 8
OLC_SCORING = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
ALIGNER_SCORING = dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2)
UNIT_COSTS = dict(match=0, mismatch=-1, gap_open=-1, gap_extend=-1)
DEVICE = torch.device("cuda")


def log(msg: str) -> None:
    print(msg, flush=True)


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
    """Which of the shared package's g++-built host libraries loaded (the
    pipeline takes its Python fallbacks for any that did not)."""
    from focalsv_tpu import native
    log(f"[host] native DP/chain library: {native.get_lib() is not None}, "
        f"BAM parse/tile library: {native.get_parse_lib() is not None}")


# -- phase 2 ----------------------------------------------------------------

def build_kernels() -> None:
    from focalsv_tpu_torch.ops import _build
    t0 = time.perf_counter()
    _build.load_library()
    log(f"[build] B1 library ready in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.build_seconds} s)")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            log(f"[build] {line.strip()}")


# -- phase 3 ----------------------------------------------------------------

def _dp_pairs(rng, B, Lq, W, q_lo, leading_ins=False):
    """HiFi-like pairs at the main path's padded shapes: queries of
    q_lo..Lq-64 bases, targets the query's source with indels and
    substitutions, d_lo as banded_align_pair places the band."""
    from focalsv_tpu_torch.ops import align as talign
    q = np.full((B, Lq), 5, np.uint8)
    qs, ts = [], []
    for _ in range(B):
        n = int(rng.integers(q_lo, Lq - 64))
        src = rng.integers(0, 4, n + 200).astype(np.uint8)
        read = src.copy()
        for _ in range(max(1, n // 1000)):      # indels of a few bases
            at = int(rng.integers(100, len(read) - 100))
            if rng.random() < 0.5:
                read = np.delete(read, slice(at, at + int(rng.integers(1, 6))))
            else:
                read = np.insert(read, at, rng.integers(0, 4, 3))
        flip = rng.random(len(read)) < 0.002
        read[flip] = (read[flip] + 1) % 4
        if leading_ins:
            read = np.concatenate([rng.integers(0, 4, 20), read]
                                  ).astype(np.uint8)
        read = read[: Lq - 64]
        qs.append(read)
        ts.append(src[: len(read) + int(rng.integers(0, 32))])
    Lt = talign._pad_bucket(np.zeros(max(map(len, ts)), np.uint8)).shape[0]
    t = np.full((B, Lt), 5, np.uint8)
    q_len = np.zeros(B, np.int32)
    t_len = np.zeros(B, np.int32)
    d_lo = np.zeros(B, np.int32)
    for b, (qq, tt) in enumerate(zip(qs, ts)):
        q[b, : len(qq)] = qq
        t[b, : len(tt)] = tt
        q_len[b], t_len[b] = len(qq), len(tt)
        lo = (len(tt) - len(qq)) // 2 - W // 2
        d_lo[b] = int(np.clip(lo, len(tt) - len(qq) - W + 1, 0))
        if leading_ins:
            d_lo[b] = -W // 4          # keeps the j == 0 column in the band
    return q, q_len, t, t_len, d_lo


def kernel_parity(rng, cases):
    """B1 against the plain version on the card; returns per-case rows."""
    from focalsv_tpu_torch.ops import align as talign
    from focalsv_tpu_torch.ops import align_cuda
    rows = []
    for name, B, Lq, W, q_lo, scoring, store, lead in cases:
        args = [torch.from_numpy(a).to(DEVICE) for a in
                _dp_pairs(rng, B, Lq, W, q_lo, leading_ins=lead)]

        def kernel():
            return align_cuda.banded_align_batch_cuda(
                *args, band=W, store_dirs=store, **scoring)

        def plain():
            return talign.banded_align_batch(*args, band=W,
                                             store_dirs=store, **scoring)

        s_k, d_k = kernel()
        ms = time_ms(kernel, 3)
        plain_ms = time_ms(plain, 1)
        s_p, d_p = plain()
        err = int((s_k.long() - s_p.long()).abs().max())
        if store:
            err = max(err, int((d_k.int() - d_p.int()).abs().max()))
        finite = int((s_p > talign.NEG).sum())
        log(f"[b1] {name}: B={B} Lq={Lq} W={W} dirs={store} "
            f"max_abs_err={err} in_band={finite}/{B} kernel_ms={ms:.3f} "
            f"plain_ms={plain_ms:.1f}")
        if err != 0:
            raise AssertionError(f"B1 differs from its plain version ({name})")
        if finite == 0:
            raise AssertionError(f"no pair of {name} scored in band")
        rows.append(dict(case=name, max_abs_err=err, ms=ms,
                         plain_ms=plain_ms))
        del args, s_k, d_k, s_p, d_p
    return rows


B1_CASES = [
    # name, B, Lq, W, shortest query, scoring, store_dirs, leading insertion
    ("olc_polish", 128, 16384, 512, 12000, OLC_SCORING, True, False),
    ("aligner_gap_fill", 128, 1024, 128, 300, ALIGNER_SCORING, True, False),
    ("leading_insertion", 32, 1024, 128, 300, OLC_SCORING, True, True),
    ("edit_sim_w8192", 4, 16384, 8192, 12000, UNIT_COSTS, False, False),
    ("edit_sim_w32768_scratch", 2, 4096, 32768, 2000, UNIT_COSTS, False,
     False),
]


# -- phase 4 ----------------------------------------------------------------

def _simulate(n, dtype="HIFI", seed0=1000):
    from focalsv_tpu.testing import simulate as sim
    noise = {"HIFI": {}, "CLR": dict(sub_rate=0.04, ins_rate=0.04,
                                     del_rate=0.02)}[dtype]
    out = []
    for i in range(n):
        L = SIZE_MIX[i % len(SIZE_MIX)]
        out.append(sim.simulate_region(seed=seed0 + i, ref_len=L,
                                       coverage=COVERAGE,
                                       n_snps=max(10, L // 1200), **noise))
    return out


def region_step_parity(hifi_regions, n_clr):
    """The port's region step on the card vs on the CPU, byte for byte, at
    production chunk sizes; returns ms per chunk on the card by bucket."""
    from focalsv_tpu.config import preset
    from focalsv_tpu.parallel.wire import BLOCK, pack_row_tile
    from focalsv_tpu_torch.assembly.consensus import compact_pileup_rows
    from focalsv_tpu_torch.pipeline import device_exec as dx
    jobs = []
    cfg = preset("HIFI")
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in hifi_regions]
    jobs.append((cfg, tiles))
    ccfg = preset("CLR")
    ctiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, ccfg)
              for rg in _simulate(n_clr, "CLR", seed0=2000)]
    for t in ctiles:
        if t.encoding != "dense":          # the dense entry must run
            rows, starts, _ = compact_pileup_rows(
                t.usable, list(range(len(t.usable))), 0, t.region_len)
            t.row_starts = starts.astype(np.int32)
            t.row_lens = np.array([len(r) for r in rows], np.int32)
            offs = (t.row_starts % BLOCK).astype(np.int32)
            t.W_pad = dx._wbucket(int((t.row_lens + offs).max()))
            t.nib = pack_row_tile(rows, t.W_pad, offsets=offs)
            t.q_starts = (t.row_starts // BLOCK).astype(np.int32)
            t.encoding = "dense"
    jobs.append((ccfg, ctiles))
    times = {}
    cuda = DEVICE
    for cfg, tiles in jobs:
        buckets: dict = {}
        for i, t in enumerate(tiles):
            buckets.setdefault(dx._bucket_key(t, cfg), []).append(i)
        for key, idxs in sorted(buckets.items()):
            G = dx._batch_size(key, cfg, 1)
            padded = tiles + [None]
            chunk = idxs + [len(tiles)] * (G - len(idxs))
            buf = dx.pack_chunk(padded, chunk, key, G)
            dev_res = dx.dispatch_packed(buf, key, G, cfg, cuda)
            got = np.asarray(dev_res)
            ms = time_ms(lambda: dx.dispatch_packed(buf, key, G, cfg, cuda)
                         .host, 2)
            t0 = time.perf_counter()
            want = np.asarray(dx.dispatch_packed(buf, key, G, cfg,
                                                 torch.device("cpu")))
            cpu_s = time.perf_counter() - t0
            same = got.shape == want.shape and np.array_equal(got, want)
            log(f"[region_step] {key} G={G} real={len(idxs)} "
                f"card_ms_per_chunk={ms:.1f} cpu_s={cpu_s:.2f} "
                f"bytes_equal={same}")
            if not same:
                raise AssertionError(f"region step on the card differs from "
                                     f"the CPU for bucket {key}")
            times[str(key)] = ms
    return times


# -- phase 5 ----------------------------------------------------------------

def golden(work: str) -> None:
    from focalsv_tpu_torch.pipeline import cli
    d = os.path.join(ROOT, "tests", "data", "golden", "hifi")
    out = os.path.join(work, "golden")
    t0 = time.perf_counter()
    rc = cli.main(["--bam_file", f"{d}/reads.bam", "--ref_file",
                   f"{d}/ref.fa", "--target_bed", f"{d}/regions.bed",
                   "--out_dir", out, "--data_type", "HIFI",
                   "--num_threads", "4", "--execution", "device"])
    with open(os.path.join(out, "FocalSV_Final_SV.vcf")) as f:
        got = f.read()
    with open(os.path.join(d, "expected.vcf")) as f:
        same = got == f.read()
    log(f"[golden] rc={rc} byte_exact={same} "
        f"seconds={time.perf_counter() - t0:.2f}")
    if rc != 0 or not same:
        raise AssertionError("golden HIFI VCF differs from expected.vcf")


# -- phase 6 ----------------------------------------------------------------

def write_chromosome(regions, work: str):
    """Concatenate the regions into one chromosome: BAM + FASTA + a BED per
    region count (all of them, and the first N_OLC_REGIONS)."""
    import focalsv_tpu.io.bam as bamio
    from focalsv_tpu.io.fasta import write_fasta
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
    for n in (len(regions), N_OLC_REGIONS):
        beds[n] = os.path.join(work, f"regions_{n}.bed")
        with open(beds[n], "w") as f:
            for i in range(n):
                f.write(f"chr21\t{offs[i] + 100}\t{offs[i + 1] - 100}\n")
    return bam_path, fa_path, beds


def run_mode(bam, fa, bed, out, method, mode, n):
    from focalsv_tpu.config import preset
    from focalsv_tpu_torch.pipeline import main
    cfg = preset("HIFI")
    cfg = cfg.replace(
        assembly=dataclasses.replace(cfg.assembly, method=method),
        execution=dataclasses.replace(cfg.execution, mode=mode))
    t0 = time.perf_counter()
    final = main.run_target_mode(bam, fa, out, cfg, target_bed=bed,
                                 num_workers=8)
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
    if stats:
        stages.update({k: round(stats[k], 3) for k in (
            "tile_build_s", "device_wait_s", "finish_s", "device_busy_s")})
    log(f"[slice] {method} {mode} stage seconds: {json.dumps(stages)}")
    n_rec = sum(1 for line in vcf.splitlines() if not line.startswith("#"))
    log(f"[slice] {method} {mode}: {n} regions in {secs:.2f} s = "
        f"{n / secs:.3f} regions/s, {n_rec} records"
        + (f", n_chunks={stats['n_chunks']} "
           f"n_host_fallback={stats['n_host_fallback']} "
           f"h2d_bytes={int(stats['h2d_bytes'])} "
           f"d2h_bytes={int(stats['d2h_bytes'])} "
           f"dp_jobs={stats.get('dp_jobs', 0)} "
           f"dp_batches={stats.get('dp_batches', 0)}" if stats else ""))
    return vcf, stats, n_rec


def slice_run(regions, work: str):
    """Device runs (the main path, with the launch counts) then host runs;
    each device VCF must equal its host VCF."""
    from focalsv_tpu_torch.ops import align_cuda
    bam, fa, beds = write_chromosome(regions, work)
    n_all, n_olc = len(regions), N_OLC_REGIONS
    os.environ["FOCALSV_DP_RT_MS"] = "0"    # every DP job to the device batch
    align_cuda.reset_launches()
    g_dev, g_stats, g_rec = run_mode(bam, fa, beds[n_all],
                                     f"{work}/guided_device", "guided",
                                     "device", n_all)
    launches_guided = align_cuda.launches
    o_dev, o_stats, o_rec = run_mode(bam, fa, beds[n_olc],
                                     f"{work}/olc_device", "olc", "device",
                                     n_olc)
    launches = align_cuda.launches
    log(f"[slice] B1 launches on the main path: {launches} "
        f"(guided {launches_guided}, olc {launches - launches_guided})")
    del os.environ["FOCALSV_DP_RT_MS"]
    g_host, _, _ = run_mode(bam, fa, beds[n_all], f"{work}/guided_host",
                            "guided", "host", n_all)
    o_host, _, _ = run_mode(bam, fa, beds[n_olc], f"{work}/olc_host", "olc",
                            "host", n_olc)
    checks = {
        "guided device VCF == host VCF": g_dev == g_host,
        "olc device VCF == host VCF": o_dev == o_host,
        "guided records > 0": g_rec > 0,
        "olc records > 0": o_rec > 0,
        "n_chunks > 0": g_stats["n_chunks"] > 0 and o_stats["n_chunks"] > 0,
        "dp batcher n_jobs > 0 (olc)": o_stats.get("dp_jobs", 0) > 0,
        "B1 launches > 0 (olc)": launches - launches_guided > 0,
    }
    for name, ok in checks.items():
        log(f"[slice] check {name}: {ok}")
    failed = [k for k, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"slice checks failed: {failed}")
    return launches


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
    b1 = kernel_parity(rng, B1_CASES)
    t0 = time.perf_counter()
    regions = _simulate(N_REGIONS)
    log(f"[data] simulated {len(regions)} HiFi regions at {COVERAGE}x in "
        f"{time.perf_counter() - t0:.1f} s")
    region_step_parity(regions[: 2 * len(SIZE_MIX)], n_clr=2)
    os.makedirs(os.path.join(ROOT, "build"), exist_ok=True)
    work = tempfile.mkdtemp(prefix="chip_smoke_", dir=os.path.join(ROOT,
                                                                   "build"))
    try:
        golden(work)
        launches = slice_run(regions, work)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    polish = next(r for r in b1 if r["case"] == "olc_polish")
    print(json.dumps({"kernels": [{
        "name": "banded_align (B1)",
        "route": "cuda",
        "source": "focalsv_tpu_torch/csrc/banded_align.cu",
        "replaces": "focalsv_tpu/ops/align_pallas.py:122",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in b1),
        "ms": polish["ms"],
        "plain_ms": polish["plain_ms"],
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
