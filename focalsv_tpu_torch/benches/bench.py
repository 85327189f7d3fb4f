"""Benchmark: end-to-end region-processing throughput (regions/sec/card).

The port's counterpart of the repository's bench.py, on the same inputs.
Its metric is *target regions/sec/card* against an 8-thread CPU pipeline.
The reference stack itself cannot run here (its Python layer imports
pysam/edlib/cigar and shells out to hifiasm/longshot/minimap2), so the
baseline is MEASURED as the strongest available CPU pipeline: the port's
own host execution mode (numpy + native C++ DP kernels) with
FOCALSV_TORCH_DEVICE=cpu and 8 workers on the identical region set, in a
subprocess of its own.  That host path is itself far faster than the
reference's Python+subprocess stack (one longshot + hifiasm + minimap2
process per region), so vs_baseline is a conservative LOWER bound on the
speedup over the actual reference pipeline.

The measured number is the production device path: bucketized region tiles
-> one region-step launch per chunk (kernel B2 for delta tiles, B3 for
dense ones) -> host finish with cross-thread DP batching onto the card
(pipeline/device_exec.py) -- the same code path `focalsv-tpu-torch` runs.
Reading each region's BAM from disk is *included* in the timed section for
both modes (the reference's per-region stack also starts from a cropped
region BAM, 2_phasing/longshot.py:20).

Workload: 256 regions with a realistic size mix (FocalSV auto regions are
signature clusters +-7 kb flank, target BEDs are bench SVs +-50 kb:
0_define_region.py:462, target_sv/run.sh:5-6), 30x coverage, simulated from
seeds 1000+i (the same bytes as bench.py's) into a jobs directory before
anything is timed.

    python -m focalsv_tpu_torch.benches.bench [--regions 256] [--mp 3]

Runs on the card (FOCALSV_TORCH_DEVICE=cpu runs the plain versions on the
CPU; without a card and without it, it raises).  Prints ONE JSON line with
bench.py's keys ({"metric", "value", "unit", "vs_baseline", "device",
"baseline", "cold_start_s"}, "mesh" with --mesh) plus "backend", the
records of both modes and whether they agree -- value and vs_baseline
are the MEDIAN over --repeats device passes (--mp N) or the best pass
(--mp 0, bench.py's rule) and the median of --base-repeats baseline passes
-- and commented lines: the card's name and power limit, every pass's
seconds, a stage breakdown, and kernel B2 at the workload's largest bucket
(time, launch plan, bound, and the kernel held to its plain version byte
for byte).  Exits 1 when the device records differ from the host records.
"""

import argparse
import hashlib
import json
import os
import subprocess
import sys
import tempfile
import time

# size mix cycled over regions: auto-mode cluster regions (~15-40 kb) and
# target-mode SV +-50 kb windows
SIZE_MIX = (15_000, 30_000, 50_000, 100_000)

# published peaks of one H100 SXM: 3.35 TB/s of HBM3; int32 runs on half of
# the 128 float32 lanes an SM (67 TFLOP/s of float32 = 33.5e12 fused
# multiply-adds a second)
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 67e12 / 4
# kernel B2's integer operations: per column of a region, over its three
# sweeps (events into the tile, two scans, the counts, the het test and the
# strip key; the two votes, their argmax and the track), and per (read,
# site) entry of a MEC round (the assignment's and the vote's bit tests)
B2_OPS_PER_COLUMN = 100
B2_OPS_PER_ENTRY = 10
# card cycles a timed run of queued calls waits behind (some 10 ms, past
# the host's time to queue 20 calls of a wrapper)
QUEUE_CYCLES = 20_000_000


def _load_job(job):
    import numpy as np

    from focalsv_tpu_torch.io.bam import BamReader
    bam_path, ref_path, chrom = job
    reads = list(BamReader(bam_path))
    ref = np.load(ref_path)
    return reads, ref, chrom


def _spread(times: list[float]) -> dict:
    ts = sorted(times)
    return {"median": round(ts[len(ts) // 2], 3),
            "min": round(ts[0], 3), "max": round(ts[-1], 3),
            "n_passes": len(ts)}


def record_keys(results) -> list:
    """Each region's records as (pos, ref, alt, gt), in job order."""
    return [[(r.pos, r.ref, r.alt, r.gt) for r in res.records]
            for res in results]


def records_digest(keys: list) -> str:
    return hashlib.sha1(repr(keys).encode()).hexdigest()


def card_name() -> str:
    """The card's name and power limit as nvidia-smi gives them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()


def run_device_mode_mp(jobs, cfg, n_children: int, repeats: int = 5,
                       mesh=None, device=None):
    """The production path with the multi-process host pipeline
    (pipeline/mp_exec.py): worker processes build tiles and finish regions
    GIL-free; the parent owns the card, and no child may initialise CUDA.

    The untimed first pass, which loads and warms every bucket, ships each
    region's records back; the timed passes ship counts.  Returns (every
    timed pass's seconds in run order, n_records, stats of the median pass,
    record keys of the first pass)."""
    from focalsv_tpu_torch.pipeline.mp_exec import MpRegionExecutor

    passes = []
    with MpRegionExecutor(cfg, n_children=n_children, device=device,
                          mesh=mesh) as ex:
        t0 = time.perf_counter()
        keys = record_keys(r for _, r in ex.run(jobs, collect="records"))
        cold_s = time.perf_counter() - t0
        for _ in range(repeats):
            stats = {}
            t0 = time.perf_counter()
            out = ex.run(jobs, collect="count", stats=stats)
            dt = time.perf_counter() - t0
            if stats["cuda_initialized"]:
                raise RuntimeError(f"{stats['cuda_initialized']} children "
                                   "of the executor initialised CUDA")
            n_records = sum(n for n, _ in out)
            passes.append((dt, n_records, stats))
    pass_s = [p[0] for p in passes]
    passes.sort(key=lambda p: p[0])
    med = passes[len(passes) // 2]
    med[2]["cold_s"] = cold_s
    return pass_s, med[1], med[2], keys


def run_device_mode(jobs, cfg, workers: int, repeats: int = 2, mesh=None,
                    device=None):
    """The production path: tile -> device batch -> host finish.

    Returns (every timed pass's seconds in run order, n_records, stats
    dict with the stage breakdown, record keys), the last three of the
    best pass."""
    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.pipeline.main import _dp_batching_enabled

    dev, _ = dx._device_of(device, mesh)

    def one_pass(stats=None):
        import contextlib

        # the production streaming pipeline: tile builds, device dispatches,
        # decodes and per-region finishes all overlap
        def mk_job(j):
            return lambda: (lambda r, f, c: dx.build_tile(r, f, 0, c, cfg))(
                *_load_job(j))

        def finish(i, tile, res):
            return dx.process_region_device(tile, res, cfg)

        ctx = contextlib.nullcontext()
        if _dp_batching_enabled(cfg, dev):
            from focalsv_tpu_torch.parallel.batch_executor import dp_batching
            ctx = dp_batching(device=dev)
        with ctx, ThreadPoolExecutor(workers) as ex:
            return dx.streamed_map(ex, [mk_job(j) for j in jobs], cfg,
                                   finish, device=device, stats=stats,
                                   mesh=mesh)

    t0 = time.perf_counter()
    one_pass()                      # loads and warms every bucket
    cold_s = time.perf_counter() - t0
    # best-of-N timed passes: every pass processes the full region set, so
    # the best pass is an honest end-to-end number, not a partial
    # measurement
    best = None
    pass_s = []
    for _ in range(repeats):
        stats = {}
        t0 = time.perf_counter()
        res = one_pass(stats)
        dt = time.perf_counter() - t0
        pass_s.append(dt)
        if best is None or dt < best[0]:
            best = (dt, res, stats)
    keys = record_keys(best[1])
    best[2]["cold_s"] = cold_s
    return pass_s, sum(map(len, keys)), best[2], keys


def delta_kwargs(key, G: int, cfg) -> dict:
    """The region step's arguments for a delta chunk, as dispatch_packed
    gives them."""
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    _, R, L, Ds, Dd = key
    return dict(rs.STEP_DEFAULTS, **rs.phase_consensus_kwargs(cfg.phasing),
                G=G, R=R, L=L, Ds=Ds, Dd=Dd, Drle=dx.drle_of(key))


def time_ms(fn, reps: int, queued: bool = False) -> float:
    """Mean milliseconds of fn() on the card over reps calls (CUDA events).
    ``queued``: the stream first sleeps (QUEUE_CYCLES) while the host
    queues the calls, so that the card runs them back to back and the time
    is the card's alone, not the host's time to issue a call."""
    import torch
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(QUEUE_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def b2_bound(dev_buf, out, kw) -> tuple[float, str]:
    """B2's least time on the card for one chunk: its bytes (the chunk read
    once, the results written once) over the memory rate, against its
    integer operations over the int32 rate.  The operations count this
    run's data: every column, and the (read, site) entries of the MEC
    rounds the data needs (the fewest rounds that give the same bytes) plus
    the final assignment."""
    import torch

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


def largest_bucket_chunk(jobs, cfg):
    """One chunk of the largest delta bucket the jobs' tiles fall in (the
    bucket of the widest L, then the one most of them share), at most 8
    regions, packed as the production path packs it: (bucket key, G, the
    chunk's wire buffer), or None when no tile takes the delta encoding."""
    from focalsv_tpu_torch.parallel.wire import pack_delta_chunk
    from focalsv_tpu_torch.pipeline import device_exec as dx

    tiles, keys = [], []
    for j in jobs:
        reads, ref, chrom = _load_job(j)
        t = dx.build_tile(reads, ref, 0, chrom, cfg)
        k = dx._bucket_key(t, cfg)
        if k is not None:
            tiles.append(t)
            keys.append(k)
    if not tiles:
        return None
    key = max(set(keys), key=lambda k: (k[2], keys.count(k)))
    if key[0] != "delta":
        return None
    idxs = [i for i, k in enumerate(keys) if k == key][:8]
    G = len(idxs)
    _, Rp, Lp, Ds, Dd = key
    return key, G, pack_delta_chunk(tiles, idxs, G, Rp, Lp, Ds, Dd)


def measure_kernel_compute(jobs, cfg, device) -> dict | None:
    """Kernel B2 on one chunk of the workload's largest delta bucket
    (largest_bucket_chunk): held to its plain version
    (phase_consensus_delta_flat_plain) on the card byte for byte -- a
    difference raises -- then timed with CUDA events, its calls issued back
    to back and queued behind a sleep of the stream (the card's time
    alone), beside its launch plan and its bound.  The plain version is
    timed too.  On the CPU there is no kernel: the chunk's shape and its
    bytes are returned, the times as None ("not measured")."""
    import torch

    from focalsv_tpu_torch.parallel import region_step as rs

    found = largest_bucket_chunk(jobs, cfg)
    if found is None:
        return None
    key, G, buf = found
    kw = delta_kwargs(key, G, cfg)
    out = dict(shape=list(key), G=G, buffer_bytes=int(buf.size), ms=None,
               queued_ms=None, plain_ms=None, bound_ms=None, bound_by=None,
               plan=None, max_abs_err=None)
    if device.type != "cuda":
        return out
    from focalsv_tpu_torch.ops import region_cuda
    dev = torch.from_numpy(buf).to(device)

    def kernel():
        return rs.phase_consensus_delta_flat(dev, **kw)

    def plain():
        return rs.phase_consensus_delta_flat_plain(dev, **kw)

    got, want = kernel(), plain()
    torch.cuda.synchronize()
    err = int((got.int() - want.int()).abs().max())
    if err != 0 or got.shape != want.shape:
        raise AssertionError(f"B2 differs from its plain version at bucket "
                             f"{key}, G {G}: max_abs_err {err}")
    k1 = time_ms(kernel, 20)
    p1 = time_ms(plain, 2)
    p2 = time_ms(plain, 2)
    k2 = time_ms(kernel, 20)
    bound, by = b2_bound(dev, got, kw)
    out.update(ms=(k1 + k2) / 2, queued_ms=time_ms(kernel, 20, queued=True),
               plain_ms=(p1 + p2) / 2, bound_ms=bound, bound_by=by,
               max_abs_err=err,
               plan=region_cuda.launch_plan(
                   **{k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")},
                   S=kw["max_sites"]))
    return out


def run_host_mode(jobs, cfg, workers: int,
                  repeats: int = 3) -> tuple[list[float], int, list]:
    """The CPU baseline: per-region host numpy/native path on a thread pool
    (numpy + the native DP kernel release the GIL).

    Returns (per-pass seconds, n_records, record keys of the last pass):
    single numbers hide the run-to-run spread of a host under GIL
    contention, so the baseline reports the same median/min/max the device
    side does."""
    import dataclasses as _dc

    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.pipeline.region import process_region
    hcfg = cfg.replace(execution=_dc.replace(cfg.execution, mode="host"))

    def one(job):
        reads, ref, chrom = _load_job(job)
        return process_region(reads, ref, 0, chrom, hcfg)

    one(jobs[0])                    # untimed warmup
    times = []
    keys = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        with ThreadPoolExecutor(workers) as ex:
            results = list(ex.map(one, jobs))
        times.append(time.perf_counter() - t0)
        keys = record_keys(results)
    return times, sum(map(len, keys)), keys


def _make_jobs(tmp, n_regions, coverage, ref_len=None):
    import numpy as np

    from focalsv_tpu_torch.testing import simulate as sim
    jobs = []
    for i in range(n_regions):
        L = ref_len if ref_len else SIZE_MIX[i % len(SIZE_MIX)]
        bam = os.path.join(tmp, f"region_{i}_{L}.bam")
        ref = os.path.join(tmp, f"region_{i}_{L}.ref.npy")
        if not (os.path.exists(bam) and os.path.exists(ref)):
            r = sim.simulate_region(seed=1000 + i, ref_len=L,
                                    coverage=coverage,
                                    n_snps=max(10, L // 1200))
            sim.write_region_bam(r, bam)
            np.save(ref, r.ref)
        jobs.append((bam, ref, "chr21"))
    return jobs


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m focalsv_tpu_torch.benches.bench")
    ap.add_argument("--regions", type=int, default=256)
    ap.add_argument("--ref-len", type=int, default=None,
                    help="fixed region size (default: realistic size mix)")
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--dtype", default="HIFI")
    ap.add_argument("--mode", default="device", choices=["device", "host"])
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--mesh", default=None, metavar="NxM",
                    help="run the device step sharded over an NxM "
                         "{hosts x cards} mesh of N*M cards "
                         "(parallel/mesh.py::make_mesh; on the CPU, "
                         "logical shards).  Chunks batch-pad to the mesh "
                         "size; per-card throughput = value / cards.")
    ap.add_argument("--mp", type=int, default=3, metavar="N",
                    help="device mode: N host worker processes (mp_exec); "
                         "0 = single-process thread pipeline")
    ap.add_argument("--repeats", type=int, default=5,
                    help="timed device passes; median is reported (--mp "
                         "0: the best)")
    ap.add_argument("--base-repeats", type=int, default=3,
                    help="timed baseline passes; median is reported")
    ap.add_argument("--json-only", action="store_true",
                    help="print only the JSON line (baseline subprocess)")
    ap.add_argument("--jobs-dir", default=None,
                    help="reuse pre-simulated region inputs from this dir")
    return ap.parse_args(argv)


def host_baseline(args, tmp: str) -> dict:
    """The CPU baseline's JSON line, from a subprocess of this module in
    host mode on the CPU (FOCALSV_TORCH_DEVICE=cpu).  A failed baseline
    raises."""
    from focalsv_tpu_torch.device import DEVICE_ENV
    root = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    env = dict(os.environ, **{DEVICE_ENV: "cpu"})
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (root, env.get("PYTHONPATH")) if p)
    base_cmd = [sys.executable, "-m", "focalsv_tpu_torch.benches.bench",
                "--mode", "host", "--regions", str(args.regions),
                "--coverage", str(args.coverage), "--dtype", args.dtype,
                "--workers", str(args.workers), "--json-only",
                "--base-repeats", str(args.base_repeats), "--jobs-dir", tmp]
    if args.ref_len:
        base_cmd += ["--ref-len", str(args.ref_len)]
    base = subprocess.run(base_cmd, env=env, capture_output=True, text=True,
                          timeout=3600)
    if base.returncode != 0:
        raise RuntimeError(f"the host baseline failed (exit "
                           f"{base.returncode}):\n{base.stderr[-4000:]}")
    for line in base.stdout.splitlines():
        try:
            return json.loads(line)
        except json.JSONDecodeError:
            continue
    raise RuntimeError(f"the host baseline printed no JSON line:\n"
                       f"{base.stdout[-4000:]}")


def run(args) -> dict:
    """Everything bench.py times, on the device the port resolves: the
    jobs, the host baseline (a subprocess), then the device passes.
    Returns {"json": the JSON line's object, "jobs", "cfg", "device",
    "stats" of the reported pass, "pass_s", "keys" (the device records: of
    the reported pass, or with --mp N of the untimed first pass),
    "baseline": the host line}."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.device import resolve_device

    device = resolve_device()
    cfg = preset(args.dtype)

    # pre-simulate inputs to disk (not part of the timed section): one
    # region BAM + reference window per region, the crop-step layout
    tmp = args.jobs_dir or os.path.join(
        tempfile.gettempdir(),
        f"focalsv_torch_bench_r{args.regions}_c{int(args.coverage)}"
        f"_l{args.ref_len or 'mix'}")
    os.makedirs(tmp, exist_ok=True)
    jobs = _make_jobs(tmp, args.regions, args.coverage, args.ref_len)

    if args.mode == "host":
        times, n_records, keys = run_host_mode(jobs, cfg, args.workers,
                                               repeats=args.base_repeats)
        rps = [args.regions / t for t in times]
        line = {"metric": "baseline_regions_per_sec",
                "value": _spread(rps)["median"],
                "unit": "regions/s", "vs_baseline": 1.0,
                "spread": _spread(rps), "backend": device.type,
                "records": n_records,
                "records_digest": records_digest(keys)}
        return dict(json=line, jobs=jobs, cfg=cfg, device=device,
                    pass_s=times, keys=keys, stats={}, baseline=None)

    # measure the CPU baseline in a clean subprocess
    base = host_baseline(args, tmp)
    baseline_rps = float(base["value"])

    mesh = None
    n_chips = 1
    if args.mesh:
        import torch

        from focalsv_tpu_torch.parallel.mesh import make_mesh
        dims = [int(x) for x in args.mesh.lower().split("x")]
        n_chips = 1
        for d in dims:
            n_chips *= d
        avail = torch.cuda.device_count()
        if device.type == "cuda" and n_chips > avail:
            print(f"# --mesh {args.mesh} needs {n_chips} cards, "
                  f"only {avail} visible", file=sys.stderr)
            sys.exit(2)
        mesh = make_mesh(n_chips)

    if args.mp:
        pass_s, n_records, st, keys = run_device_mode_mp(
            jobs, cfg, args.mp, repeats=args.repeats, mesh=mesh,
            device=device)
        rps_passes = [args.regions / t for t in pass_s]
        # the timed passes count the first pass's records
        records_equal = (records_digest(keys) == base["records_digest"]
                         and n_records == sum(map(len, keys)))
    else:
        pass_s, n_records, st, keys = run_device_mode(
            jobs, cfg, args.workers, repeats=args.repeats, mesh=mesh,
            device=device)
        rps_passes = [args.regions / min(pass_s)]
        records_equal = records_digest(keys) == base["records_digest"]
    dev_spread = _spread(rps_passes)
    rps = dev_spread["median"]
    vs = round(rps / baseline_rps, 3) if baseline_rps else None
    line = {
        "metric": "regions_per_sec_per_chip",
        "value": round(rps / n_chips, 3),
        "unit": "regions/s",
        "vs_baseline": vs,
        "device": dev_spread,
        "baseline": base.get("spread") or {"median": baseline_rps},
        "cold_start_s": round(st.get("cold_s", 0), 1),
        "backend": device.type,
        "records": n_records,
        "baseline_records": base["records"],
        "records_equal": records_equal,
        "n_host_fallback": st.get("n_host_fallback", 0),
    }
    if mesh is not None:
        line["mesh"] = args.mesh
        line["regions_per_sec_all_chips"] = rps
    return dict(json=line, jobs=jobs, cfg=cfg, device=device, pass_s=pass_s,
                keys=keys, stats=st, baseline=base)


def report(args, res: dict) -> None:
    """The commented lines after the JSON line (standard error)."""
    st, line = res["stats"], res["json"]
    how = f"--mp {args.mp}" if args.mp else "threads, the best reported"
    dt = args.regions / line["device"]["median"]
    print(f"# device passes (s, run order, {how}): "
          f"{[round(t, 3) for t in res['pass_s']]}; cold first pass "
          f"{st.get('cold_s', 0):.3f} s", file=sys.stderr)
    busy_frac = min(1.0, st.get("device_busy_s", 0.0) / dt) if dt else 0.0
    print(f"# device mode: {args.regions} regions in {dt:.2f}s "
          f"({line['records']} records, host {line['baseline_records']}, "
          f"equal {line['records_equal']}); stage thread-seconds: "
          f"tile_build={st.get('tile_build_s', 0):.2f} "
          f"device_wait={st.get('device_wait_s', 0):.2f} "
          f"host_finish={st.get('finish_s', 0):.2f}; "
          f"dispatch window (first dispatch to last result, host clock) "
          f"{st.get('device_busy_s', 0):.2f}s ({100 * busy_frac:.0f}% of "
          f"wall), {st.get('n_chunks', 0)} chunks, "
          f"h2d {st.get('h2d_bytes', 0) / 1e6:.1f} MB, "
          f"d2h {st.get('d2h_bytes', 0) / 1e6:.1f} MB, "
          f"{st.get('n_host_fallback', 0)} host-fallback tiles"
          + (f", buckets {json.dumps(st['buckets'])}"
             if st.get("buckets") else ""),
          file=sys.stderr)
    base = res["baseline"]
    print(f"# measured CPU baseline (the port's host mode, {args.workers} "
          f"workers, FOCALSV_TORCH_DEVICE=cpu): {base['value']} regions/s "
          f"(spread {base.get('spread')}). The reference stack cannot run "
          f"here (no pysam/edlib/binaries), so vs_baseline is a lower bound "
          f"vs the actual reference pipeline.", file=sys.stderr)


def report_kernel(args, ks: dict | None, st: dict) -> None:
    if ks is None:
        print("# kernel B2: no delta tile in jobs[3:19:4]", file=sys.stderr)
        return
    if ks["ms"] is None:
        print(f"# kernel B2 at bucket {ks['shape']}, G {ks['G']} "
              f"({ks['buffer_bytes']} bytes in): not measured (no card)",
              file=sys.stderr)
        return
    cells = ks["G"] * ks["shape"][2]
    print(f"# kernel B2 at the largest bucket {ks['shape']}, G {ks['G']} "
          f"({ks['buffer_bytes']} bytes in): equal to its plain version "
          f"byte for byte (max_abs_err {ks['max_abs_err']}); "
          f"{ks['ms']:.4f} ms back to back, {ks['queued_ms']:.4f} ms queued "
          f"= {cells / ks['queued_ms'] / 1e6:.2f} G columns/s; plain "
          f"version {ks['plain_ms']:.2f} ms; bound {ks['bound_ms']:.4f} ms "
          f"by {ks['bound_by']} ({100 * ks['bound_ms'] / ks['queued_ms']:.1f}"
          f" % of the queued time); launch plan {ks['plan']}; priced at "
          f"every region, {ks['queued_ms'] / 1e3 * args.regions / ks['G']:.3f}"
          f" s of the {st.get('device_busy_s', 0):.2f} s dispatch window",
          file=sys.stderr)


def main(argv=None) -> int:
    args = parse_args(argv)
    res = run(args)
    print(json.dumps(res["json"]), flush=True)
    if args.mode == "host":
        if not args.json_only:
            print(f"# host mode: {args.regions} regions, passes "
                  f"{[round(t, 3) for t in res['pass_s']]}s, "
                  f"{res['json']['records']} records", file=sys.stderr)
        return 0
    device = res["device"]
    card = (card_name() if device.type == "cuda" else
            "none (FOCALSV_TORCH_DEVICE=cpu: the plain versions on the CPU)")
    print(f"# card: {card}", file=sys.stderr)
    report(args, res)
    ks = measure_kernel_compute(res["jobs"][3 : 3 + 16 : 4], res["cfg"],
                                device)
    report_kernel(args, ks, res["stats"])
    return 0 if res["json"]["records_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
