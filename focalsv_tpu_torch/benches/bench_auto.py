"""Auto-mode end-to-end scale benchmark.

The port's counterpart of the repository's bench_auto.py, on the same
genome.  One number for the FULL auto path -- native WGS signature scan
(scan/fast_scan.py) -> step-0 region detection (regions/detect.py) ->
target pipeline over the detected BED, in device execution on the card --
on a multi-chromosome simulated genome (testing/auto_cases.py, the same
BAM and FASTA bytes as bench_auto.py's builder), with peak RSS and a
fast_scan-vs-read_scan signature parity check at scale.  The reference
analog is `0_define_region.py:520-543` followed by the per-chromosome
wrapper loop (`focalsv.py:86-89`).

Usage: python -m focalsv_tpu_torch.benches.bench_auto [--chroms 4]
       [--chrom-len 400000] [--coverage 25] [--svs-per-chrom 6]
       [--dtype HIFI]
Runs on the card (FOCALSV_TORCH_DEVICE=cpu: the plain versions on the
CPU).  Prints one JSON line: {"metric": "auto_regions_per_sec", ...} plus
commented detail rows (the card, step 0 by part, scan rate, detection
counts, recall, peak RSS).  The genome lives in a temporary directory that
is removed at the end.
"""

import argparse
import json
import os
import resource
import sys
import tempfile
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m focalsv_tpu_torch.benches.bench_auto")
    ap.add_argument("--chroms", type=int, default=4)
    ap.add_argument("--chrom-len", type=int, default=400_000)
    ap.add_argument("--coverage", type=float, default=25.0)
    ap.add_argument("--svs-per-chrom", type=int, default=6)
    ap.add_argument("--dtype", default="HIFI")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--no-parity", action="store_true",
                    help="skip the fast_scan-vs-Python rescan parity check "
                         "(the Python rescan is O(genome) and dominates at "
                         ">=10 Mb; parity is gated at small scale)")
    return ap.parse_args(argv)


def run(args, tmp: str) -> dict:
    """Build the genome under tmp, check the scan parity, run auto mode:
    returns the device, the run's regions and calls, their match against
    the truth, step 0's parts, each chromosome's logs and the seconds of
    each piece."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.device import resolve_device
    from focalsv_tpu_torch.evaluation.compare import match_records
    from focalsv_tpu_torch.io.bed import read_bed
    from focalsv_tpu_torch.io.vcf import read_vcf
    from focalsv_tpu_torch.pipeline.main import run_auto_mode
    from focalsv_tpu_torch.testing.auto_cases import (build_genome,
                                                      scan_parity_check)

    device = resolve_device()
    cfg = preset(args.dtype)
    t0 = time.perf_counter()
    bam, ref, truth = build_genome(tmp, args.chroms, args.chrom_len,
                                   args.coverage, args.svs_per_chrom,
                                   args.dtype)
    build_s = time.perf_counter() - t0
    genome_bp = args.chroms * args.chrom_len

    # fast_scan (native) vs read_scan (Python) signature parity at scale
    genome_too_big = args.chroms * args.chrom_len > 8_000_000
    if args.no_parity or genome_too_big:
        parity, scan_dt = None, 0.0
    else:
        t0 = time.perf_counter()
        p = scan_parity_check(bam, cfg)
        parity = (p["checked"], len(p["differ"]))
        scan_dt = time.perf_counter() - t0

    out = os.path.join(tmp, "out")
    t0 = time.perf_counter()
    final = run_auto_mode(bam, ref, out, cfg, num_workers=args.workers)
    dt = time.perf_counter() - t0
    bed = [p for p in os.listdir(out) if p.endswith(".bed")]
    regions = read_bed(os.path.join(out, bed[0])) if bed else []
    _, calls = read_vcf(final)
    b = match_records(calls, truth)
    peak_rss_mb = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1024
    with open(os.path.join(out, "log", "stage_times.json")) as f:
        step0 = json.load(f)
    chroms = {}
    for c in sorted({r.chrom for r in regions}):
        logs = {}
        for name in ("stage_times", "device_stats"):
            path = os.path.join(out, c, "log", f"{name}.json")
            if os.path.exists(path):
                with open(path) as f:
                    logs[name] = json.load(f)
        chroms[c] = logs
    return dict(device=device, genome_bp=genome_bp, build_s=build_s,
                parity=parity, scan_dt=scan_dt, seconds=dt,
                regions=regions, calls=calls, match=b, step0=step0,
                chroms=chroms, peak_rss_mb=peak_rss_mb, out=out)


def main(argv=None) -> int:
    args = parse_args(argv)
    with tempfile.TemporaryDirectory(prefix="focalsv_bench_auto_") as tmp:
        r = run(args, tmp)
    regions, calls, b, dt = r["regions"], r["calls"], r["match"], r["seconds"]
    print(json.dumps({
        "metric": "auto_regions_per_sec",
        "value": round(len(regions) / dt, 3),
        "unit": "regions/s",
        "vs_baseline": None,
        "backend": r["device"].type,
    }), flush=True)
    if r["device"].type == "cuda":
        from focalsv_tpu_torch.benches.bench import card_name
        print(f"# card: {card_name()}", file=sys.stderr)
    print(f"# auto mode e2e: {args.chroms} chroms x {args.chrom_len} bp "
          f"({r['genome_bp'] / 1e6:.1f} Mb) at {args.coverage}x "
          f"{args.dtype}: genome built in {r['build_s']:.1f} s; "
          f"scan+detect+call in {dt:.1f}s -> {len(regions)} regions, "
          f"{len(calls)} calls; truth recall "
          f"{b.recall:.3f} precision {b.precision:.3f} f1 {b.f1:.3f}; "
          f"peak RSS {r['peak_rss_mb']:.0f} MB", file=sys.stderr)
    print(f"# step 0 by part (s): {json.dumps(r['step0'])}",
          file=sys.stderr)
    for c, logs in r["chroms"].items():
        st = logs.get("device_stats", {})
        print(f"# {c}: stage seconds {json.dumps(logs.get('stage_times'))}; "
              + " ".join(f"{k}={st[k]}" for k in (
                  "n_chunks", "n_host_fallback", "device_busy_s",
                  "tile_build_s", "finish_s", "tiles_by_encoding")
                  if k in st), file=sys.stderr)
    if r["parity"]:
        checked, mism = r["parity"]
        print(f"# fast_scan vs read_scan parity: {checked} signatures, "
              f"{mism} mismatching (chrom, kind) sets; "
              f"native scan "
              f"{r['genome_bp'] / max(r['scan_dt'], 1e-9) / 1e6:.1f} "
              f"Mbp/s (incl. Python rescan)", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
