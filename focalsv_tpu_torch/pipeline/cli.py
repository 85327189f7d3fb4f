"""CLI entry mirroring the reference's `focalsv.py` interface (:16-34).

    focalsv-tpu-torch --bam_file in.bam --ref_file ref.fa --out_dir out \\
        --data_type HIFI [--target_bed regions.bed | -S start -E end] \\
        [--chr_num 21 | --chr_num 0 for all] [--auto --prior_file prior.vcf]

Differences by design: one process drives every region on the attached GPU
(no per-chromosome SLURM jobs); `--auto` replaces the separate
0_define_region.py invocation.  The flags are those of `focalsv-tpu`.
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="focalsv-tpu-torch",
        description="GPU region-based SV assembly & refinement (PyTorch)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--bam_file", "-bam", required=True)
    p.add_argument("--ref_file", "-r", required=True)
    p.add_argument("--out_dir", "-o", default="./FocalSV_results")
    p.add_argument("--data_type", "-d", choices=["HIFI", "CLR", "ONT"],
                   required=True)
    p.add_argument("--target_bed", "-bed", default=None,
                   help="BED of target regions (target mode)")
    p.add_argument("--region_start", "-S", type=int, default=None)
    p.add_argument("--region_end", "-E", type=int, default=None)
    p.add_argument("--chr_num", "-chr", type=int, default=None,
                   help="chromosome number (0 = all in BED)")
    p.add_argument("--auto", action="store_true",
                   help="auto mode: detect SV-rich regions first (step 0)")
    p.add_argument("--prior_file", "-p", default=None,
                   help="population prior VCF for auto mode")
    p.add_argument("--no_refine", action="store_true",
                   help="skip step-5 coverage/GT refinement")
    p.add_argument("--resume", action="store_true",
                   help="skip chromosomes whose final VCF already exists")
    p.add_argument("--num_threads", "-t", type=int, default=8)
    p.add_argument("--execution", choices=["device", "host"], default=None,
                   help="override the region execution mode")
    p.add_argument("--device_trace", action="store_true",
                   help="record a torch.profiler trace to "
                        "out_dir/log/trace (view in Perfetto)")
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    import contextlib
    import os

    from focalsv_tpu.config import preset
    from focalsv_tpu_torch.pipeline import main as pipeline_main

    cfg = preset(args.data_type)
    if args.execution:
        import dataclasses
        cfg = cfg.replace(execution=dataclasses.replace(
            cfg.execution, mode=args.execution))
    trace_ctx = contextlib.nullcontext()
    if args.device_trace:
        from focalsv_tpu_torch.utils.profiling import device_trace
        os.makedirs(os.path.join(args.out_dir, "log"), exist_ok=True)
        trace_ctx = device_trace(os.path.join(args.out_dir, "log", "trace"))
    refine = not args.no_refine
    with trace_ctx:
        if args.auto:
            chroms = None
            if args.chr_num:
                chroms = [f"chr{args.chr_num}"]
            final = pipeline_main.run_auto_mode(
                args.bam_file, args.ref_file, args.out_dir, cfg,
                prior_vcf=args.prior_file, chroms=chroms, refine=refine,
                num_workers=args.num_threads)
        elif args.target_bed:
            final = pipeline_main.run_target_mode(
                args.bam_file, args.ref_file, args.out_dir, cfg,
                target_bed=args.target_bed, refine=refine,
                resume=args.resume,
                chrom_filter=(f"chr{args.chr_num}" if args.chr_num else None),
                num_workers=args.num_threads)
        else:
            if (args.region_start is None or args.region_end is None
                    or not args.chr_num):
                print("need --target_bed or (-S, -E, --chr_num)",
                      file=sys.stderr)
                return 2
            final = pipeline_main.run_target_mode(
                args.bam_file, args.ref_file, args.out_dir, cfg,
                chrom=f"chr{args.chr_num}", start=args.region_start,
                end=args.region_end, refine=refine,
                num_workers=args.num_threads)
    print(final)
    return 0


if __name__ == "__main__":
    sys.exit(main())
