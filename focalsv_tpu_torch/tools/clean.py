"""Workdir cleanup: drop per-region intermediates, keep the FASTA artifacts.

Port of the reference's `focalsv/6_evaluation/clean.py` (:11-35): after a
run, each `Region_*` directory keeps only its assembly FASTAs (`*.fa`,
plus `assembly.fasta` for the CLR/ONT layouts in the reference); phased
BAMs/VCFs and other intermediates are removed.  Here the region layout is
flat (region_phased.bam / region_phased.vcf / HP*.fa under
out_dir/chr*/regions/Region_*), so cleaning keeps `*.fa` and removes the
rest.

    focalsv-tpu-clean --out_dir RUN_DIR [--dry_run]
"""

from __future__ import annotations

import argparse
import os
import sys


def clean_region_dir(rdir: str, dry_run: bool = False) -> list[str]:
    """Remove non-.fa files from one region dir; returns removed paths."""
    removed = []
    for name in sorted(os.listdir(rdir)):
        path = os.path.join(rdir, name)
        if not os.path.isfile(path) or name.endswith(".fa") \
                or name.endswith(".fasta"):
            continue
        removed.append(path)
        if not dry_run:
            os.remove(path)
    return removed


def clean_out_dir(out_dir: str, dry_run: bool = False) -> list[str]:
    removed = []
    for root, dirs, _files in os.walk(out_dir):
        for d in dirs:
            if d.startswith("Region_"):
                removed.extend(clean_region_dir(os.path.join(root, d),
                                                dry_run))
    return removed


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="focalsv-tpu-clean")
    p.add_argument("--out_dir", "-o", required=True)
    p.add_argument("--dry_run", action="store_true",
                   help="list what would be removed without deleting")
    args = p.parse_args(argv)
    removed = clean_out_dir(args.out_dir, dry_run=args.dry_run)
    verb = "would remove" if args.dry_run else "removed"
    print(f"{verb} {len(removed)} intermediate files", file=sys.stderr)
    for path in removed:
        print(path)
    return 0


if __name__ == "__main__":
    sys.exit(main())
