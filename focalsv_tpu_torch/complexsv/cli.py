"""CLI for complex SV calling, mirroring the reference's two standalone
drivers (FocalSV-auto_TRA_INV_DUP_call.py / FocalSV-target_TRA_INV_DUP_call.py).

    focalsv-tpu-complex --mode auto  --bam_file in.bam --out_dir out -d HIFI
    focalsv-tpu-complex --mode target --bam_file in.bam --bed_file t.bed \\
        --ref_file ref.fa --indel_vcf FocalSV_Final_SV.vcf -d HIFI -o out
"""

from __future__ import annotations

import argparse
import os
import sys


def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        prog="focalsv-tpu-complex",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--mode", choices=["auto", "target"], required=True)
    p.add_argument("--bam_file", "-bam", required=True)
    p.add_argument("--ref_file", "-r", default=None)
    p.add_argument("--bed_file", "-bed", default=None,
                   help="typed BED (chrom start end svtype) for target mode")
    p.add_argument("--data_type", "-d", choices=["HIFI", "CLR", "ONT"],
                   required=True)
    p.add_argument("--out_dir", "-o", default="./FocalSV_complex")
    p.add_argument("--indel_vcf", default=None,
                   help="FocalSV INDEL VCF for the INS->DUP recovery route")
    p.add_argument("--focalsv_out_dir", default=None,
                   help="indel-pipeline out_dir for the contig-route DUP "
                        "caller (reads chr*/regions/*/HP*.fa)")
    p.add_argument("--min_support", type=int, default=2)
    p.add_argument("--state", choices=["Tumor", "Normal"], default="Normal",
                   help="sample state for the DUP round-2 feature bands")
    args = p.parse_args(argv)

    from focalsv_tpu_torch.complexsv import auto as cauto
    from focalsv_tpu_torch.complexsv import target as ctarget
    from focalsv_tpu_torch.io import bam as bamio
    from focalsv_tpu_torch.io.bed import Region
    from focalsv_tpu_torch.io.vcf import read_vcf, write_vcf

    os.makedirs(args.out_dir, exist_ok=True)
    bam = bamio.ensure_indexed(args.bam_file)
    out_vcf = os.path.join(args.out_dir, "FocalSV_TRA_INV_DUP.vcf")

    if args.mode == "auto":
        # ONE streaming pass: split-read segments + per-chromosome span
        # arrays; full records are never resident (WGS memory discipline)
        segs, spans_by_chrom = cauto.stream_segments_and_spans(bam)
        res = cauto.call_complex_from_segments(segs, args.data_type)
        for chrom in list(res.invs):
            res.invs[chrom] = cauto.filter_tra_inv(
                res.invs[chrom], min_sup=args.min_support)
        from focalsv_tpu_torch.utils.coverage import dup_round2_filter
        for chrom in list(res.dups):
            spans = spans_by_chrom.get(chrom)
            ref_len = dict(zip(bam.ref_names, bam.ref_lens))[chrom]
            mean_cov = float((spans[:, 1] - spans[:, 0]).sum()) / max(ref_len, 1)
            kept = cauto.filter_dups(res.dups[chrom], mean_cov, args.data_type)
            res.dups[chrom] = dup_round2_filter(
                kept, spans, mean_cov, args.data_type, state=args.state)
        records = cauto.complex_result_to_vcf(res)
    else:
        if not args.bed_file:
            print("target mode requires --bed_file", file=sys.stderr)
            return 2
        rows = []
        with open(args.bed_file) as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 4:
                    rows.append((Region(parts[0], int(parts[1]),
                                        int(parts[2])), parts[3]))
        regions_by_type = ctarget.split_typed_bed(rows)
        ins_records = None
        ref = None
        if args.ref_file:
            from focalsv_tpu_torch.io.fasta import FastaFile
            ref = FastaFile.load(args.ref_file)
        if args.indel_vcf and ref is not None:
            _, all_recs = read_vcf(args.indel_vcf)
            ins_records = [r for r in all_recs if r.svtype == "INS"]
        if args.focalsv_out_dir and ref is None:
            print("--focalsv_out_dir requires --ref_file; skipping the "
                  "contig-route DUP caller", file=sys.stderr)
        res = ctarget.call_complex_target(
            bam, regions_by_type, args.data_type,
            ins_records=ins_records, ref_by_chrom=ref,
            min_support=args.min_support)
        records = res.all_records()
        if args.focalsv_out_dir and ref is not None:
            records = records + ctarget.call_dup_from_contigs(
                args.focalsv_out_dir, ref, args.data_type,
                min_support=1)
    write_vcf(out_vcf, records,
              contigs=dict(zip(bam.ref_names, bam.ref_lens)))
    print(out_vcf)
    return 0


if __name__ == "__main__":
    sys.exit(main())
