"""Evaluation CLI: the reference's `6_evaluation` protocol end-to-end,
in-process (truvari is not in this image; the matcher is
focalsv_tpu_torch/evaluation/compare.py with the reference's parameters —
`evaluation/Table2-4/truvari_eval_wgs.sh:20-24`: refdist 500, pctsize 0.5,
pctsim 0.5, sizemin 50, INS and DEL evaluated separately).

Subcommands (reference analogs):

    focalsv-tpu-eval bench --call calls.vcf --truth truth.vcf
        one matching run, JSON to stdout (truvari bench analog);
        also the default when no subcommand is given (back-compat).

    focalsv-tpu-eval filter --vcf calls.vcf --out_dir D [--chrs chr21 ...]
        INS/DEL split + XY drop → *_DEL_noXY.vcf / *_INS_noXY.vcf /
        *_DEL_INS_noXY.vcf (6_evaluation/vcf_filter.py).

    focalsv-tpu-eval protocol --call calls.vcf --truth truth.vcf --out_dir D
        the full 6_evaluation/truvari_eval.sh flow: filter both VCFs,
        bench DEL and INS separately, and write the per-type metric table
        `Truvari_results.csv` with the reference parser's row order
        (6_evaluation/truvari_result_parser_indel.py:11-22).
"""

from __future__ import annotations

import argparse
import csv
import json
import os
import sys

# row order of the reference result parser
# (6_evaluation/truvari_result_parser_indel.py:11-22; "FN" appears twice
# there, once in the call block and once in the gt block — kept verbatim)
RESULT_KEYS = [
    "TP-call", "FP", "FN", "recall", "precision", "f1",
    "TP-call_TP-gt", "TP-call_FP-gt", "FN",
    "gt_recall", "gt_precision", "gt_f1",
]


def _bench_one(call_path, truth_path, svtype, refdist, pctsize, pctsim,
               sizemin):
    from focalsv_tpu_torch.evaluation.compare import match_records
    from focalsv_tpu_torch.io.vcf import read_vcf

    _, calls = read_vcf(call_path)
    _, truth = read_vcf(truth_path)
    c = [r for r in calls if r.svtype == svtype]
    t = [r for r in truth if r.svtype == svtype]
    return match_records(c, t, refdist=refdist, pctsize=pctsize,
                         pctsim=pctsim, sizemin=sizemin)


def _summary_col(b) -> list:
    """BenchResult -> the parser's metric column (RESULT_KEYS order)."""
    tp_gt = b.gt_correct
    fp_gt = b.gt_total - b.gt_correct
    gt_recall = tp_gt / max(b.tp + b.fn, 1)
    gt_precision = tp_gt / max(b.tp + b.fp, 1)
    gt_f1 = 2 * gt_precision * gt_recall / max(gt_precision + gt_recall,
                                               1e-9)
    r4 = lambda x: round(x, 4)  # noqa: E731
    return [b.tp, b.fp, b.fn, r4(b.recall), r4(b.precision), r4(b.f1),
            tp_gt, fp_gt, b.fn, r4(gt_recall), r4(gt_precision), r4(gt_f1)]


def _add_bench_args(p):
    p.add_argument("--call", required=True)
    p.add_argument("--truth", required=True)
    p.add_argument("--refdist", type=int, default=500)
    p.add_argument("--pctsize", type=float, default=0.5)
    p.add_argument("--pctsim", type=float, default=0.5)
    p.add_argument("--sizemin", type=int, default=50)


def cmd_bench(args) -> int:
    out = {}
    types = ["INS", "DEL"] if args.svtype == "ALL" else [args.svtype]
    for svtype in types:
        b = _bench_one(args.call, args.truth, svtype, args.refdist,
                       args.pctsize, args.pctsim, args.sizemin)
        out[svtype] = dict(tp=b.tp, fp=b.fp, fn=b.fn,
                           recall=round(b.recall, 4),
                           precision=round(b.precision, 4),
                           f1=round(b.f1, 4),
                           gt_concordance=round(b.gt_concordance, 4))
    print(json.dumps(out, indent=2))
    return 0


def cmd_filter(args) -> int:
    from focalsv_tpu_torch.evaluation.vcf_filter import filter_vcf
    paths = filter_vcf(args.vcf, args.out_dir, chrs=args.chrs,
                       dipcall=args.dipcall)
    print(json.dumps(paths, indent=2))
    return 0


def cmd_protocol(args) -> int:
    from focalsv_tpu_torch.evaluation.vcf_filter import filter_vcf
    os.makedirs(args.out_dir, exist_ok=True)
    call_paths = filter_vcf(args.call, args.out_dir, chrs=args.chrs,
                            dipcall=args.dipcall)
    truth_dir = os.path.join(args.out_dir, "truth")
    truth_paths = filter_vcf(args.truth, truth_dir, chrs=args.chrs)
    cols = {}
    summary = {}
    for svtype in ("INS", "DEL"):
        b = _bench_one(call_paths[svtype], truth_paths[svtype], svtype,
                       args.refdist, args.pctsize, args.pctsim,
                       args.sizemin)
        # reference output dir naming: INS_50_/DEL_50_ (truvari_eval.sh:55-57)
        cols[f"{svtype}_{args.sizemin}_"] = _summary_col(b)
        summary[svtype] = dict(tp=b.tp, fp=b.fp, fn=b.fn,
                               recall=round(b.recall, 4),
                               precision=round(b.precision, 4),
                               f1=round(b.f1, 4))
    out_csv = os.path.join(args.out_dir, "Truvari_results.csv")
    with open(out_csv, "w", newline="") as f:
        # the CSV itself stays byte-compatible with the reference
        # parser's row order (no comment lines: its plotting consumers
        # don't skip them); provenance goes to a sidecar + the JSON
        w = csv.writer(f)
        names = list(cols)
        w.writerow(["metric"] + names)
        for i, key in enumerate(RESULT_KEYS):
            w.writerow([key] + [cols[n][i] for n in names])
    with open(out_csv + ".PROVENANCE.txt", "w") as f:
        f.write("Produced by focalsv-tpu `eval protocol`: an IN-PROCESS "
                "Truvari-protocol analog (evaluation/compare.py matcher "
                "with the reference thresholds).  The truvari binary was "
                "NOT run; do not present these as truvari output.\n")
    print(json.dumps({"results": summary, "table": out_csv,
                      "provenance": "in-process protocol analog"}, indent=2))
    return 0


def main(argv=None) -> int:
    if argv is None:
        argv = sys.argv[1:]
    # back-compat: `focalsv-tpu-eval --call ... --truth ...` == bench
    if argv and argv[0].startswith("--"):
        argv = ["bench"] + list(argv)

    p = argparse.ArgumentParser(prog="focalsv-tpu-eval")
    sub = p.add_subparsers(dest="cmd", required=True)

    pb = sub.add_parser("bench", help="match a call VCF against truth")
    _add_bench_args(pb)
    pb.add_argument("--svtype", choices=["INS", "DEL", "ALL"],
                    default="ALL")
    pb.set_defaults(fn=cmd_bench)

    pf = sub.add_parser("filter", help="INS/DEL split + XY drop")
    pf.add_argument("--vcf", "-v", required=True)
    pf.add_argument("--out_dir", "-o_dir", required=True)
    pf.add_argument("--chrs", nargs="+", default=None)
    pf.add_argument("--dipcall", action="store_true")
    pf.set_defaults(fn=cmd_filter)

    pp = sub.add_parser("protocol",
                        help="filter + per-type bench + result table")
    _add_bench_args(pp)
    pp.add_argument("--out_dir", required=True)
    pp.add_argument("--chrs", nargs="+", default=None)
    pp.add_argument("--dipcall", action="store_true")
    pp.set_defaults(fn=cmd_protocol)

    from focalsv_tpu_torch.evaluation.grid import cmd_grid
    pg = sub.add_parser(
        "grid", help="parameter grid search + heatmap data "
        "(Figure5-6 grid_search.py analog)")
    pg.add_argument("--call", "-c", required=True)
    pg.add_argument("--truth", "-t", required=True)
    pg.add_argument("--out_dir", required=True)
    pg.add_argument("--pctsims", default="0.0,0.25,0.5,0.75,0.9")
    pg.add_argument("--refdists", default="100,250,500,1000,2000")
    pg.add_argument("--sizemin", type=int, default=50)
    pg.add_argument("--pctsize", type=float, default=0.5)
    pg.add_argument("--png", action="store_true",
                    help="also render heatmap PNGs (needs matplotlib)")
    pg.set_defaults(fn=cmd_grid)

    pd = sub.add_parser(
        "figdata", help="per-TP breakpoint-shift + seq-similarity rows "
        "(FigureS31-34 Breakpoint_shift/Sequence_similarity analog)")
    pd.add_argument("--call", "-c", required=True)
    pd.add_argument("--truth", "-t", required=True)
    pd.add_argument("--out_dir", required=True)
    pd.add_argument("--sizemin", type=int, default=50)
    pd.set_defaults(fn=cmd_figdata)

    from focalsv_tpu_torch.evaluation.figures import cmd_figures
    pfig = sub.add_parser(
        "figures", help="render paper figures from emitted data "
        "(Figure3 grid, Figure4 curves, Figure5-6 heatmaps, S31-34 "
        "distributions)")
    pfig.add_argument("--out_dir", required=True)
    pfig.add_argument("--grid-dir", default=None,
                      help="`eval grid` output dir (heatmaps + curves)")
    pfig.add_argument("--details", default=None,
                      help="`eval figdata` tp_match_details.csv "
                      "(shift + similarity distributions)")
    pfig.add_argument("--f1", nargs="+", default=None,
                      metavar="TOOL=PROTOCOL_DIR",
                      help="per-tool `eval protocol` dirs for the "
                      "Figure-3 F1 bar grid")
    pfig.add_argument("--target-tool", default="focalsv-tpu")
    pfig.add_argument("--libname", default="library")
    pfig.set_defaults(fn=cmd_figures)

    args = p.parse_args(argv)
    return args.fn(args)


def cmd_figdata(args) -> int:
    import os

    from focalsv_tpu_torch.evaluation.figdata import (match_detail_rows,
                                                write_rows_csv)
    from focalsv_tpu_torch.io.vcf import read_vcf
    _, calls = read_vcf(args.call)
    _, truth = read_vcf(args.truth)
    rows = match_detail_rows(calls, truth, sizemin=args.sizemin)
    os.makedirs(args.out_dir, exist_ok=True)
    out = os.path.join(args.out_dir, "tp_match_details.csv")
    write_rows_csv(rows, out)
    shifts = [r["shift"] for r in rows]
    sims = [r["seq_similarity"] for r in rows if r["seq_similarity"] != ""]
    print(json.dumps({
        "n_tp": len(rows), "csv": out,
        "shift_mean": round(sum(shifts) / max(len(shifts), 1), 2),
        "seq_sim_mean": round(sum(sims) / max(len(sims), 1), 4)
        if sims else None,
    }))
    return 0


if __name__ == "__main__":
    sys.exit(main())
