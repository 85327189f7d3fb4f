"""Truvari-parameter grid search + figure-data emission (in-process).

Analog of the reference's paper-figure machinery
(`evaluation/Figure5-6_Supplemental_FigureS11-30/grid_search.py`: truvari
bench over a (p, r) / (p, O) parameter grid, one summary per cell, then
heatmaps; `Figure3_Supplemental_FigureS2/plot_f1_grid.py`: per-tool F1
grids).  truvari itself is not in this image, so every cell runs this
framework's protocol matcher (evaluation/compare.py) with the reference's
thresholds; the output is the heatmap's DATA (a tidy CSV grid per svtype),
which is what the plotting scripts consume.

Matplotlib rendering is optional (``--png``): the CSVs are the deliverable
the reference's figure scripts derive from.
"""

from __future__ import annotations

import csv
import json
import os

from focalsv_tpu_torch.evaluation.compare import match_records
from focalsv_tpu_torch.io.vcf import read_vcf


def run_grid(
    call_vcf: str,
    truth_vcf: str,
    out_dir: str,
    pctsims: tuple[float, ...] = (0.0, 0.25, 0.5, 0.75, 0.9),
    refdists: tuple[int, ...] = (100, 250, 500, 1000, 2000),
    sizemin: int = 50,
    pctsize: float = 0.5,
) -> dict:
    """Protocol-matcher sweep over (pctsim, refdist) per svtype.

    Writes ``grid_<SVTYPE>.csv`` (rows = pctsim, cols = refdist, cells =
    F1) plus a tidy ``grid_cells.csv`` with every cell's tp/fp/fn/recall/
    precision/f1 -- the reference stores one truvari summary.json per cell
    (grid_search.py) and heatmaps the F1s; this emits the same grid in one
    pass.  Returns {svtype: {(pctsim, refdist): f1}}.
    """
    os.makedirs(out_dir, exist_ok=True)
    _, calls = read_vcf(call_vcf)
    _, truth = read_vcf(truth_vcf)

    def one_type(svtype):
        cs = [r for r in calls if (r.svtype or "") == svtype]
        ts = [r for r in truth if (r.svtype or "") == svtype]
        return cs, ts

    grids: dict[str, dict] = {}
    tidy_rows = []
    for svtype in ("DEL", "INS"):
        cs, ts = one_type(svtype)
        grid = {}
        for ps in pctsims:
            for rd in refdists:
                b = match_records(cs, ts, refdist=rd, pctsize=pctsize,
                                  pctsim=ps, sizemin=sizemin,
                                  check_seq=ps > 0)
                grid[(ps, rd)] = b
                tidy_rows.append([svtype, ps, rd, b.tp, b.fp, b.fn,
                                  round(b.recall, 4), round(b.precision, 4),
                                  round(b.f1, 4)])
        grids[svtype] = grid
        with open(os.path.join(out_dir, f"grid_{svtype}.csv"), "w",
                  newline="") as f:
            w = csv.writer(f)
            w.writerow(["pctsim\\refdist"] + [str(r) for r in refdists])
            for ps in pctsims:
                w.writerow([ps] + [round(grid[(ps, rd)].f1, 4)
                                   for rd in refdists])
    with open(os.path.join(out_dir, "grid_cells.csv"), "w", newline="") as f:
        w = csv.writer(f)
        w.writerow(["svtype", "pctsim", "refdist", "tp", "fp", "fn",
                    "recall", "precision", "f1"])
        w.writerows(tidy_rows)
    return {sv: {k: b.f1 for k, b in g.items()} for sv, g in grids.items()}


def render_heatmaps(out_dir: str) -> list[str]:
    """Optional PNG heatmaps from the grid CSVs (Truvari_results_heatmap_VC
    analog); returns written paths, empty if matplotlib is unavailable."""
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        import numpy as np
    except Exception:
        return []
    written = []
    for svtype in ("DEL", "INS"):
        path = os.path.join(out_dir, f"grid_{svtype}.csv")
        if not os.path.exists(path):
            continue
        with open(path) as f:
            rows = list(csv.reader(f))
        cols = rows[0][1:]
        ys = [r[0] for r in rows[1:]]
        data = np.array([[float(x) for x in r[1:]] for r in rows[1:]])
        fig, ax = plt.subplots(figsize=(1.2 + 0.8 * len(cols),
                                        1.0 + 0.6 * len(ys)))
        im = ax.imshow(data, vmin=0, vmax=1, cmap="viridis", aspect="auto")
        ax.set_xticks(range(len(cols)), cols)
        ax.set_yticks(range(len(ys)), ys)
        ax.set_xlabel("refdist")
        ax.set_ylabel("pctsim")
        ax.set_title(f"{svtype} F1")
        for i in range(len(ys)):
            for j in range(len(cols)):
                ax.text(j, i, f"{data[i, j]:.2f}", ha="center", va="center",
                        color="w" if data[i, j] < 0.6 else "k", fontsize=7)
        fig.colorbar(im)
        png = os.path.join(out_dir, f"grid_{svtype}.png")
        fig.savefig(png, dpi=120, bbox_inches="tight")
        plt.close(fig)
        written.append(png)
    return written


def f1_summary_rows(result_dirs: dict[str, str]) -> list[list]:
    """Figure-3-style per-tool F1 table rows from `eval protocol` output
    dirs ({tool_name: out_dir with Truvari_results.csv}) -- the data
    behind line_bar_plot_multiple_tools.py."""
    rows = [["tool", "svtype", "recall", "precision", "f1"]]
    for tool, d in sorted(result_dirs.items()):
        path = os.path.join(d, "Truvari_results.csv")
        with open(path) as f:
            lines = [ln for ln in f.read().splitlines()
                     if not ln.startswith("#")]
        table = list(csv.reader(lines))
        header = table[0]
        by_metric = {r[0]: r[1:] for r in table[1:]}
        for ci, name in enumerate(header[1:]):
            svtype = name.split("_")[0]
            rows.append([
                tool, svtype,
                by_metric["recall"][ci], by_metric["precision"][ci],
                by_metric["f1"][ci]])
    return rows


def cmd_grid(args) -> int:
    grids = run_grid(args.call, args.truth, args.out_dir,
                     pctsims=tuple(float(x) for x in args.pctsims.split(",")),
                     refdists=tuple(int(x) for x in args.refdists.split(",")),
                     sizemin=args.sizemin, pctsize=args.pctsize)
    pngs = render_heatmaps(args.out_dir) if args.png else []
    best = {sv: max(g, key=g.get) for sv, g in grids.items() if g}
    print(json.dumps({
        "out_dir": args.out_dir,
        "best": {sv: {"pctsim": k[0], "refdist": k[1],
                      "f1": round(grids[sv][k], 4)}
                 for sv, k in best.items()},
        "png": pngs,
    }, indent=2))
    return 0
