"""Paper-figure rendering: the plotting half of the reference's evaluation
suite, consuming the data that `grid.py` / `figdata.py` / `cli.py protocol`
emit.

Reference analogs (behavior, not code):
- `evaluation/Figure3_Supplemental_FigureS2/plot_f1_grid.py` +
  `line_bar_plot_multiple_tools.py`: a grid of up to 9 per-library panels,
  one horizontal bar per tool per metric, target tool highlighted,
  panels labeled a..i -> :func:`plot_f1_grid`.
- `evaluation/Figure4_Supplemental_FigureS3-10/plot_truvari_paras.py`:
  metric-vs-parameter curves, one line per tool/config, solid vs dashed
  linestyle per tool family -> :func:`plot_param_curves` (one line per
  held parameter value, drawn from the in-process grid's tidy CSV).
- `evaluation/Figure5-6_Supplemental_FigureS11-30/
  Truvari_results_heatmap_VC.py`: (p, r) F1 heatmaps -> already rendered
  by `grid.render_heatmaps`; re-exported here for one-stop use.
- `evaluation/Supplemantal_FigureS31-34/{Breakpoint_shift.py,
  Sequence_similarity_distribution.py}`: TP breakpoint-shift and INS
  sequence-similarity distributions -> :func:`plot_breakpoint_shift`,
  :func:`plot_seq_similarity`.
- `evaluation/Supplemantal_FigureS37,S39-40` + `Supplemantal_TableS6`
  (phasing performance) -> :func:`plot_phasing_summary`.

All renderers use the Agg backend and write PNG (and PDF when the path
ends in .pdf); each returns the list of files written.  matplotlib ships
in this image; imports stay inside functions so the evaluation package
imports cleanly without it (callers get an empty list, mirroring
`grid.render_heatmaps`).
"""

from __future__ import annotations

import csv
import math
import os
import string

# fixed categorical palette, FocalSV-magenta first (the reference
# highlights its own tool in magenta in every figure: plot_truvari_paras
# color_map); remaining hues follow its Figure3 categorical list.
_PALETTE = ["magenta", "#3cb44b", "#4363d8", "#f58231", "#911eb4",
            "#46f0f0", "#e6194b", "#008080", "#9a6324", "#800000",
            "#808000", "#000075"]


def _mpl():
    try:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt
        matplotlib.rcParams["pdf.fonttype"] = 42
        return plt
    except Exception:
        return None


def plot_f1_grid(panels: list[tuple[str, list[list]]], out_path: str,
                 metric: str = "f1", target_tool: str | None = None,
                 tool_order: list[str] | None = None) -> list[str]:
    """Figure3/S2 analog: up to-9-panel grid, horizontal bars of one
    metric per tool, split by svtype, panels labeled a, b, c, ...

    ``panels``: [(libname, rows)] where rows are `grid.f1_summary_rows`
    output including its header (tool, svtype, recall, precision, f1).
    """
    plt = _mpl()
    if plt is None:
        return []
    n = len(panels)
    cols = min(3, max(n, 1))
    rows_n = math.ceil(n / cols)
    fig, axes = plt.subplots(rows_n, cols, squeeze=False,
                             figsize=(5.5 * cols, 4.0 * rows_n),
                             sharex=True)
    flat = [ax for row in axes for ax in row]
    for ax in flat[n:]:
        ax.axis("off")
    colors: dict[str, str] = {}
    for label, table in panels:
        header = table[0]
        mi = header.index(metric)
        for r in table[1:]:
            colors.setdefault(r[0], None)
    order = tool_order or sorted(colors)
    for i, t in enumerate(order):
        colors[t] = ("magenta" if t == target_tool
                     else _PALETTE[1 + i % (len(_PALETTE) - 1)])
    for pi, (label, table) in enumerate(panels):
        ax = flat[pi]
        header = table[0]
        mi = header.index(metric)
        by_tool: dict[str, dict[str, float]] = {}
        for r in table[1:]:
            by_tool.setdefault(r[0], {})[r[1]] = float(r[mi])
        svtypes = sorted({r[1] for r in table[1:]})
        ys, widths, cs, labels = [], [], [], []
        y = 0.0
        for t in order:
            if t not in by_tool:
                continue
            for sv in svtypes:
                ys.append(y)
                widths.append(by_tool[t].get(sv, 0.0))
                cs.append(colors[t])
                labels.append(f"{t} {sv}")
                y += 1.0
            y += 0.6
        ax.barh(ys, widths, color=cs, height=0.85)
        for yy, w in zip(ys, widths):
            ax.text(min(w + 0.01, 1.02), yy, f"{w:.3f}",
                    va="center", fontsize=7)
        ax.set_yticks(ys, labels, fontsize=8)
        ax.invert_yaxis()
        ax.set_xlim(0, 1.12)
        ax.set_xlabel(metric)
        ax.set_title(f"({string.ascii_lowercase[pi]}) {label}", loc="left")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [out_path]


def plot_param_curves(grid_cells_csv: str, out_dir: str,
                      metric: str = "f1") -> list[str]:
    """Figure4/S3-10 analog from the in-process grid's tidy CSV
    (grid.run_grid's grid_cells.csv): per svtype, metric-vs-refdist
    curves (one line per pctsim) and metric-vs-pctsim curves (one line
    per refdist) — the reference sweeps truvari's -p/-r the same way and
    plots one curve per tool; here the curves expose the protocol's own
    parameter sensitivity for one callset."""
    plt = _mpl()
    if plt is None:
        return []
    with open(grid_cells_csv) as f:
        rows = list(csv.DictReader(f))
    os.makedirs(out_dir, exist_ok=True)
    written = []
    svtypes = sorted({r["svtype"] for r in rows})
    for svtype in svtypes:
        sub = [r for r in rows if r["svtype"] == svtype]
        for xkey, linekey in (("refdist", "pctsim"), ("pctsim", "refdist")):
            fig, ax = plt.subplots(figsize=(7, 4.5))
            lines = sorted({float(r[linekey]) for r in sub})
            for i, lv in enumerate(lines):
                pts = sorted((float(r[xkey]), float(r[metric]))
                             for r in sub if float(r[linekey]) == lv)
                ax.plot([p[0] for p in pts], [p[1] for p in pts],
                        marker="o", label=f"{linekey}={lv:g}",
                        color=_PALETTE[i % len(_PALETTE)])
            ax.set_ylim(0, 1.0)
            ax.set_xlabel(xkey)
            ax.set_ylabel(metric)
            ax.set_title(f"{svtype}: {metric} vs {xkey}")
            ax.legend(fontsize=8)
            ax.grid(alpha=0.3)
            path = os.path.join(out_dir, f"curves_{svtype}_{xkey}.png")
            fig.savefig(path, dpi=130, bbox_inches="tight")
            plt.close(fig)
            written.append(path)
    return written


def plot_breakpoint_shift(detail_rows: list[dict] | str, out_path: str,
                          max_shift: int = 500) -> list[str]:
    """FigureS31-32 analog: histogram + CDF of |call_pos - truth_pos|
    over the TP pairs (figdata.match_detail_rows)."""
    plt = _mpl()
    if plt is None:
        return []
    rows = _load_rows(detail_rows)
    shifts = [min(int(float(r["shift"])), max_shift) for r in rows]
    fig, (ax, ax2) = plt.subplots(1, 2, figsize=(10, 4))
    if shifts:
        ax.hist(shifts, bins=min(50, max(10, len(set(shifts)))),
                color=_PALETTE[2], edgecolor="white")
        xs = sorted(shifts)
        ax2.plot(xs, [i / len(xs) for i in range(1, len(xs) + 1)],
                 color="magenta")
    ax.set_xlabel(f"breakpoint shift (bp, capped {max_shift})")
    ax.set_ylabel("TP count")
    ax2.set_xlabel("breakpoint shift (bp)")
    ax2.set_ylabel("cumulative fraction")
    ax2.set_ylim(0, 1.02)
    ax2.grid(alpha=0.3)
    fig.suptitle("TP breakpoint-shift distribution")
    fig.tight_layout()
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [out_path]


def plot_seq_similarity(detail_rows: list[dict] | str,
                        out_path: str) -> list[str]:
    """FigureS33-34 analog: INS TP sequence-similarity histogram."""
    plt = _mpl()
    if plt is None:
        return []
    rows = _load_rows(detail_rows)
    sims = [float(r["seq_similarity"]) for r in rows
            if r.get("seq_similarity", "") not in ("", None)]
    fig, ax = plt.subplots(figsize=(6, 4))
    if sims:
        ax.hist(sims, bins=20, range=(0, 1), color=_PALETTE[1],
                edgecolor="white")
    ax.set_xlabel("INS sequence similarity (edit)")
    ax.set_ylabel("TP count")
    ax.set_title("TP INS sequence-similarity distribution")
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [out_path]


def plot_phasing_summary(stats_by_label: dict[str, dict],
                         out_path: str) -> list[str]:
    """FigureS37/S39-40 + TableS6 analog: per-label bars of phased
    fraction, phase-block N50, and switch-error rate
    (figdata.phasing_stats dicts, e.g. one per dtype or region set)."""
    plt = _mpl()
    if plt is None:
        return []
    labels = list(stats_by_label)
    panels = [("phased_frac", "phased fraction", 1.0),
              ("block_n50_bp", "phase-block N50 (bp)", None),
              ("switch_error_rate", "switch-error rate", None)]
    fig, axes = plt.subplots(1, 3, figsize=(12, 3.8))
    for ax, (key, title, ymax) in zip(axes, panels):
        vals = [float(stats_by_label[lb].get(key, 0)) for lb in labels]
        ax.bar(range(len(labels)), vals,
               color=[_PALETTE[i % len(_PALETTE)]
                      for i in range(len(labels))])
        ax.set_xticks(range(len(labels)), labels, rotation=30,
                      ha="right", fontsize=8)
        ax.set_title(title, fontsize=10)
        if ymax is not None:
            ax.set_ylim(0, ymax * 1.05)
        for i, v in enumerate(vals):
            ax.text(i, v, f"{v:g}", ha="center", va="bottom", fontsize=7)
    fig.tight_layout()
    fig.savefig(out_path, dpi=130, bbox_inches="tight")
    plt.close(fig)
    return [out_path]


def _load_rows(rows_or_csv) -> list[dict]:
    if isinstance(rows_or_csv, str):
        with open(rows_or_csv) as f:
            return list(csv.DictReader(f))
    return list(rows_or_csv)


def cmd_figures(args) -> int:
    """CLI: render every figure whose input artifact is present."""
    import json

    os.makedirs(args.out_dir, exist_ok=True)
    written: list[str] = []
    if args.grid_dir:
        from focalsv_tpu_torch.evaluation.grid import render_heatmaps
        written += render_heatmaps(args.grid_dir)
        cells = os.path.join(args.grid_dir, "grid_cells.csv")
        if os.path.exists(cells):
            written += plot_param_curves(cells, args.out_dir)
    if args.details:
        written += plot_breakpoint_shift(
            args.details, os.path.join(args.out_dir, "breakpoint_shift.png"))
        written += plot_seq_similarity(
            args.details, os.path.join(args.out_dir, "seq_similarity.png"))
    if args.f1:
        from focalsv_tpu_torch.evaluation.grid import f1_summary_rows
        dirs = dict(kv.split("=", 1) for kv in args.f1)
        rows = f1_summary_rows(dirs)
        written += plot_f1_grid(
            [(args.libname, rows)],
            os.path.join(args.out_dir, "f1_grid.png"),
            target_tool=args.target_tool)
    print(json.dumps({"written": written}))
    return 0 if written else 1
