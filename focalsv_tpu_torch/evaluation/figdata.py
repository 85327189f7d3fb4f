"""Figure-data producers: the measurement half of the reference's plotting
scripts, emitting the CSV/rows each figure consumes.

Reference analogs:
- breakpoint-shift + sequence-similarity distributions of TP calls:
  `evaluation/Supplemantal_FigureS31-34/{Breakpoint_shift.py,
  Sequence_similarity_distribution.py}` -- there computed from truvari
  tp-base/tp-call pairs; here from the in-process matcher's TP pairs.
- phasing performance (phased fraction, phase-block N50, switch errors):
  `evaluation/Supplemantal_FigureS37/phasing_eval.py`,
  `Supplemantal_FigureS39-40` and `Supplemantal_TableS6` -- there measured
  against trio/strand-seq truth haplotypes; here against any truth
  haplotype labeling of the reads (the simulator writes it into read
  names as `sim_h{1,2}_*`; real data would pass a name->hap map from a
  truth-tagged BAM).

Rendering lives in `evaluation/figures.py` (`focalsv-tpu-eval figures`):
these producers emit each figure's DATA; the renderers consume it.
"""

from __future__ import annotations

import csv

import numpy as np

from focalsv_tpu_torch.evaluation.compare import _svlen, _svtype
from focalsv_tpu_torch.io.vcf import VcfRecord
from focalsv_tpu_torch.ops import align as alignops
from focalsv_tpu_torch.ops import encode as enc


def match_detail_rows(
    calls: list[VcfRecord],
    truth: list[VcfRecord],
    refdist: int = 500,
    pctsize: float = 0.5,
    pctsim: float = 0.5,
    sizemin: int = 50,
    pctovl: float = 0.01,
    check_seq: bool = True,
) -> list[dict]:
    """Per-TP detail rows (FigureS31-34 analog): breakpoint shift, size
    ratio, and INS sequence similarity for every matched (truth, call)
    pair under the standard protocol gates (the production matcher's
    globally-greedy assignment, re-derived with detail capture)."""
    calls = [c for c in calls if _svlen(c) >= sizemin]
    truth = [t for t in truth if _svlen(t) >= sizemin]
    edges = []
    for ti, t in enumerate(truth):
        for ci, c in enumerate(calls):
            if c.chrom != t.chrom or _svtype(c) != _svtype(t):
                continue
            if abs(c.pos - t.pos) > refdist:
                continue
            lt, lc = _svlen(t), _svlen(c)
            size_sim = min(lt, lc) / max(lt, lc, 1)
            if size_sim < pctsize:
                continue
            if pctovl > 0 and _svtype(t) != "INS":
                ovl = min(t.pos + lt, c.pos + lc) - max(t.pos, c.pos)
                if ovl < pctovl * lt or ovl < pctovl * lc:
                    continue
            seq_sim = None
            if (check_seq
                    and _svtype(t) == "INS" and len(t.alt) > 1
                    and len(c.alt) > 1
                    and not t.alt.startswith("<")
                    and not c.alt.startswith("<")):
                seq_sim = float(alignops.edit_similarity(
                    enc.encode(t.alt[1:]), enc.encode(c.alt[1:])))
                if seq_sim < pctsim:
                    continue
            score = size_sim - abs(c.pos - t.pos) / (10 * refdist)
            edges.append((score, ti, ci, size_sim, seq_sim))
    edges.sort(key=lambda e: -e[0])
    used_t: set[int] = set()
    used_c: set[int] = set()
    rows = []
    for _s, ti, ci, size_sim, seq_sim in edges:
        if ti in used_t or ci in used_c:
            continue
        used_t.add(ti)
        used_c.add(ci)
        t, c = truth[ti], calls[ci]
        rows.append(dict(
            chrom=t.chrom, svtype=_svtype(t),
            truth_pos=t.pos, call_pos=c.pos,
            shift=abs(c.pos - t.pos),
            truth_len=_svlen(t), call_len=_svlen(c),
            size_ratio=round(size_sim, 4),
            seq_similarity=(round(seq_sim, 4)
                            if seq_sim is not None else ""),
        ))
    return rows


def phasing_stats(reads: list, hp: np.ndarray, ps: np.ndarray,
                  truth_hap=None) -> dict:
    """Phasing performance of one region (FigureS37/S40, TableS6 analog).

    ``truth_hap``: read -> 1|2 truth haplotype; defaults to parsing the
    simulator's `sim_h{1,2}_*` read names.  Switch errors are counted per
    phase block, position-ordered: a switch is a transition in the
    (assigned XOR truth) sequence under the block's best global flip --
    the standard long/short switch-error decomposition's total count."""
    if truth_hap is None:
        def truth_hap(r):
            n = r.name
            return 1 if "_h1_" in n else (2 if "_h2_" in n else 0)
    hp = np.asarray(hp)
    ps = np.asarray(ps)
    n = len(reads)
    phased = [(int(ps[i]), reads[i].pos, int(hp[i]), truth_hap(reads[i]))
              for i in range(n) if hp[i] in (1, 2)]
    phased = [p for p in phased if p[3] in (1, 2)]
    blocks: dict[int, list] = {}
    for b, pos, h, th in phased:
        blocks.setdefault(b, []).append((pos, h, th))
    n_switch = 0
    n_pairs = 0
    n_mismatch = 0
    n_assessed = 0
    spans = []
    for b, rows in blocks.items():
        rows.sort()
        x = np.array([(h == th) for _, h, th in rows], bool)
        # best global flip per block (hap labels are arbitrary per block)
        mism = int(min(x.sum(), (~x).sum()))
        n_mismatch += mism
        n_assessed += len(rows)
        d = x[1:] != x[:-1]
        n_switch += int(d.sum())
        n_pairs += max(len(rows) - 1, 0)
        spans.append(max(p for p, _, _ in rows) - min(p for p, _, _ in rows))
    spans.sort(reverse=True)
    n50 = 0
    if spans:
        half = sum(spans) / 2
        acc = 0
        for s in spans:
            acc += s
            if acc >= half:
                n50 = s
                break
    return dict(
        n_reads=n,
        n_phased=len(phased),
        phased_frac=round(len(phased) / max(n, 1), 4),
        n_blocks=len(blocks),
        block_n50_bp=n50,
        switch_errors=n_switch,
        switch_error_rate=round(n_switch / max(n_pairs, 1), 4),
        hamming_mismatch=n_mismatch,
        hamming_rate=round(n_mismatch / max(n_assessed, 1), 4),
    )


def write_rows_csv(rows: list[dict], path: str) -> None:
    if not rows:
        with open(path, "w") as f:
            f.write("")
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=list(rows[0]))
        w.writeheader()
        w.writerows(rows)
