"""Truvari-style SV benchmarking used as the internal accuracy gate.

Replicates the matching criteria of the reference's evaluation protocol
(`evaluation/Table2-4/truvari_eval_wgs.sh:20-24`: refdist 500, pctsim 0.5,
pctsize 0.5, sizemin 50 -- here applied in-process on simulated truth sets,
since neither truvari nor the GIAB data ship in this environment).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from focalsv_tpu_torch.io.vcf import VcfRecord
from focalsv_tpu_torch.ops import align as alignops
from focalsv_tpu_torch.ops import encode as enc


@dataclass
class BenchResult:
    tp: int
    fp: int
    fn: int
    gt_correct: int = 0
    gt_total: int = 0

    @property
    def recall(self) -> float:
        return self.tp / max(self.tp + self.fn, 1)

    @property
    def precision(self) -> float:
        return self.tp / max(self.tp + self.fp, 1)

    @property
    def f1(self) -> float:
        p, r = self.precision, self.recall
        return 2 * p * r / max(p + r, 1e-9)

    @property
    def gt_concordance(self) -> float:
        return self.gt_correct / max(self.gt_total, 1)


def _svlen(r: VcfRecord) -> int:
    v = r.info.get("SVLEN")
    if v is not None:
        return abs(int(v))
    return abs(len(r.alt) - len(r.ref))


def _svtype(r: VcfRecord) -> str:
    t = r.info.get("SVTYPE")
    if t:
        return str(t)
    return "DEL" if len(r.ref) > len(r.alt) else "INS"


def match_records(
    calls: list[VcfRecord],
    truth: list[VcfRecord],
    refdist: int = 500,
    pctsize: float = 0.5,
    pctsim: float = 0.5,
    sizemin: int = 50,
    check_seq: bool = True,
    pctovl: float = 0.01,
) -> BenchResult:
    """Globally-greedy scored matching of calls against a truth set.

    Truvari semantics (truvari_eval_wgs.sh:20-24 thresholds: r=500 p=0.5
    P=0.5 S=30 O=0.01): every (truth, call) pair passing the
    refdist/pctsize/pctsim/pctovl gates gets a match score; pairs are
    assigned best-score-first with each truth and each call used once.
    A truth-ORDER greedy pass (r2/r3) could let an earlier truth steal a
    later truth's only match while a worse alternative remained for it --
    the global ordering removes that order dependence.  Score ties break
    by (truth index, call index), the edge-construction order under the
    stable sort -- the contract tests/test_compare_oracle.py pins.

    ``pctovl``: minimum RECIPROCAL overlap for span-consuming types
    (DEL/DUP/INV; truvari -O): ovl/len >= pctovl on BOTH sides.  INS has
    no reference span, so the gate does not apply (truvari semantics)."""
    calls = [c for c in calls if _svlen(c) >= sizemin]
    truth = [t for t in truth if _svlen(t) >= sizemin]
    edges: list[tuple[float, int, int]] = []
    for ti, t in enumerate(truth):
        for i, c in enumerate(calls):
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
            if (check_seq and _svtype(t) == "INS"
                    and len(t.alt) > 1 and len(c.alt) > 1
                    and not t.alt.startswith("<")
                    and not c.alt.startswith("<")):
                sim = alignops.edit_similarity(
                    enc.encode(t.alt[1:]), enc.encode(c.alt[1:]))
                if sim < pctsim:
                    continue
            score = size_sim - abs(c.pos - t.pos) / (10 * refdist)
            edges.append((score, ti, i))
    edges.sort(key=lambda e: -e[0])
    used = np.zeros(len(calls), bool)
    t_done = np.zeros(len(truth), bool)
    tp = 0
    gt_correct = 0
    gt_total = 0
    for _score, ti, i in edges:
        if used[i] or t_done[ti]:
            continue
        used[i] = True
        t_done[ti] = True
        tp += 1
        gt_total += 1
        tgt = truth[ti].gt.replace("|", "/")
        cgt = calls[i].gt.replace("|", "/")
        if {tgt, tgt[::-1]} & {cgt}:
            gt_correct += 1
    fn = len(truth) - tp
    fp = int((~used).sum())
    return BenchResult(tp=tp, fp=fp, fn=fn,
                       gt_correct=gt_correct, gt_total=gt_total)


def truth_from_sim(svs, chrom: str, ref: np.ndarray, ref_offset: int = 0) -> list[VcfRecord]:
    """SimSV truth -> VcfRecords for benchmarking.

    Truth indels are LEFT-ALIGNED (repeat canonicalization) to the same
    space the caller emits -- inside a tandem array every unit boundary is
    an equivalent placement, and comparing a left-aligned call against an
    un-normalized truth position fails refdist for no real reason."""
    from focalsv_tpu_torch.ops.normalize import left_align_del, left_align_ins
    out = []
    for i, sv in enumerate(svs):
        p0 = sv.pos
        ins_seq = sv.seq
        if sv.svtype == "DEL" and 1 <= p0 and p0 + sv.length <= len(ref):
            p0 = left_align_del(ref, p0, sv.length)
        elif sv.svtype == "INS" and 1 <= p0 < len(ref) and sv.seq is not None:
            p0, ins_seq = left_align_ins(ref, p0,
                                         np.asarray(sv.seq, np.uint8))
        pos = p0 + ref_offset
        anchor = enc.decode(ref[p0 - 1 : p0])
        if sv.svtype == "DEL":
            ref_allele = anchor + enc.decode(ref[p0 : p0 + sv.length])
            alt_allele = anchor
            svlen = -sv.length
        else:
            ref_allele = anchor
            alt_allele = anchor + enc.decode(ins_seq)
            svlen = sv.length
        out.append(VcfRecord(
            chrom=chrom, pos=pos, id=f"truth{i}", ref=ref_allele,
            alt=alt_allele, info={"SVTYPE": sv.svtype, "SVLEN": svlen},
            gt=sv.genotype))
    return out
