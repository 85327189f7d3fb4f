"""Seed-chain-extend aligner: the framework's minimap2/ksw2 replacement.

Pipeline per (query, target): minimizer seeding (ops/minimizer.py) ->
gap-cost chaining (ops/chain.py) -> piecewise banded affine DP between chain
anchors (ops/align.py) -> spliced BAM-convention CIGAR.  Multiple chains
yield primary + supplementary alignments, preserving the split-alignment
geometry the complex-SV callers consume (reference usage:
DipPAV_variant_call.py:103 `minimap2 -a -x asm5`, call_DUP_from_contigs.py:114
`-x asm10`, align_ins2ref.py:64 `map-hifi`).

Gap sub-alignments are independent small banded DPs; on TPU they batch into
bucketed `banded_align_batch` calls so the whole region batch's gap fills run
as one compiled kernel per bucket.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu import native
from focalsv_tpu.config import AlignConfig
from focalsv_tpu.io import bam as bamio
from focalsv_tpu_torch.ops import align as alignops
from focalsv_tpu.ops import chain as chainops
from focalsv_tpu.ops import encode as enc
from focalsv_tpu.ops.minimizer import MinimizerIndex, minimizers


@dataclass
class Alignment:
    """One aligned segment, BAM conventions (CIGAR on the stored strand)."""

    q_name: str
    t_name: str
    t_start: int                 # 0-based
    strand: int                  # 0 fwd, 1 rev
    cigar: list[tuple[int, int]]
    score: float
    mapq: int = 60
    is_supplementary: bool = False
    q_len: int = 0

    @property
    def t_end(self) -> int:
        return self.t_start + sum(l for op, l in self.cigar
                                  if bamio.CONSUMES_REF[op])

    @property
    def q_start(self) -> int:
        """Start of aligned part on the stored (possibly revcomp'd) strand."""
        if self.cigar and self.cigar[0][0] == bamio.CSOFT_CLIP:
            return self.cigar[0][1]
        return 0

    @property
    def q_end(self) -> int:
        clip = self.cigar[-1][1] if self.cigar and self.cigar[-1][0] == bamio.CSOFT_CLIP else 0
        return self.q_len - clip

    def sa_tag_entry(self, ref_name: str | None = None) -> str:
        """SA-tag style description: rname,pos(1-based),strand,CIGAR,mapQ,NM;"""
        cig = "".join(f"{l}{'MIDNSHP=X'[op]}" for op, l in self.cigar)
        return (f"{ref_name or self.t_name},{self.t_start + 1},"
                f"{'-' if self.strand else '+'},{cig},{self.mapq},0;")


def _merge_ops(ops: list[tuple[int, int]]) -> list[tuple[int, int]]:
    out: list[tuple[int, int]] = []
    for op, ln in ops:
        if ln <= 0:
            continue
        if out and out[-1][0] == op:
            out[-1] = (op, out[-1][1] + ln)
        else:
            out.append((op, ln))
    return out


def implied_alignments(
    q_name: str, q_len: int,
    segments: list[tuple[int, list[tuple[int, int]]]],
    t_name: str = "ref",
) -> list[Alignment]:
    """Alignment objects from a contig's construction-implied segments
    (assembly/consensus.py::stitch_contig_segments).

    Guided-consensus contigs are built column-by-column from the region
    reference, so their placement is known without re-alignment; mapq is the
    aligner's unambiguous-placement value (the reference's minimap2 gives the
    same contigs ~60, DipPAV mapq gates are 50/50).  The segment with the
    longest aligned span is primary, mirroring the aligner's best-chain rule.
    """
    out: list[Alignment] = []
    for t0, cig in segments:
        aligned = sum(l for op, l in cig if op == bamio.CMATCH)
        out.append(Alignment(
            q_name=q_name, t_name=t_name, t_start=int(t0), strand=0,
            cigar=[(int(op), int(ln)) for op, ln in cig],
            score=float(aligned), mapq=60, q_len=q_len))
    if out:
        primary = max(range(len(out)), key=lambda i: out[i].score)
        for i, a in enumerate(out):
            a.is_supplementary = i != primary
    return out


class Aligner:
    """Reusable aligner against one target sequence (e.g. a region reference)."""

    def __init__(self, target: np.ndarray, cfg: AlignConfig = AlignConfig(),
                 t_name: str = "ref"):
        self.cfg = cfg
        self.target = np.asarray(target, np.uint8)
        self.t_name = t_name
        self.index = MinimizerIndex.build(self.target, k=cfg.k, w=cfg.w)

    # -- gap DP -------------------------------------------------------------

    def _gap_cigar(self, qseg: np.ndarray, tseg: np.ndarray) -> list[tuple[int, int]]:
        lq, lt = len(qseg), len(tseg)
        if lq == 0 and lt == 0:
            return []
        if lq == 0:
            return [(bamio.CDEL, lt)]
        if lt == 0:
            return [(bamio.CINS, lq)]
        if lq == lt and lq <= 32:
            return [(bamio.CMATCH, lq)]
        band = alignops.band_bucket(abs(lq - lt) + 64)
        c = self.cfg
        _, cig = alignops.banded_align_pair(
            qseg, tseg, band=band, match=c.match, mismatch=c.mismatch,
            gap_open=c.gap_open, gap_extend=c.gap_extend)
        return cig

    def _op_scores(self, cig, qseg, tseg) -> list[float]:
        """Per-op alignment score contributions for flank trimming."""
        c = self.cfg
        out = []
        i = j = 0
        for op, ln in cig:
            if op == bamio.CMATCH:
                qq, tt = qseg[i : i + ln], tseg[j : j + ln]
                m = int(((qq == tt) & (qq < 4)).sum())
                out.append(c.match * m + c.mismatch * (ln - m))
                i += ln
                j += ln
            elif op == bamio.CINS:
                out.append(c.gap_open + c.gap_extend * (ln - 1))
                i += ln
            elif op == bamio.CDEL:
                out.append(c.gap_open + c.gap_extend * (ln - 1))
                j += ln
            else:
                out.append(0.0)
                i += ln
        return out

    def _trim_leading(self, cig, qseg, tseg):
        """Drop the leading portion of a flank alignment where cumulative
        score is minimal (junk flank -> soft clip + t_start shift).
        Returns (cigar, q_clipped, t_skipped)."""
        if not cig:
            return cig, 0, 0
        sc = self._op_scores(cig, qseg, tseg)
        run = 0.0
        best, best_idx = 0.0, 0
        for idx, s in enumerate(sc):
            run += s
            if run < best:
                best, best_idx = run, idx + 1
        if best_idx == 0:
            return cig, 0, 0
        qc = sum(l for op, l in cig[:best_idx] if bamio.CONSUMES_QUERY[op])
        tc = sum(l for op, l in cig[:best_idx] if bamio.CONSUMES_REF[op])
        return cig[best_idx:], qc, tc

    # -- chain -> alignment -------------------------------------------------

    def _chain_to_alignment(self, q: np.ndarray, q_rc: np.ndarray,
                            ch: chainops.Chain, q_name: str) -> Alignment:
        k = self.cfg.k
        qs = q_rc if ch.rel_strand else q
        anchors = ch.anchors
        # keep spaced anchors (both deltas >= k) so M(k) blocks never overlap
        idx = native.space_anchors(anchors[:, 0], anchors[:, 1], k)
        if idx is None:
            spaced = [0]
            for i in range(1, anchors.shape[0]):
                prev = anchors[spaced[-1]]
                if anchors[i, 0] - prev[0] >= k and anchors[i, 1] - prev[1] >= k:
                    spaced.append(i)
            idx = np.asarray(spaced)
        a = anchors[idx]
        ops: list[tuple[int, int]] = []
        t0, q0 = int(a[0, 0]), int(a[0, 1])
        # prefix: align (up to flank_extend bases of) the query prefix into a
        # window before the first anchor; anything further is soft-clipped --
        # split chains (SV geometry) keep their clips like minimap2 output
        max_ext = self.cfg.flank_extend
        clip0 = max(0, q0 - max_ext)
        pre_q = qs[clip0:q0]
        win_start = max(0, t0 - len(pre_q) - 64)
        t_start = t0
        if len(pre_q):
            pre_t = self.target[win_start:t0]
            cig = self._gap_cigar(pre_q, pre_t)
            # leading DEL (target before the query starts) is free -- drop it
            stripped = 0
            if cig and cig[0][0] == bamio.CDEL:
                stripped = cig[0][1]
                cig = cig[1:]
            # score-trim the junk head of the flank (z-drop analog)
            cig, qclip, _tskip = self._trim_leading(cig, pre_q, pre_t[stripped:])
            t_start = t0 - sum(l for op, l in cig if bamio.CONSUMES_REF[op])
            clip0 += qclip
            ops.extend(cig)
        if clip0 > 0:
            ops = [(bamio.CSOFT_CLIP, clip0)] + ops
        # walk anchor gaps with an accumulated M run: the overwhelming
        # majority are colinear (dq == dt) or pure indels, so the loop only
        # visits irregular gaps; the M runs between them come from a prefix
        # sum (hot path: no per-anchor Python iteration)
        dts = np.diff(a[:, 0]) - k
        dqs = np.diff(a[:, 1]) - k
        regular = (dqs == dts) & (dqs <= 32)
        # csum[g] = total M contributed by gaps [0, g) if all were regular
        csum = np.concatenate([[0], np.cumsum(dqs + k)])

        def emit_m(length: int):
            if length > 0:
                if ops and ops[-1][0] == bamio.CMATCH:
                    ops[-1] = (bamio.CMATCH, ops[-1][1] + length)
                else:
                    ops.append((bamio.CMATCH, length))

        run_start = 0     # first gap index of the current regular stretch
        for g in np.flatnonzero(~regular):
            g = int(g)
            emit_m(k + int(csum[g] - csum[run_start]))
            dt_, dq_ = int(dts[g]), int(dqs[g])
            if dq_ == 0:
                ops.append((bamio.CDEL, dt_))
            elif dt_ == 0:
                ops.append((bamio.CINS, dq_))
            else:
                tp, qp = int(a[g, 0]) + k, int(a[g, 1]) + k
                tn, qn = int(a[g + 1, 0]), int(a[g + 1, 1])
                ops.extend(self._gap_cigar(qs[qp:qn], self.target[tp:tn]))
            run_start = g + 1
        emit_m(k + int(csum[len(dqs)] - csum[run_start]))
        # suffix
        q_last = int(a[-1, 1]) + k
        t_last = int(a[-1, 0]) + k
        clip1 = max(0, len(qs) - q_last - max_ext)
        suf_q = qs[q_last : len(qs) - clip1]
        if len(suf_q):
            win_end = min(self.index.target_len, t_last + len(suf_q) + 64)
            # align reversed so surplus target becomes a *leading* D run
            # (ties break toward leading D), then strip it and un-reverse
            suf_t = self.target[t_last:win_end]
            cig = self._gap_cigar(suf_q[::-1], suf_t[::-1])
            stripped = 0
            if cig and cig[0][0] == bamio.CDEL:
                stripped = cig[0][1]
                cig = cig[1:]
            cig, qclip, _ = self._trim_leading(
                cig, suf_q[::-1], suf_t[::-1][stripped:])
            clip1 += qclip
            ops.extend(cig[::-1])
        if clip1 > 0:
            ops.append((bamio.CSOFT_CLIP, clip1))
        ops = _merge_ops(ops)
        # BAM convention: unaligned query flanks are soft clips, not I ops
        if ops and ops[0][0] == bamio.CINS:
            ops[0] = (bamio.CSOFT_CLIP, ops[0][1])
        if ops and ops[-1][0] == bamio.CINS:
            ops[-1] = (bamio.CSOFT_CLIP, ops[-1][1])
        score = self._score_cigar(ops, qs, t_start)
        return Alignment(
            q_name=q_name, t_name=self.t_name, t_start=t_start,
            strand=ch.rel_strand, cigar=ops, score=score, q_len=len(q))

    def _score_cigar(self, ops, qs, t_start) -> float:
        c = self.cfg
        s = 0
        i, j = 0, t_start
        for op, ln in ops:
            if op == bamio.CMATCH:
                qseg = qs[i : i + ln]
                tseg = self.target[j : j + ln]
                m = int(((qseg == tseg) & (qseg < 4)).sum())
                s += c.match * m + c.mismatch * (ln - m)
                i += ln
                j += ln
            elif op == bamio.CINS:
                s += c.gap_open + c.gap_extend * (ln - 1)
                i += ln
            elif op == bamio.CDEL:
                s += c.gap_open + c.gap_extend * (ln - 1)
                j += ln
            elif op == bamio.CSOFT_CLIP:
                i += ln
        return float(s)

    # -- public -------------------------------------------------------------

    def align(self, query: np.ndarray, q_name: str = "query",
              min_chain_score: float | None = None) -> list[Alignment]:
        q = np.asarray(query, np.uint8)
        cfg = self.cfg
        pos, h, strand = minimizers(q, cfg.k, cfg.w)
        anchors = self.index.lookup(pos, h, strand, max_hits=cfg.max_seed_hits)
        if anchors.shape[0] == 0:
            return []
        chains = chainops.chain_anchors(
            anchors, cfg.k, max_pred=cfg.chain_max_pred,
            max_gap=cfg.chain_max_gap,
            min_score=min_chain_score if min_chain_score is not None else cfg.chain_min_score,
            min_anchors=cfg.chain_min_anchors, q_len=len(q),
            split_gap=cfg.chain_split_gap)
        if not chains:
            return []
        q_rc = enc.revcomp(q)
        out: list[Alignment] = []
        for idx, ch in enumerate(chains):
            aln = self._chain_to_alignment(q, q_rc, ch, q_name)
            aln.is_supplementary = idx > 0
            out.append(aln)
        # mapq per segment from the score ratio against its best
        # QUERY-OVERLAPPING competitor (minimap2 semantics): segments of a
        # chimeric/split alignment cover disjoint query intervals, compete
        # with nothing, and keep a high mapq -- a blanket supplementary cap
        # would kill the split-signature SV route downstream
        # (signatures/contig.py gates split geometry at min_mapq_split=50,
        # mirroring reference CCS :680 where minimap2 supplies real mapqs)
        def q_iv(a: Alignment) -> tuple[int, int]:
            # aligned query interval on the ORIGINAL strand
            if a.strand:
                return a.q_len - a.q_end, a.q_len - a.q_start
            return a.q_start, a.q_end

        # ratio over CHAIN scores (always positive), not DP scores: a clean
        # alignment containing one huge indel has a negative affine score but
        # an unambiguous placement
        ivs = [q_iv(a) for a in out]
        for i, a in enumerate(out):
            s1 = max(float(chains[i].score), 1.0)
            best2 = float(chains[i].sub_score)
            for j, b in enumerate(out):
                if j == i:
                    continue
                olp = min(ivs[i][1], ivs[j][1]) - max(ivs[i][0], ivs[j][0])
                shorter = max(1, min(ivs[i][1] - ivs[i][0],
                                     ivs[j][1] - ivs[j][0]))
                if olp > 0.5 * shorter:
                    best2 = max(best2, float(chains[j].score))
            ratio = max(0.0, 1.0 - best2 / s1)
            a.mapq = int(min(60, 60 * ratio + 6))
        return out

    def to_bam_record(self, aln: Alignment, query: np.ndarray,
                      others: list[Alignment] | None = None) -> bamio.BamRecord:
        """Convert to a BamRecord (revcomp'd seq for rev-strand, SA tag)."""
        q = np.asarray(query, np.uint8)
        seq = enc.revcomp(q) if aln.strand else q
        flag = (bamio.FLAG_REVERSE if aln.strand else 0) | (
            bamio.FLAG_SUPPLEMENTARY if aln.is_supplementary else 0)
        tags = {}
        if others:
            sa = "".join(o.sa_tag_entry() for o in others if o is not aln)
            if sa:
                tags["SA"] = sa
        return bamio.BamRecord(
            name=aln.q_name, flag=flag, ref_id=0, pos=aln.t_start,
            mapq=aln.mapq, cigar=np.array(aln.cigar, np.int32).reshape(-1, 2),
            seq=seq, qual=np.full(len(seq), 40, np.uint8), tags=tags)
