"""Reference-guided haplotype consensus: pileup majority + insertion voting.

The region-scale replacement for hifiasm/Flye/Shasta (reference runs one
assembler process per phase-block FASTA, `3_assembly/run_assembly.py:15-28`).
Reads arrive pre-aligned (the pipeline input is an aligned BAM, as FocalSV's
is), so within one haplotype's read set the consensus is a *column vote*:

- matrix vote per reference column over {A,C,G,T, DELETED} captures
  deletions exactly (every spanning read votes the D symbol);
- insertion candidates (CIGAR I ops) are position-clustered; a cluster
  supported by >= ins_frac of local depth contributes its medoid-length
  sequence at that column.

This is O(reads x length) vectorized work with no graph construction --
appropriate because FocalSV regions are small (~10-100 kb) and haplotype read
sets tiny; accuracy gate is Truvari parity of the resulting SVs, not contig
identity with hifiasm (SURVEY.md section 7 step 6).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from focalsv_tpu.config import AssemblyConfig
from focalsv_tpu.io import bam as bamio

DEL_SYM = 254
NOCOV = 255


def pileup_with_dels(
    reads: list[bamio.BamRecord], idxs: list[int],
    region_start: int, region_len: int,
) -> tuple[np.ndarray, list[tuple[int, int, np.ndarray]]]:
    """Returns (matrix (n, L) uint8 with DEL_SYM/NOCOV, insertions list of
    (region_pos, read_idx, seq))."""
    mat = np.full((len(idxs), region_len), NOCOV, np.uint8)
    inss: list[tuple[int, int, np.ndarray]] = []
    for mi, ri in enumerate(idxs):
        rec = reads[ri]
        rpos = rec.pos - region_start
        qpos = 0
        for op, ln in rec.cigar:
            if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
                a = max(0, -rpos)
                b = min(ln, region_len - rpos)
                if b > a:
                    mat[mi, rpos + a : rpos + b] = rec.seq[qpos + a : qpos + b]
                rpos += ln
                qpos += ln
            elif op == bamio.CINS:
                if 0 <= rpos < region_len:
                    inss.append((rpos, mi, rec.seq[qpos : qpos + ln].copy()))
                qpos += ln
            elif op == bamio.CSOFT_CLIP:
                qpos += ln
            elif op in (bamio.CDEL, bamio.CREF_SKIP):
                a = max(0, -rpos)
                b = min(ln, region_len - rpos)
                if b > a:
                    mat[mi, rpos + a : rpos + b] = DEL_SYM
                rpos += ln
    return mat, inss


def compact_pileup_rows(
    reads: list[bamio.BamRecord], idxs: list[int],
    region_start: int, region_len: int,
) -> tuple[list[np.ndarray], np.ndarray, list[tuple[int, int, np.ndarray]]]:
    """Compact per-read pileup rows: each read's covered region columns are
    a CONTIGUOUS span [start, start+len(row)), so the dense (R, L) matrix --
    ~90% NOCOV for long regions -- never materializes on the host.  Returns
    (rows, starts (R,) int32, insertions as in pileup_with_dels).  The
    device expands rows into the (R, L) tile with one gather
    (parallel/region_step.py::phase_consensus_rows_packed)."""
    rows: list[np.ndarray] = []
    starts = np.zeros(len(idxs), np.int32)
    inss: list[tuple[int, int, np.ndarray]] = []
    for mi, ri in enumerate(idxs):
        rec = reads[ri]
        rpos = rec.pos - region_start
        r0 = max(0, rpos)
        r1 = min(region_len, rec.reference_end - region_start)
        if r1 <= r0:
            rows.append(np.zeros(0, np.uint8))
            continue
        row = np.full(r1 - r0, NOCOV, np.uint8)
        starts[mi] = r0
        qpos = 0
        for op, ln in rec.cigar:
            if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
                a = max(0, r0 - rpos)
                b = min(ln, region_len - rpos)
                if b > a:
                    row[rpos + a - r0 : rpos + b - r0] = \
                        rec.seq[qpos + a : qpos + b]
                rpos += ln
                qpos += ln
            elif op == bamio.CINS:
                if 0 <= rpos < region_len:
                    inss.append((rpos, mi, rec.seq[qpos : qpos + ln].copy()))
                qpos += ln
            elif op == bamio.CSOFT_CLIP:
                qpos += ln
            elif op in (bamio.CDEL, bamio.CREF_SKIP):
                a = max(0, r0 - rpos)
                b = min(ln, region_len - rpos)
                if b > a:
                    row[rpos + a - r0 : rpos + b - r0] = DEL_SYM
                rpos += ln
        rows.append(row)
    return rows, starts, inss


class SpanValid:
    """Column-validity view over contiguous-cover rows: supports the
    ``valid[:, col]`` lookups that decide_insertions and
    clip_insertion_candidates perform, without materializing the (n, L)
    boolean matrix (268 MB at 1024 reads x 256 kb)."""

    def __init__(self, starts: np.ndarray, ends: np.ndarray):
        self.starts = np.asarray(starts, np.int64)
        self.ends = np.asarray(ends, np.int64)

    def __getitem__(self, key):
        rows, col = key
        st = self.starts[rows]
        en = self.ends[rows]
        return (st <= col) & (col < en)


def _column_vote(mat: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """(consensus symbol per column, coverage per column)."""
    L = mat.shape[1]
    counts = np.zeros((L, 6), np.int32)  # A C G T N DEL
    for b in range(5):
        counts[:, b] = (mat == b).sum(axis=0)
    counts[:, 5] = (mat == DEL_SYM).sum(axis=0)
    cov = counts.sum(axis=1)
    best = counts.argmax(axis=1)
    return best.astype(np.uint8), cov


def _cluster_insertions(
    inss: list[tuple[int, int, np.ndarray]], max_dist: int = 20,
) -> list[tuple[int, list[np.ndarray]]]:
    """Group insertion events by nearby positions -> (position, seqs).

    Within one cluster each read contributes ONE candidate sequence: a
    read's multiple nearby I ops concatenate onto *that read's own* entry
    (tracked per read, so interleaved reads never produce chimeras)."""
    if not inss:
        return []
    inss = sorted(inss, key=lambda x: x[0])
    out: list[tuple[int, list[np.ndarray]]] = []
    cur_pos = inss[0][0]
    cur_seqs: list[np.ndarray] = [inss[0][2]]
    cur_read_idx: dict[int, int] = {inss[0][1]: 0}
    for pos, mi, seq in inss[1:]:
        if pos - cur_pos <= max_dist:
            if mi in cur_read_idx:
                k = cur_read_idx[mi]
                cur_seqs[k] = np.concatenate([cur_seqs[k], seq])
            else:
                cur_read_idx[mi] = len(cur_seqs)
                cur_seqs.append(seq)
            cur_pos = pos
        else:
            out.append((cur_pos, cur_seqs))
            cur_pos, cur_seqs, cur_read_idx = pos, [seq], {mi: 0}
    out.append((cur_pos, cur_seqs))
    return out


def renormalize_del_events(mat: np.ndarray, min_len: int = 30,
                           dist: int = 64, min_frac: float = 0.3,
                           min_support: int = 3) -> None:
    """Re-anchor per-read SV-grade deletion runs onto their cluster's
    consensus placement (in place).

    Noisy reads (CLR/ONT de-novo OLC) place the same deletion at
    different tandem-unit offsets; the column vote then only agrees on
    the runs' INTERSECTION and the consensus deletion comes out
    fragments short (the dominant OLC repeat-class failure).  Clustering
    the per-read runs (start within ``dist``, len >= min_len) and moving
    each member read's deleted cells to the cluster's median-length /
    median-start placement lets the ordinary column vote recover the
    full-length event.  Reads with consistent placements (guided mode's
    truth-derived alignments) form clusters that already coincide with
    their own runs, making this a no-op there."""
    isdel = mat == DEL_SYM
    n, L = mat.shape
    events = []                                   # (start, length, read)
    for r in range(n):
        d = np.diff(np.concatenate([[0], isdel[r].astype(np.int8), [0]]))
        for a, b in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            if b - a >= min_len:
                events.append((int(a), int(b - a), r))
    if not events:
        return
    events.sort()
    clusters: list[list[tuple[int, int, int]]] = [[events[0]]]
    for ev in events[1:]:
        if ev[0] - clusters[-1][-1][0] <= dist:
            clusters[-1].append(ev)
        else:
            clusters.append([ev])
    valid = mat != NOCOV
    prev_imposed_end = 0
    for cl in clusters:
        readset = {r for _, _, r in cl}
        lo = min(a for a, _, _ in cl)
        hi = max(a + ln for a, ln, _ in cl)
        lo_c = max(0, lo - 30)
        hi_c = min(L - 1, hi + 30)
        local_cov = max(int((valid[:, lo_c] & valid[:, hi_c]).sum()), 1)
        if len(readset) < max(min_support,
                              int(np.ceil(min_frac * local_cov))):
            continue
        # one observation per READ: a noisy alignment splits its deletion
        # into several nearby runs (many below min_len), so the read's
        # evidence is its TOTAL deleted columns across the cluster window
        # (median over per-run lengths systematically undercalls)
        wlo = max(0, lo - dist, prev_imposed_end)
        whi = min(L, hi + dist)
        readset = sorted(readset)
        starts = np.array([min(a for a, _, r2 in cl if r2 == r)
                           for r in readset])
        lens = np.array([int(isdel[r, wlo:whi].sum()) for r in readset])
        s_star = int(np.median(starts))
        l_star = int(np.median(lens))
        # consistency gate: one real event concentrates the per-read
        # totals around the true length; chained NOISE runs disperse them
        # -- imposing a median over a dispersed cluster fabricates a
        # deletion no read actually saw (measured: spurious multi-hundred
        # bp DELs on CLR repeat arrays)
        if l_star < min_len or \
                float(np.median(np.abs(lens - l_star))) > 0.5 * l_star:
            continue
        e_star = min(s_star + l_star, L)
        for r in readset:                  # withdraw the scattered votes
            win = mat[r, wlo:whi]
            win[win == DEL_SYM] = NOCOV
        for r in readset:
            span = valid[r, s_star:e_star]
            mat[r, s_star:e_star][span] = DEL_SYM
        prev_imposed_end = e_star


def decide_insertions(
    valid: np.ndarray,                       # (n, L) bool: read covers column
    inss: list[tuple[int, int, np.ndarray]],
    region_len: int,
    min_ins_frac: float = 0.4,
    min_ins_support: int = 2,
    cluster_dist: int = 20,
) -> dict[int, np.ndarray]:
    """Insertion-consensus decision: position-cluster the I events and keep
    clusters supported by >= min_ins_frac of the SPANNING local depth (a read
    clipped inside the inserted sequence cannot express the I op, so raw
    column coverage under-votes large INS).  Returns {column: medoid seq}."""
    ins_clusters = _cluster_insertions(inss, max_dist=cluster_dist)
    ins_at: dict[int, np.ndarray] = {}
    for pos, seqs in ins_clusters:
        lo = max(0, pos - 30)
        hi = min(region_len - 1, pos + 30)
        local_cov = max(int((valid[:, lo] & valid[:, hi]).sum()), 1)
        # only count sizeable inserts toward SV-grade insertion consensus;
        # small ones still pass when high-frequency (sequencing indels vote)
        n = len(seqs)
        if n >= max(min_ins_support, int(np.ceil(min_ins_frac * local_cov))):
            lens = np.array([len(s) for s in seqs])
            med = np.median(lens)
            pick = int(np.argmin(np.abs(lens - med)))
            ins_at[pos] = seqs[pick]
    return ins_at


def stitch_contig(
    sym: np.ndarray, cov: np.ndarray, ins_at: dict[int, np.ndarray],
) -> np.ndarray | None:
    """Emit the consensus: per column the voted base unless deleted/uncovered,
    with decided insertions spliced in at their columns."""
    contig, _ = stitch_contig_segments(sym, cov, ins_at)
    return contig


def _md_runs(pos_seg: np.ndarray) -> list[tuple[int, int]]:
    """M/D op runs over an ascending emitted-column array (gaps -> D)."""
    ops: list[tuple[int, int]] = []
    if pos_seg.size == 0:
        return ops
    d = np.diff(pos_seg)
    seg_start = 0
    for b in np.nonzero(d > 1)[0]:
        ops.append((bamio.CMATCH, int(b - seg_start + 1)))
        ops.append((bamio.CDEL, int(d[b] - 1)))
        seg_start = int(b) + 1
    ops.append((bamio.CMATCH, int(len(pos_seg) - seg_start)))
    return ops


def stitch_contig_segments(
    sym: np.ndarray, cov: np.ndarray, ins_at: dict[int, np.ndarray],
    max_gap: int = 10_000,
) -> tuple[np.ndarray | None, list[tuple[int, list[tuple[int, int]]]]]:
    """stitch_contig plus the contig's *implied alignment* to the region.

    A guided-consensus contig knows its own placement by construction: every
    emitted base sits at a known reference column and every spliced insertion
    at a known cut point, so the contig<->reference CIGAR follows directly --
    no seed-chain-extend re-alignment is needed (the reference must re-align
    because hifiasm contigs are coordinate-free, DipPAV_variant_call.py:103;
    this framework's production assembly is not).

    Returns (contig, segments); segments is a list of
    (t_start_region_local, cigar ops incl. soft clips), split wherever a
    single gap exceeds ``max_gap`` (mirroring the aligner's chain gap bound,
    AlignConfig.chain_max_gap, so split-alignment SV geometry is preserved).
    Empty when the contig has no reference-anchored bases (caller falls back
    to the real aligner).

    The hot path runs in native C++ (native/bamparse.cpp::stitch_segments,
    bit-parity contract enforced by tests/test_consensus.py); this Python
    body is the reference implementation and the no-compiler fallback.
    """
    from focalsv_tpu import native
    out = native.stitch_segments(sym, cov, ins_at, max_gap)
    if out is not None:
        return out
    return _stitch_contig_segments_py(sym, cov, ins_at, max_gap)


def _stitch_contig_segments_py(
    sym: np.ndarray, cov: np.ndarray, ins_at: dict[int, np.ndarray],
    max_gap: int = 10_000,
) -> tuple[np.ndarray | None, list[tuple[int, list[tuple[int, int]]]]]:
    """Pure-Python stitch_contig_segments (reference implementation)."""
    take = sym < 4  # A/C/G/T columns (N, DEL, or NOCOV are skipped)
    covered = cov > 0
    emit_base = take & covered
    positions = np.nonzero(emit_base)[0]
    base_vals = sym[positions]
    if positions.size == 0 and not ins_at:
        return None, []
    cut_points = sorted(ins_at)
    out: list[np.ndarray] = []
    start = 0
    for cp in cut_points:
        seg = base_vals[(positions >= start) & (positions < cp)]
        out.append(seg.astype(np.uint8))
        out.append(ins_at[cp].astype(np.uint8))
        start = cp
    out.append(base_vals[positions >= start].astype(np.uint8))
    contig = np.concatenate(out) if out else np.zeros(0, np.uint8)
    if len(contig) == 0:
        return None, []
    if positions.size == 0:
        return contig, []      # insertion-only contig: nothing to anchor
    # --- op stream over the anchored span (M/D from emitted columns, I at
    # cut points; an insertion inside a deleted stretch splits the D run) ---
    stream: list[tuple[int, int]] = []
    prev = None                # last reference column consumed
    lo = 0
    for cp in cut_points:
        seg = positions[(positions >= lo) & (positions < cp)]
        if seg.size:
            if prev is not None and int(seg[0]) > prev + 1:
                stream.append((bamio.CDEL, int(seg[0]) - prev - 1))
            stream.extend(_md_runs(seg))
            prev = int(seg[-1])
        if prev is not None and cp > prev + 1:
            stream.append((bamio.CDEL, cp - prev - 1))
            prev = cp - 1
        stream.append((bamio.CINS, len(ins_at[cp])))
        lo = cp
    seg = positions[positions >= lo]
    if seg.size:
        if prev is not None and int(seg[0]) > prev + 1:
            stream.append((bamio.CDEL, int(seg[0]) - prev - 1))
        stream.extend(_md_runs(seg))
    # --- split into alignment segments at gaps > max_gap -------------------
    raw: list[tuple[int, int, list[tuple[int, int]]]] = []  # (t0, q0, ops)
    cur: list[tuple[int, int]] = []
    q = 0
    t = int(positions[0])
    cur_t, cur_q = t, 0
    for op, ln in stream:
        if ln <= 0:
            continue
        oversize = ln > max_gap and op in (bamio.CDEL, bamio.CINS)
        if (oversize or not cur) and op != bamio.CMATCH:
            # gap at a segment boundary: close the segment (oversize) or
            # absorb a leading gap into t_start / the leading clip
            if oversize and cur:
                raw.append((cur_t, cur_q, cur))
                cur = []
            if op == bamio.CDEL:
                t += ln
            else:
                q += ln
            if not cur:
                cur_t, cur_q = t, q
            continue
        if cur and cur[-1][0] == op:
            cur[-1] = (op, cur[-1][1] + ln)
        else:
            cur.append((op, ln))
        if op == bamio.CMATCH:
            q += ln
            t += ln
        elif op == bamio.CINS:
            q += ln
        else:
            t += ln
    if cur:
        raw.append((cur_t, cur_q, cur))
    # --- finalize: strip dangling gap ops, wrap soft clips -----------------
    segments: list[tuple[int, list[tuple[int, int]]]] = []
    q_len = len(contig)
    for t0, q0, ops in raw:
        while ops and ops[-1][0] != bamio.CMATCH:
            ops.pop()
        while ops and ops[0][0] != bamio.CMATCH:
            op, ln = ops.pop(0)
            if op == bamio.CDEL:
                t0 += ln
            else:
                q0 += ln
        if not ops:
            continue
        q_end = q0 + sum(l for op, l in ops if bamio.CONSUMES_QUERY[op])
        cig = list(ops)
        if q0 > 0:
            cig.insert(0, (bamio.CSOFT_CLIP, q0))
        if q_end < q_len:
            cig.append((bamio.CSOFT_CLIP, q_len - q_end))
        segments.append((t0, cig))
    return contig, segments


def _merge_prefix_suffix(P: np.ndarray, S: np.ndarray, k: int = 15,
                         w: int = 10, min_olp: int = 200,
                         max_err: float = 0.15) -> np.ndarray | None:
    """Dovetail-merge an insertion PREFIX (from trailing soft clips) with an
    insertion SUFFIX (from leading soft clips): minimizer shift voting +
    banded-DP identity check on the implied overlap."""
    from focalsv_tpu_torch.ops import align as alignops
    from focalsv_tpu.ops.minimizer import minimizers
    if len(P) < k + w or len(S) < k + w:
        return None
    pa, ha, _ = minimizers(np.asarray(P, np.uint8), k, w)
    pb, hb, _ = minimizers(np.asarray(S, np.uint8), k, w)
    hmap: dict[int, list[int]] = {}
    for p, h in zip(pb, hb):
        hmap.setdefault(int(h), []).append(int(p))
    diffs = []
    for p, h in zip(pa, ha):
        for q in hmap.get(int(h), ()):
            diffs.append(int(p) - q)
    if len(diffs) < 8:
        return None
    shift = int(np.median(diffs))        # S's start in P coordinates
    olp = len(P) - shift
    if shift < 0 or olp < min_olp or olp > len(S):
        return None
    sim = alignops.edit_similarity(P[shift:], S[:olp])
    if 1.0 - sim > max_err:
        return None
    return np.concatenate([np.asarray(P[:shift], np.uint8),
                           np.asarray(S, np.uint8)])


def clip_insertion_candidates(
    reads: list[bamio.BamRecord], idxs: list[int],
    region_start: int, region_len: int,
    min_clip: int = 500, cluster_dist: int = 200, min_side: int = 2,
    own: set[int] | None = None, valid: np.ndarray | None = None,
    merge_k: int = 15, merge_w: int = 10, merge_max_err: float = 0.15,
) -> list[tuple[int, np.ndarray]]:
    """Reconstruct insertions LONGER than a read from soft-clip clusters.

    An insertion longer than the read length never appears as a CIGAR I op:
    no read spans it.  Its sequence survives in the soft clips -- reads
    entering from the left carry an INS *prefix* as a trailing clip anchored
    at the insertion column, reads exiting right carry an INS *suffix* as a
    leading clip at the same column (an I op consumes no reference).  This
    clusters those clip anchors and dovetail-merges the deepest prefix with
    the deepest suffix, recovering insertions up to ~2x the read length --
    the information-theoretic limit of a cropped region BAM (reads wholly
    inside a novel insertion are unmapped and absent; the reference's
    hifiasm route has the same bound).  Returns [(column, seq)] candidates.

    Haplotype gating (``own`` = reads exclusively phased to this haplotype,
    ``valid`` = the group's pileup coverage matrix, rows in ``idxs`` order):
    a cluster is accepted when a read phased to THIS haplotype is clipped at
    it, or when the clip depth rivals the clean-spanning depth.  Reads that
    cross the breakpoint WITHOUT a clip carry the reference allele (a
    clipped read never spans), so a het insertion's clean haplotype (many
    clean spanners vs a few clips from the sibling's unphased reads)
    rejects the cluster, while the carrier haplotype and hom clusters
    (no clean spanners) accept it.
    """
    own = own or set()
    # events: (column, side 0=INS-prefix/1=INS-suffix, seq|None, read idx)
    events: list[tuple] = []
    for ri in idxs:
        rec = reads[ri]
        cig = rec.cigar
        if len(cig) == 0:
            continue
        op0, ln0 = int(cig[0][0]), int(cig[0][1])
        opn, lnn = int(cig[-1][0]), int(cig[-1][1])
        if op0 == bamio.CSOFT_CLIP and ln0 >= min_clip:
            col = rec.pos - region_start
            if 0 <= col < region_len:
                events.append((col, 1, np.asarray(rec.seq[:ln0], np.uint8),
                               ri))
        if opn == bamio.CSOFT_CLIP and lnn >= min_clip:
            col = rec.reference_end - region_start
            if 0 <= col < region_len:
                events.append((col, 0, np.asarray(rec.seq[-lnn:], np.uint8),
                               ri))
    if not events:
        return []
    events.sort(key=lambda e: e[0])
    out: list[tuple[int, np.ndarray]] = []
    cur: list[tuple] = []

    def flush(cluster):
        pres = [e[2] for e in cluster if e[1] == 0]
        sufs = [e[2] for e in cluster if e[1] == 1]
        if len(pres) < min_side or len(sufs) < min_side:
            return
        col = int(np.median([e[0] for e in cluster]))
        own_here = any(e[3] in own for e in cluster)
        if not own_here and valid is not None:
            lo = max(0, col - 40)
            hi = min(region_len - 1, col + 40)
            clean = int((valid[:, lo] & valid[:, hi]).sum())
            if 2 * len(cluster) < clean:
                return   # this haplotype predominantly spans cleanly
        seq = _merge_prefix_suffix(max(pres, key=len), max(sufs, key=len),
                                   k=merge_k, w=merge_w,
                                   max_err=merge_max_err)
        if seq is not None:
            out.append((col, seq))

    for ev in events + [(1 << 60, 0, None, -1)]:
        if cur and ev[0] - cur[-1][0] > cluster_dist:
            flush(cur)
            cur = []
        if ev[2] is not None:
            cur.append(ev)
    return out


def add_clip_insertions(ins_at: dict[int, np.ndarray],
                        reads, idxs, region_start: int, region_len: int,
                        own: set[int] | None = None,
                        valid: np.ndarray | None = None,
                        guard: int = 300,
                        cfg: AssemblyConfig = AssemblyConfig(),
                        ) -> dict[int, np.ndarray]:
    """Merge clip-cluster insertion candidates into the decided-insertion
    map (CIGAR-op insertions win where both exist)."""
    for col, seq in clip_insertion_candidates(reads, idxs, region_start,
                                              region_len, own=own,
                                              valid=valid,
                                              merge_k=cfg.clip_merge_k,
                                              merge_w=cfg.clip_merge_w,
                                              merge_max_err=cfg.clip_merge_max_err):
        if any(abs(col - p) <= guard for p in ins_at):
            continue
        ins_at[col] = seq
    return ins_at


def consensus_contig(
    reads: list[bamio.BamRecord], idxs: list[int],
    region_start: int, region_len: int,
    cfg: AssemblyConfig = AssemblyConfig(),
    min_ins_frac: float = 0.4,
    min_ins_support: int = 2,
    own: set[int] | None = None,
    event_cluster_dist: int | None = None,
) -> np.ndarray | None:
    """Build one haplotype consensus contig over the region window."""
    contig, _ = consensus_contig_segments(reads, idxs, region_start,
                                          region_len, cfg, min_ins_frac,
                                          min_ins_support, own,
                                          event_cluster_dist)
    return contig


def consensus_contig_segments(
    reads: list[bamio.BamRecord], idxs: list[int],
    region_start: int, region_len: int,
    cfg: AssemblyConfig = AssemblyConfig(),
    min_ins_frac: float = 0.4,
    min_ins_support: int = 2,
    own: set[int] | None = None,
    event_cluster_dist: int | None = None,
) -> tuple[np.ndarray | None, list]:
    """consensus_contig plus its implied alignment segments
    (stitch_contig_segments).

    ``event_cluster_dist``: widen indel-evidence clustering for noisy
    placements (the de-novo OLC polish passes ~a tandem unit; see
    renormalize_del_events)."""
    if len(idxs) < cfg.min_reads:
        return None, []
    mat, inss = pileup_with_dels(reads, idxs, region_start, region_len)
    if event_cluster_dist:
        renormalize_del_events(mat, dist=event_cluster_dist)
    sym, cov = _column_vote(mat)
    ins_at = decide_insertions(mat != NOCOV, inss, region_len,
                               min_ins_frac, min_ins_support,
                               cluster_dist=event_cluster_dist or 20)
    ins_at = add_clip_insertions(ins_at, reads, idxs, region_start,
                                 region_len, own=own, valid=mat != NOCOV,
                                 cfg=cfg)
    return stitch_contig_segments(sym, cov, ins_at)


def group_exclusive_sets(groups: dict, ps: int, hp: int
                         ) -> tuple[set[int], set[int]]:
    """(own, rival) exclusive-member read sets of a (phase-set, haplotype)
    group: members NOT shared with the sibling haplotype (shared members are
    the unphased reads output_fas-style allocated to both)."""
    if hp not in (1, 2):
        return set(), set()
    mine = set(groups.get((ps, hp), ()))
    sib = set(groups.get((ps, 3 - hp), ()))
    return mine - sib, sib - mine


def assemble_haplotypes(
    reads: list[bamio.BamRecord],
    groups: dict[tuple[int, int], list[int]],
    region_start: int, region_len: int,
    cfg: AssemblyConfig = AssemblyConfig(),
    name_prefix: str = "region",
    alns_out: dict[str, list] | None = None,
) -> tuple[dict[str, np.ndarray], dict[str, np.ndarray]]:
    """Per (phase-set, haplotype) consensus -> {name: contig} per haplotype.

    Contig naming mirrors the reference's `>a_hp{1,2}_N` convention
    (4_sv_calling/rename_fa.py:15-23) so the hp tag is parseable downstream.
    With ``alns_out`` the guided path also records each contig's implied
    alignment segments (region-local; stitch_contig_segments), letting the
    variant caller skip the seed-chain-extend re-alignment.
    """
    hp1: dict[str, np.ndarray] = {}
    hp2: dict[str, np.ndarray] = {}
    for (ps, hp), idxs in sorted(groups.items()):
        tgt = hp1 if hp in (0, 1) else hp2
        own, _rival = group_exclusive_sets(groups, ps, hp)
        segs: list = []
        if cfg.method == "olc":
            from focalsv_tpu_torch.assembly.olc import assemble_olc
            contig = assemble_olc([reads[i].seq for i in idxs], cfg)
        else:
            contig, segs = consensus_contig_segments(
                reads, idxs, region_start, region_len, cfg, own=own)
        if contig is None:
            continue
        name = f"{name_prefix}_PS{ps}_hp{max(hp,1)}"
        tgt[name] = contig
        if alns_out is not None and segs:
            alns_out[name] = segs
        if hp == 0:
            # fully-unphased region: same consensus serves both haplotypes
            name2 = f"{name_prefix}_PS{ps}_hp2"
            hp2[name2] = contig
            if alns_out is not None and segs:
                alns_out[name2] = segs
    return hp1, hp2
