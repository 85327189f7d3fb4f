"""De-novo overlap-layout-consensus assembly for one haplotype read set.

The hifiasm/Flye-class path for region-scale inputs (reference runs one
assembler process per phase block, `3_assembly/run_assembly.py:15-28`).  The
reference-guided consensus (assembly/consensus.py) inherits whatever the
upstream aligner did near breakpoints; this module rebuilds the haplotype
sequence from the reads alone:

1. overlap: minimizer-sharing candidate pairs -> banded-DP dovetail verify
   (the hifiasm anchor/Correct stage, here the framework's one DP kernel);
2. layout: greedy best-overlap chaining from the leftmost-extending read
   (transitive edges implicitly skipped by best-suffix selection);
3. consensus: layout positions each read on the draft; column vote +
   insertion clustering polish the backbone, iterated ``polish_rounds``
   times for noisy reads (the racon loop).

At region scale (tens of reads, <=100 kb) this is quadratic-candidate but
minimizer-pruned, and every verify is a batched banded DP.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from focalsv_tpu.config import AssemblyConfig
from focalsv_tpu.io import bam as bamio
from focalsv_tpu_torch.ops import align as alignops
from focalsv_tpu.ops import encode as enc
from focalsv_tpu.ops.minimizer import minimizers


@dataclass
class Overlap:
    a: int
    b: int
    a_start: int        # suffix of a overlaps prefix of b
    shift: int          # b start position relative to a start
    score: int
    identity: float


def orient_reads(
    seqs: list[np.ndarray], k: int = 15, w: int = 10, min_shared: int = 8,
) -> tuple[list[np.ndarray], np.ndarray]:
    """Resolve relative read orientations before overlap detection.

    Minimizer hashes are canonical (ops/minimizer.py::kmer_hashes), so two
    reads from opposite strands still share seeds -- each shared seed votes
    for the pair's relative strand (sa XOR sb, hifiasm's anchor-strand
    logic).  Pairwise parities are reconciled globally with a parity
    union-find processed strongest-pair-first (odd cycles from repeat seeds
    lose to heavier evidence), and the minority orientation within each
    component is reverse-complemented.

    Returns (oriented seqs, flipped bool per read).
    """
    n = len(seqs)
    flip = np.zeros(n, bool)
    if n < 2:
        return list(seqs), flip
    mins = [minimizers(s, k, w) for s in seqs]
    table: dict[int, list[tuple[int, int]]] = {}
    for ri, (pos, h, st) in enumerate(mins):
        for hh, ss in zip(h, st):
            table.setdefault(int(hh), []).append((ri, int(ss)))
    votes: dict[tuple[int, int], list[int]] = {}
    for entries in table.values():
        if len(entries) > 32:        # repetitive seed
            continue
        for x in range(len(entries)):
            for y in range(x + 1, len(entries)):
                ra, sa = entries[x]
                rb, sb = entries[y]
                if ra == rb:
                    continue
                if ra > rb:
                    ra, rb, sa, sb = rb, ra, sb, sa
                v = votes.setdefault((ra, rb), [0, 0])
                v[sa ^ sb] += 1
    # parity union-find: rel[i] = orientation of i relative to its root
    parent = np.arange(n)
    rel = np.zeros(n, np.uint8)

    def find(i: int) -> tuple[int, int]:
        path = []
        j = i
        while parent[j] != j:
            path.append(j)
            j = parent[j]
        root = j
        suf = 0
        for j in reversed(path):   # closest-to-root first: suffix XOR
            suf ^= rel[j]
            parent[j] = root
            rel[j] = suf
        return root, int(rel[i]) if path else 0

    edges = sorted(
        ((max(v), (v[1] > v[0]), a, b) for (a, b), v in votes.items()
         if max(v) >= min_shared),
        key=lambda e: -e[0])
    for _, parity, a, b in edges:
        ra, pa = find(a)
        rb, pb = find(b)
        if ra == rb:
            continue        # conflicting parity loses to heavier evidence
        parent[rb] = ra
        rel[rb] = pa ^ pb ^ int(parity)
    for i in range(n):
        _, p = find(i)
        flip[i] = bool(p)
    # keep the majority orientation as-is within each component
    roots = np.array([find(i)[0] for i in range(n)])
    for r in np.unique(roots):
        members = roots == r
        if flip[members].sum() * 2 > members.sum():
            flip[members] = ~flip[members]
    out = [enc.revcomp(s) if flip[i] else s for i, s in enumerate(seqs)]
    return out, flip


def _mode_shift(diffs: list[int], tol: int = 32) -> int:
    """Median of the heaviest +-tol cluster of pairwise position diffs.

    Inside a tandem-repeat array the shared-seed diffs are multimodal at
    unit-length multiples; a global median can land between modes and
    collapse repeat copies out of the layout (the unit-count error then
    erases whole-unit indel SVs from BOTH haplotype contigs)."""
    d = np.sort(np.asarray(diffs, np.int64))
    lo = np.searchsorted(d, d - tol)
    hi = np.searchsorted(d, d + tol)
    i = int(np.argmax(hi - lo))
    return int(np.median(d[lo[i] : hi[i]]))


def find_overlaps(
    seqs: list[np.ndarray], k: int = 15, w: int = 10,
    min_shared: int = 8, min_olp: int = 500, band: int = 256,
    max_err: float = 0.2,
) -> list[Overlap]:
    """Candidate pairs by shared minimizers; dovetail verify by banded DP.

    Shift votes come ONLY from minimizers unique within both reads: a
    tandem-array k-mer recurs in every unit copy, so its matches vote for
    every unit-multiple shift at once (hifiasm's anchor filtering drops
    such seeds the same way).  Flanking-unique seeds pin the true shift;
    pairs sharing no unique seeds (both reads interior to an array) are
    genuinely ambiguous and form no edge."""
    mins = [minimizers(s, k, w) for s in seqs]
    # hash -> list of (read, pos), read-unique hashes only
    table: dict[int, list[tuple[int, int]]] = {}
    for ri, (pos, h, _) in enumerate(mins):
        _, inv, cnt = np.unique(h, return_inverse=True, return_counts=True)
        once = cnt[inv] == 1
        for p, hh in zip(pos[once], h[once]):
            table.setdefault(int(hh), []).append((ri, int(p)))
    votes: dict[tuple[int, int], list[int]] = {}
    for entries in table.values():
        if len(entries) > 32:        # repetitive seed
            continue
        for x in range(len(entries)):
            for y in range(len(entries)):
                ra, pa = entries[x]
                rb, pb = entries[y]
                if ra >= rb:
                    continue
                votes.setdefault((ra, rb), []).append(pa - pb)
    # cap DP-verified candidates per read at the strongest-evidence pairs
    # (hifiasm caps per-read overlaps the same way): the O(olp*band)
    # verifies dominated large-region OLC wall time.  Applied only to
    # LARGE read sets -- on small noisy groups (tandem-repeat regions at
    # ~50 reads) the weak-tail edges still carry real layout signal and
    # capping measurably cost ONT repeat recall; the ordering change is
    # scoped inside the branch so small sets keep r3's emission order.
    # Pairs failing the cheap min_olp gate never consume cap budget (a
    # read whose strongest-vote pairs are all short edge dovetails must
    # not lose its verifiable partners to them).
    def cheap_olp(ra, rb, diffs):
        shift = _mode_shift(diffs)
        la, lb = len(seqs[ra]), len(seqs[rb])
        olp = min(la - shift, lb) if shift >= 0 else min(lb + shift, la)
        return shift, olp

    kept: list[tuple[int, int, int, int]] = []   # (ra, rb, shift, olp)
    if len(seqs) > 100:
        max_per_read = 12
        per_read: dict[int, int] = {}
        for (ra, rb), diffs in sorted(votes.items(),
                                      key=lambda kv: -len(kv[1])):
            if len(diffs) < min_shared:
                continue
            shift, olp = cheap_olp(ra, rb, diffs)
            if olp < min_olp:
                continue
            if per_read.get(ra, 0) >= max_per_read \
                    and per_read.get(rb, 0) >= max_per_read:
                continue
            per_read[ra] = per_read.get(ra, 0) + 1
            per_read[rb] = per_read.get(rb, 0) + 1
            kept.append((ra, rb, shift, olp))
    else:
        for (ra, rb), diffs in votes.items():
            if len(diffs) < min_shared:
                continue
            shift, olp = cheap_olp(ra, rb, diffs)
            kept.append((ra, rb, shift, olp))
    overlaps: list[Overlap] = []
    for ra, rb, shift, olp in kept:
        la, lb = len(seqs[ra]), len(seqs[rb])
        if olp < min_olp:
            continue
        # verify the implied overlap with banded DP
        if shift >= 0:
            qa = seqs[ra][shift : shift + olp]
            qb = seqs[rb][:olp]
        else:
            qa = seqs[ra][:olp]
            qb = seqs[rb][-shift : -shift + olp]
        bw = max(64, alignops.band_bucket(int(abs(len(qa) - len(qb))) + 64,
                                          lo=64))
        sim = alignops.edit_similarity(qa, qb, band=bw)
        if 1.0 - sim > max_err:
            continue
        overlaps.append(Overlap(a=ra, b=rb, a_start=max(shift, 0),
                                shift=shift, score=olp,
                                identity=sim))
    return overlaps


def layout_reads(seqs: list[np.ndarray],
                 overlaps: list[Overlap]) -> list[tuple[int, int]]:
    """BFS layout: (read index, draft offset) per read.

    Offsets propagate pairwise shifts outward from the highest-degree read
    (strongest-overlap edges first), then normalize to start at 0.  Reads
    outside the seed's connected component are left out of the layout; with
    no overlaps at all, the longest read stands alone.
    """
    n = len(seqs)
    if n == 0:
        return []
    adj: dict[int, list[tuple[float, int, int]]] = {}
    for ov in sorted(overlaps, key=lambda o: -o.score * o.identity):
        adj.setdefault(ov.a, []).append((ov.identity, ov.b, ov.shift))
        adj.setdefault(ov.b, []).append((ov.identity, ov.a, -ov.shift))
    if not adj:
        best = max(range(n), key=lambda i: len(seqs[i]))
        return [(best, 0)]
    # seed from the read with the most overlap edges inside the LARGEST
    # connected component (a high-degree repeat read can sit in a side
    # component; components found by throwaway BFS sweeps)
    seen: set[int] = set()
    components: list[list[int]] = []
    for r0 in adj:
        if r0 in seen:
            continue
        comp = [r0]
        seen.add(r0)
        q = [r0]
        while q:
            r = q.pop()
            for _, o, _ in adj.get(r, ()):
                if o not in seen:
                    seen.add(o)
                    comp.append(o)
                    q.append(o)
        components.append(comp)
    main = max(components, key=len)
    seed = max(main, key=lambda r: len(adj[r]))
    placed = {seed: 0}
    frontier = [seed]
    while frontier:
        nxt = []
        for r in frontier:
            for ident, o, shift in adj.get(r, ()):
                if o not in placed:
                    placed[o] = placed[r] + shift
                    nxt.append(o)
        frontier = nxt
    # relaxation sweeps: BFS takes each read's offset from ONE parent, so
    # per-edge shift noise accumulates along chains -- across a tandem
    # array the drift reaches unit multiples and the stitched draft
    # collapses repeat copies.  Re-estimating every offset as the median
    # over ALL placed neighbors converges the layout to the consistent
    # solution the full edge set implies (hifiasm's graph cleaning plays
    # this role).
    for _ in range(3):
        moved = 0
        for r in placed:
            est = [placed[o] - shift for _, o, shift in adj.get(r, ())
                   if o in placed]
            if len(est) >= 2:
                m = int(np.median(est))
                if m != placed[r]:
                    placed[r] = m
                    moved += 1
        if not moved:
            break
    base = min(placed.values())
    return sorted(((r, off - base) for r, off in placed.items()),
                  key=lambda x: x[1])


def _anchor_offsets(seqs: list[np.ndarray], layout: list[tuple[int, int]],
                    draft: np.ndarray, scale: float,
                    k: int = 15, w: int = 10,
                    min_seeds: int = 4) -> list[tuple[int, int]]:
    """Rigid per-read placement against the current draft for the polish
    loop: mode-clustered diffs of minimizers UNIQUE in both the read and
    the draft (find_overlaps' anchor filtering -- repeat-array seeds recur
    per unit copy and cannot vote).

    The global scaled layout offset drifts inside tandem arrays (the first
    draft's unit count differs from the final one), letting reads align a
    unit off and vote the array shorter -- the dominant CLR/ONT repeat
    failure.  A full seed-chain-extend re-placement here RAISED recall but
    exploded FPs (round-4 reverted experiment: split/clip placements
    fabricate breakpoints); the FP guard is rigidity -- one shift per
    read, flanking-unique seeds only, scaled-offset fallback when fewer
    than ``min_seeds`` agree."""
    pd, hd, _ = minimizers(np.asarray(draft, np.uint8), k, w)
    _, inv, cnt = np.unique(hd, return_inverse=True, return_counts=True)
    du = cnt[inv] == 1
    dmap = {int(h): int(p) for p, h in zip(pd[du], hd[du])}
    out = []
    for r, off in layout:
        s = seqs[r]
        fallback = int(off * scale)
        pa, ha, _ = minimizers(s, k, w)
        if ha.size:
            _, inv2, cnt2 = np.unique(ha, return_inverse=True,
                                      return_counts=True)
            ru = cnt2[inv2] == 1
            diffs = [dmap[int(h)] - int(p)
                     for p, h in zip(pa[ru], ha[ru]) if int(h) in dmap]
        else:
            diffs = []
        if len(diffs) >= min_seeds:
            out.append((r, _mode_shift(diffs)))
        else:
            out.append((r, fallback))
    return out


def consensus_from_layout(
    seqs: list[np.ndarray], layout: list[tuple[int, int]],
    band: int = 128, draft: np.ndarray | None = None,
) -> np.ndarray | None:
    """Column-vote consensus over the laid-out reads.

    Each read is re-aligned (banded) to its window of the draft -- the
    offset-stitched read mosaic on the first pass, or the previous round's
    contig when ``draft`` is given (the racon polish loop, with per-read
    anchored placement: _anchor_offsets) -- and votes per draft column
    with deletion/insertion awareness.
    """
    if not layout:
        return None
    stitched_len = max(off + len(seqs[r]) for r, off in layout)
    anchored = None
    if draft is None:
        draft = np.full(stitched_len, 4, np.uint8)
        for r, off in layout:
            draft[off : off + len(seqs[r])] = seqs[r]
    else:
        anchored = _anchor_offsets(seqs, layout, draft,
                                   len(draft) / max(stitched_len, 1))
    draft_len = len(draft)
    scale = draft_len / max(stitched_len, 1)
    from focalsv_tpu_torch.assembly.consensus import consensus_contig
    recs = []
    for li, (r, off) in enumerate(layout):
        s = seqs[r]
        off = anchored[li][1] if anchored is not None else int(off * scale)
        off = max(-len(s) + 50, min(off, draft_len - 50))
        win_a = max(0, off - 64)
        win_b = min(draft_len, off + len(s) + 64)
        tseg = draft[win_a:win_b]
        if len(tseg) < 50:
            continue
        bw = max(band, alignops.band_bucket(abs(len(s) - len(tseg)) + 64))
        _, cig = alignops.banded_align_pair(s, tseg, band=bw)
        # strip flanking target gaps into the record position
        pos = win_a
        if cig and cig[0][0] == bamio.CDEL:
            pos += cig[0][1]
            cig = cig[1:]
        if cig and cig[-1][0] == bamio.CDEL:
            cig = cig[:-1]
        recs.append(bamio.BamRecord(
            name=f"lay{r}", flag=0, ref_id=0, pos=pos, mapq=60,
            cigar=np.array(cig, np.int32).reshape(-1, 2), seq=s,
            qual=np.full(len(s), 40, np.uint8)))
    if not recs:
        return None
    # noisy de-novo placements scatter one indel event across tandem-unit
    # offsets; cluster evidence at unit scale (renormalize_del_events)
    return consensus_contig(recs, list(range(len(recs))), 0, draft_len,
                            event_cluster_dist=64)


def assemble_olc(
    seqs: list[np.ndarray], cfg: AssemblyConfig = AssemblyConfig(),
) -> np.ndarray | None:
    """Full OLC pass for one haplotype's reads -> consensus contig."""
    if not seqs:
        return None
    if len(seqs) == 1:
        return seqs[0]
    # resolve strand mix first (region-BAM reads arrive reference-oriented,
    # so this is a no-op there; true de-novo input needs it).  The contig
    # comes out in the majority orientation of its component.
    seqs, _ = orient_reads(seqs)
    overlaps = find_overlaps(seqs)
    layout = layout_reads(seqs, overlaps)
    contig = consensus_from_layout(seqs, layout, band=cfg.band_width)
    # racon loop: re-vote the reads against each refined draft
    for _ in range(max(cfg.polish_rounds - 1, 0)):
        if contig is None or len(contig) < 100:
            break
        new = consensus_from_layout(seqs, layout, band=cfg.band_width,
                                    draft=np.asarray(contig, np.uint8))
        if new is None or np.array_equal(new, contig):
            break
        contig = new
    return contig
