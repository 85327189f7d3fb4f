"""Redundancy removal: collapse near-duplicate SV calls.

Port of `Dippav/remove_redundancy.py:246-280`:
- INS pairs match if dist <= 500, size-sim >= 0.5 and edit-similarity >= 0.5
  where edit_sim = (len1 + len2 - editDistance) / (len1 + len2) (:57-63;
  edlib replaced by the banded unit-cost DP kernel);
- DEL pairs match if dist <= 3000, size-sim >= 0.1 and reciprocal overlap
  over the max length >= 0 (:97-107);
- matches form a graph; connected components (union-find instead of
  networkx) keep the longest call, all members annotated CollapseId.
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu.config import DedupConfig
from focalsv_tpu.io.vcf import VcfRecord
from focalsv_tpu_torch.ops import align as alignops
from focalsv_tpu.ops import encode as enc


class _UF:
    def __init__(self, n: int):
        self.p = list(range(n))

    def find(self, x: int) -> int:
        while self.p[x] != x:
            self.p[x] = self.p[self.p[x]]
            x = self.p[x]
        return x

    def union(self, a: int, b: int):
        ra, rb = self.find(a), self.find(b)
        if ra != rb:
            self.p[ra] = rb


def edit_sim_total(a: np.ndarray, b: np.ndarray) -> float:
    """(len(a)+len(b)-dist)/(len(a)+len(b)) -- reference edit_sim (:57-63)."""
    la, lb = len(a), len(b)
    tot = la + lb
    if tot == 0:
        return 1.0
    sim_maxnorm = alignops.edit_similarity(a, b)
    dist = (1.0 - sim_maxnorm) * max(la, lb)
    return (tot - dist) / tot


def _components(n: int, links: list[tuple[int, int]]) -> list[list[int]]:
    uf = _UF(n)
    for a, b in links:
        uf.union(a, b)
    groups: dict[int, list[int]] = {}
    linked = set()
    for a, b in links:
        linked.add(a)
        linked.add(b)
    for i in sorted(linked):
        groups.setdefault(uf.find(i), []).append(i)
    return list(groups.values())


def _tig_intervals(r: VcfRecord) -> dict[str, tuple[int, int]]:
    """TIG_REGION INFO ('name:lo-hi', comma-joined for 1/1 pairs) parsed to
    {contig_name: (lo, hi)}."""
    out: dict[str, tuple[int, int]] = {}
    raw = r.info.get("TIG_REGION")
    if not raw:
        return out
    for part in str(raw).split(","):
        if ":" not in part:
            continue
        name, span = part.rsplit(":", 1)
        if "-" not in span:
            continue
        lo, hi = span.split("-", 1)
        try:
            out[name] = (int(lo), int(hi))
        except ValueError:
            continue
    return out


def _same_witness_distinct(ra: VcfRecord, rb: VcfRecord) -> bool:
    """True when the records share a source contig and their query intervals
    on every shared contig are disjoint (distinct events on one haplotype
    path, not redundant reports of one event)."""
    if abs(ra.pos - rb.pos) <= 2:
        # identical (canonical) positions are ONE event no matter the
        # witness geometry: unit-snapping walks scattered noisy
        # observations of a repeat-array indel to the same array-start
        # placement, and their (disjoint) contig offsets must not exempt
        # them -- a contig's fragmented expansion evidence otherwise
        # survives as a pile of co-located records
        return False
    ta, tb = _tig_intervals(ra), _tig_intervals(rb)
    shared = set(ta) & set(tb)
    if not shared:
        return False
    for name in shared:
        lo1, hi1 = ta[name]
        lo2, hi2 = tb[name]
        if min(hi1, hi2) - max(lo1, lo2) > 0:
            return False     # overlapping offsets: genuinely the same event
    return True


def dedup_records(
    records: list[VcfRecord],
    cfg: DedupConfig = DedupConfig(),
) -> tuple[list[VcfRecord], list[VcfRecord]]:
    """Returns (retained, removed); both annotated with CollapseId."""
    if not records:
        return [], []
    svlen = np.array([abs(len(r.alt) - len(r.ref)) for r in records], np.int64)
    pos = np.array([r.pos for r in records], np.int64)
    is_del = np.array([len(r.alt) < len(r.ref) for r in records], bool)
    chroms = np.array([r.chrom for r in records])
    retain: dict[int, tuple[str, int]] = {}
    remove: dict[int, tuple[str, int]] = {}
    for svtype, label in ((True, "DEL"), (False, "INS")):
        comp_id = 0
        for chrom in np.unique(chroms):
            idx = np.nonzero((chroms == chrom) & (is_del == svtype))[0]
            if idx.size < 2:
                continue
            p, l = pos[idx], svlen[idx].astype(np.float64)
            dist = np.abs(p[:, None] - p[None, :])
            size_sim = np.minimum(l[:, None], l[None, :]) / np.maximum(
                np.maximum(l[:, None], l[None, :]), 1)
            if svtype:  # DEL
                e = p + svlen[idx]
                olp = (np.minimum(e[:, None], e[None, :]) -
                       np.maximum(p[:, None], p[None, :])) / np.maximum(
                    np.maximum(l[:, None], l[None, :]), 1)
                m = ((dist <= cfg.del_max_dist) &
                     (size_sim >= cfg.del_min_size_sim) &
                     (olp >= cfg.del_min_recip_overlap))
            else:       # INS: cheap gates first, edit-sim only on candidates
                m = ((dist <= cfg.ins_max_dist) &
                     (size_sim >= cfg.ins_min_size_sim))
            np.fill_diagonal(m, False)
            links = []
            for i, j in zip(*np.nonzero(np.triu(m))):
                gi, gj = int(idx[i]), int(idx[j])
                if _same_witness_distinct(records[gi], records[gj]):
                    # both events were extracted from the SAME contig at
                    # non-overlapping query offsets: one haplotype path
                    # witnessed two distinct events (e.g. nested insertions
                    # 130 bp apart whose random sequences flirt with the
                    # 0.5 edit-similarity line) -- never collapse them
                    continue
                if not svtype:
                    a = enc.encode(records[gi].alt[1:])
                    b = enc.encode(records[gj].alt[1:])
                    if edit_sim_total(a, b) < cfg.ins_min_edit_sim:
                        continue
                links.append((gi, gj))
            for comp in _components(len(records), links):
                best = comp[int(np.argmax(svlen[comp]))]
                for g in comp:
                    (retain if g == best else remove)[g] = (label, comp_id)
                comp_id += 1
    kept_out, removed_out = [], []
    for i, r in enumerate(records):
        if i in remove:
            label, cid = remove[i]
            removed_out.append(r.with_info(CollapseId=f"{label}{cid}"))
        elif i in retain:
            label, cid = retain[i]
            kept_out.append(r.with_info(CollapseId=f"{label}{cid}"))
        else:
            kept_out.append(r)
    return kept_out, removed_out
