"""Pair-HMM realignment of reads at candidate het sites (longshot semantics).

Instead of trusting the pileup projection (which mis-assigns alleles near
small indels), each read's raw segment around a site is scored against the
ref-allele and alt-allele haplotype windows with the batched pair-HMM kernel
(ops/pairhmm.py); the likelihood ratio assigns the allele.  Enabled with
PhasingConfig.use_pairhmm.
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.ops.pairhmm import site_allele_loglik
from focalsv_tpu_torch.phasing.phase import HetSites


def read_offset_at(rec: bamio.BamRecord, ref_pos: int) -> int | None:
    """Query offset aligned at a single reference position."""
    out = read_offsets_at(rec, np.array([ref_pos], np.int64))
    return int(out[0]) if out[0] >= 0 else None


def read_offsets_at(rec: bamio.BamRecord,
                    ref_positions: np.ndarray) -> np.ndarray:
    """Query offsets aligned at each (sorted ascending) reference position,
    computed in ONE CIGAR walk per read (-1 = not aligned there)."""
    out = np.full(len(ref_positions), -1, np.int64)
    rpos = rec.pos
    qpos = 0
    si = int(np.searchsorted(ref_positions, rpos))
    n = len(ref_positions)
    for op, ln in rec.cigar:
        if si >= n:
            break
        if op in (bamio.CMATCH, bamio.CEQUAL, bamio.CDIFF):
            while si < n and ref_positions[si] < rpos + ln:
                if ref_positions[si] >= rpos:
                    out[si] = qpos + (ref_positions[si] - rpos)
                si += 1
            rpos += ln
            qpos += ln
        elif op in (bamio.CINS, bamio.CSOFT_CLIP):
            qpos += ln
        elif op in (bamio.CDEL, bamio.CREF_SKIP):
            while si < n and ref_positions[si] < rpos + ln:
                si += 1          # site deleted in this read
            rpos += ln
    return out


def realign_allele_matrix(
    reads: list[bamio.BamRecord],
    sites: HetSites,
    ref_codes: np.ndarray,
    region_start: int,
    flank: int = 10,
    min_lr: float = 1.0,
) -> np.ndarray:
    """(R, S) int8 allele matrix via pair-HMM realignment (0/1/-1)."""
    R, S = len(reads), len(sites.positions)
    out = np.full((R, S), -1, np.int8)
    if R == 0 or S == 0:
        return out
    seg_w = 2 * flank + 1
    gpos_sorted = np.asarray(sites.positions, np.int64) + region_start
    jobs = []          # (read_idx, site_idx, seg, qual)
    for ri, rec in enumerate(reads):
        offs = read_offsets_at(rec, gpos_sorted)
        for si in np.nonzero(offs >= 0)[0]:
            q = int(offs[si])
            a, b = q - flank, q + flank + 1
            if a < 0 or b > rec.query_length:
                continue
            jobs.append((ri, int(si), rec.seq[a:b],
                         rec.qual[a:b] if rec.qual.shape[0] else None))
    if not jobs:
        return out
    B = len(jobs)
    L = seg_w + 8
    segs = np.full((B, L), 5, np.uint8)
    quals = np.full((B, L), 30, np.int32)
    refw = np.full((B, L), 5, np.uint8)
    altw = np.full((B, L), 5, np.uint8)
    seg_lens = np.zeros(B, np.int32)
    w_lens = np.zeros(B, np.int32)
    for k, (ri, si, seg, qual) in enumerate(jobs):
        segs[k, : len(seg)] = seg
        seg_lens[k] = len(seg)
        if qual is not None:
            quals[k, : len(qual)] = qual
        p = int(sites.positions[si])
        a = max(0, p - flank - 2)
        b = min(len(ref_codes), p + flank + 3)
        win = ref_codes[a:b].copy()
        refw[k, : len(win)] = win
        alt = win.copy()
        alt[p - a] = sites.allele1[si]
        altw[k, : len(alt)] = alt
        w_lens[k] = len(win)
    # ref window carries allele0 at the site (major allele)
    for k, (ri, si, _, _) in enumerate(jobs):
        p = int(sites.positions[si])
        a = max(0, p - flank - 2)
        refw[k, p - a] = sites.allele0[si]
    lr, la = site_allele_loglik(segs, seg_lens, refw, w_lens, altw, w_lens,
                                quals)
    for k, (ri, si, _, _) in enumerate(jobs):
        if lr[k] - la[k] >= min_lr:
            out[ri, si] = 0
        elif la[k] - lr[k] >= min_lr:
            out[ri, si] = 1
    return out
