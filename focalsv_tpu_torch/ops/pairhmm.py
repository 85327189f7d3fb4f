"""Batched pair-HMM forward likelihoods (the longshot/GATK-HC realignment core).

The counterpart of ``focalsv_tpu/ops/pairhmm.py`` in plain PyTorch: the
classic 3-state (M/I/D) forward algorithm evaluated over *anti-diagonal
wavefronts*, so every step is a fully parallel update over the diagonal
and over the batch -- no within-row sequential dependency (cf. PAPERS.md
gpuPairHMM/Endeavor, which use the same wavefront dataflow on GPUs).

The reference is XLA code (a vmapped ``lax.scan``), not a Pallas kernel,
so this is tensor code and no hand-written kernel: the batch axis is
written out (state ``(B, M + 1)`` float32 per wavefront) and the scan is a
Python loop of ``M + N`` steps.  Tensors live on ``resolve_device()``;
inputs and outputs are numpy, as in the reference.  float32 ``log`` and
``exp`` round differently in XLA and in PyTorch, so log-likelihoods agree
with the reference to about 1e-3, not bit for bit.

Intended use: small local windows (read segment vs candidate-allele
haplotype window around a variant site), batched over thousands of
(read, site, allele) pairs.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from focalsv_tpu_torch.device import resolve_device

LOG0 = -1e30


def _logsumexp3(a, b, c):
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = m.clamp(min=LOG0 / 2)
    return m + torch.log(
        torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe))


def _logsumexp2(a, b):
    m = torch.maximum(a, b)
    m_safe = m.clamp(min=LOG0 / 2)
    return m + torch.log(torch.exp(a - m_safe) + torch.exp(b - m_safe))


def _up(v):
    """The value at read index i - 1 of a wavefront (LOG0 enters at 0)."""
    return F.pad(v[:, :-1], (1, 0), value=LOG0)


def pairhmm_forward_batch(
    reads,       # (B, max_read) uint8
    read_lens,   # (B,) int32
    haps,        # (B, max_hap) uint8
    hap_lens,    # (B,) int32
    quals=None,  # (B, max_read) phred, default 30
    max_read: int = 32,
    max_hap: int = 32,
    gap_open: float = 1e-3,
    gap_extend: float = 0.1,
    device=None,
) -> np.ndarray:
    """log P(read | hap) under the 3-state pair-HMM, free hap flanks.

    Emissions: match prob 1-e, mismatch e/3 with e from the base quality;
    insert emissions uniform (1/4).  Transitions: M->gap gap_open,
    gap->gap gap_extend.  Haplotype leading/trailing deletions are free
    (local-in-hap alignment), matching realignment-window semantics.
    """
    dev = resolve_device(device)
    M, N = max_read, max_hap

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)

    reads = on_dev(reads, torch.int64)
    haps = on_dev(haps, torch.int64)
    rlen = on_dev(read_lens, torch.int64)[:, None]
    hlen = on_dev(hap_lens, torch.int64)[:, None]
    B = reads.shape[0]
    if quals is None:
        quals = torch.full((B, M), 30, dtype=torch.int32, device=dev)
    else:
        quals = on_dev(quals, torch.int32)
    err = torch.pow(10.0, -quals.to(torch.float32) / 10.0)
    lm_match = torch.log1p(-err.clamp(1e-10, 0.75))
    lm_mis = torch.log(err.clamp(1e-10, 0.75) / 3.0)

    l_go = float(np.log(gap_open))
    l_ge = float(np.log(gap_extend))
    l_mm = float(np.log(1.0 - 2 * gap_open))
    l_gm = float(np.log(1.0 - gap_extend))
    l_ins = float(np.log(0.25))

    # wavefront arrays indexed by read position i in [0, M]; cell (i, j)
    # lives on anti-diagonal a = i + j
    iarr = torch.arange(M + 1, device=dev)
    ri = (iarr - 1).clamp(0, M - 1)
    rc = reads[:, ri]                    # read[i - 1], (B, M + 1)
    lmat = lm_match[:, ri]
    lmis = lm_mis[:, ri]
    row0 = (iarr == 0)[None, :]
    i_ge1 = (iarr >= 1)[None, :]
    in_read = iarr[None, :] <= rlen
    at_end = iarr[None, :] == rlen

    def full(value):
        return torch.full((B, M + 1), value, dtype=torch.float32, device=dev)

    # init: a=0 cell (0,0); hap flanks free => Y(0, j) = 0 for all j
    m1 = torch.where(row0, 0.0, full(LOG0))
    x1 = full(LOG0)
    y1 = m1.clone()
    m2, x2, y2 = full(LOG0), full(LOG0), full(LOG0)
    terms = torch.empty((B, M + N), dtype=torch.float32, device=dev)
    for a in range(1, M + N + 1):
        j = a - iarr
        valid = in_read & ((j >= 1)[None, :] & (j[None, :] <= hlen))
        # match emission for read[i-1] vs hap[j-1]
        hc = haps[:, (j - 1).clamp(0, N - 1)]
        e = torch.where((rc == hc) & (rc < 4), lmat, lmis)
        m_new = e + _logsumexp3(_up(m2) + l_mm, _up(x2) + l_gm,
                                _up(y2) + l_gm)
        x_new = l_ins + _logsumexp2(_up(m1) + l_go, _up(x1) + l_ge)
        y_new = _logsumexp2(m1 + l_go, y1 + l_ge)
        # free leading hap deletions: entering at (0, j) costs nothing
        y_new = torch.where(row0, 0.0, y_new)
        m_new = torch.where(valid & i_ge1, m_new, LOG0)
        x_new = torch.where(valid & i_ge1, x_new, LOG0)
        y_new = torch.where(valid | row0, y_new, LOG0)
        # collect terminal likelihood at i == rlen (free hap tail)
        term = torch.where(at_end & valid, _logsumexp2(m_new, x_new), LOG0)
        terms[:, a - 1] = term.max(dim=1).values
        m2, x2, y2 = m1, x1, y1
        m1, x1, y1 = m_new, x_new, y_new
    # total likelihood: sum over end positions j (free tail) -- use
    # logsumexp over per-diagonal terminal maxima as an approximation of
    # the best end point family; exact enough for LR comparisons
    mt = terms.max(dim=1).values
    mt_safe = mt.clamp(min=LOG0 / 2)
    out = mt + torch.log(torch.exp(terms - mt_safe[:, None]).sum(dim=1))
    return out.cpu().numpy()


def site_allele_loglik(
    read_segs: np.ndarray,   # (B, L) uint8 read windows
    seg_lens: np.ndarray,
    ref_windows: np.ndarray, # (B, Lh)
    window_lens_ref: np.ndarray,
    alt_windows: np.ndarray,
    window_lens_alt: np.ndarray,
    quals: np.ndarray | None = None,
    **kw,
) -> tuple[np.ndarray, np.ndarray]:
    """(logP(read|ref), logP(read|alt)) per read window -- the allele
    assignment evidence longshot derives from realignment."""
    lr = pairhmm_forward_batch(read_segs, seg_lens, ref_windows,
                               window_lens_ref, quals,
                               max_read=read_segs.shape[1],
                               max_hap=ref_windows.shape[1], **kw)
    la = pairhmm_forward_batch(read_segs, seg_lens, alt_windows,
                               window_lens_alt, quals,
                               max_read=read_segs.shape[1],
                               max_hap=alt_windows.shape[1], **kw)
    return np.asarray(lr), np.asarray(la)
