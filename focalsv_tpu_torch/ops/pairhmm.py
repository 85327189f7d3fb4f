"""Batched pair-HMM forward likelihoods (the longshot/GATK-HC realignment core).

The counterpart of ``focalsv_tpu/ops/pairhmm.py``: the classic 3-state
(M/I/D) forward algorithm evaluated over *anti-diagonal wavefronts*, so
every step is a fully parallel update over the diagonal and over the batch
-- no within-row sequential dependency (cf. PAPERS.md gpuPairHMM/Endeavor,
which use the same wavefront dataflow on GPUs).

On a CUDA device the forward pass is kernel B6 (``csrc/pairhmm.cu``, wrapper
``ops/pairhmm_cuda.py``), one launch for a batch and one for both
haplotypes of ``site_allele_loglik``; a failure to build or launch raises.
On the CPU it is the plain version, ``pairhmm_forward_batch_plain``: the
batch axis written out (state ``(B, M + 1)`` float32 per wavefront) and the
scan a Python loop of ``M + N`` steps.  Inputs and outputs are numpy, as in
the reference.  float32 ``log`` and ``exp`` round differently in XLA and in
PyTorch, so log-likelihoods agree with the reference to about 1e-3, not bit
for bit; B6 gives the plain version's per-diagonal terms byte for byte on
the card and its result to within a rounding of the last sum.

Intended use: small local windows (read segment vs candidate-allele
haplotype window around a variant site), batched over thousands of
(read, site, allele) pairs.
"""

from __future__ import annotations

import threading

import numpy as np
import torch
import torch.nn.functional as F

from focalsv_tpu_torch.device import resolve_device

LOG0 = -1e30

_lock = threading.Lock()
plain_calls = 0      # calls of the plain version (the CPU path)


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


def _gap_logs(gap_open: float, gap_extend: float) -> dict:
    """The log transition and insert-emission probabilities."""
    return dict(l_mm=float(np.log(1.0 - 2 * gap_open)),
                l_gm=float(np.log(1.0 - gap_extend)),
                l_go=float(np.log(gap_open)), l_ge=float(np.log(gap_extend)),
                l_ins=float(np.log(0.25)))


def _emissions(quals, B: int, M: int, dev: torch.device):
    """lm_match, lm_mis (B, M) float32 from phred quals (default 30)."""
    if quals is None:
        quals = torch.full((B, M), 30, dtype=torch.int32, device=dev)
    elif not isinstance(quals, torch.Tensor):
        quals = torch.as_tensor(np.asarray(quals)).to(device=dev,
                                                      dtype=torch.int32)
    err = torch.pow(10.0, -quals.to(torch.float32) / 10.0)
    lm_match = torch.log1p(-err.clamp(1e-10, 0.75))
    lm_mis = torch.log(err.clamp(1e-10, 0.75) / 3.0)
    return lm_match, lm_mis


def pairhmm_forward_batch_plain(
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
    return_terms: bool = False,
):
    """log P(read | hap) under the 3-state pair-HMM, free hap flanks: B6's
    plain version, on any device.  With ``return_terms`` also the (B,
    max_read + max_hap) per-diagonal terms that the result sums.

    Emissions: match prob 1-e, mismatch e/3 with e from the base quality;
    insert emissions uniform (1/4).  Transitions: M->gap gap_open,
    gap->gap gap_extend.  Haplotype leading/trailing deletions are free
    (local-in-hap alignment), matching realignment-window semantics.
    """
    global plain_calls
    with _lock:
        plain_calls += 1
    dev = resolve_device(device)
    M, N = max_read, max_hap

    def on_dev(x, dtype):
        return torch.as_tensor(np.asarray(x)).to(device=dev, dtype=dtype)

    reads = on_dev(reads, torch.int64)
    haps = on_dev(haps, torch.int64)
    rlen = on_dev(read_lens, torch.int64)[:, None]
    hlen = on_dev(hap_lens, torch.int64)[:, None]
    B = reads.shape[0]
    lm_match, lm_mis = _emissions(quals, B, M, dev)

    g = _gap_logs(gap_open, gap_extend)
    l_go, l_ge, l_mm, l_gm, l_ins = (g["l_go"], g["l_ge"], g["l_mm"],
                                     g["l_gm"], g["l_ins"])

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
    if return_terms:
        return out.cpu().numpy(), terms.cpu().numpy()
    return out.cpu().numpy()


def kernel_inputs(reads, read_lens, haps, quals, max_read: int,
                  dev: torch.device, gap_open: float = 1e-3,
                  gap_extend: float = 0.1) -> tuple:
    """The arguments of ``pairhmm_cuda.pairhmm_cuda`` on ``dev`` for the
    read windows against each (hap, hap_len, max_hap) of ``haps``: the
    inputs cross in one copy, and the emissions are the plain version's
    own ops on the card."""
    M = int(max_read)
    reads = np.asarray(reads)
    B = reads.shape[0]
    if reads.ndim != 2 or reads.shape[1] < M:
        raise ValueError(f"reads must be (B, >= {M}), got {reads.shape}")
    # one host buffer: the int32 lengths and quals, then the uint8 codes
    ints = [np.asarray(read_lens, np.int32).reshape(B)]
    codes = [np.asarray(reads[:, :M], np.uint8)]
    widths = []
    for hap, hap_len, max_hap in haps:
        hap = np.asarray(hap)
        N = int(max_hap)
        if hap.ndim != 2 or hap.shape[0] != B or hap.shape[1] < N:
            raise ValueError(f"haps must be ({B}, >= {N}), got {hap.shape}")
        ints.append(np.asarray(hap_len, np.int32).reshape(B))
        codes.append(np.asarray(hap[:, :N], np.uint8))
        widths.append(N)
    if quals is not None:
        ints.append(np.asarray(quals, np.int32).reshape(B, -1)[:, :M])
    n_int = sum(x.size for x in ints)
    host = np.empty(4 * n_int + sum(x.size for x in codes), np.uint8)
    host[: 4 * n_int].view(np.int32)[:] = np.concatenate(
        [x.ravel() for x in ints])
    host[4 * n_int:] = np.concatenate([x.ravel() for x in codes])
    buf = torch.from_numpy(host).to(dev)
    words = buf[: 4 * n_int].view(torch.int32)
    rlen_d = words[:B]
    hlen_d = [words[B * (h + 1): B * (h + 2)] for h in range(len(haps))]
    quals_d = (words[B * (len(haps) + 1):].view(B, M)
               if quals is not None else None)
    lm_match, lm_mis = _emissions(quals_d, B, M, dev)
    off = 4 * n_int
    reads_d = buf[off: off + B * M].view(B, M)
    off += B * M
    haps_d = []
    for N, hl in zip(widths, hlen_d):
        haps_d.append((buf[off: off + B * N].view(B, N), hl))
        off += B * N
    g = _gap_logs(gap_open, gap_extend)
    gaps = [np.float32(g[k]) for k in ("l_mm", "l_gm", "l_go", "l_ge",
                                       "l_ins")]
    return reads_d, rlen_d, lm_match, lm_mis, haps_d, gaps


def pairhmm_forward_kernel(reads, read_lens, haps, quals, max_read: int,
                           dev: torch.device, gap_open: float = 1e-3,
                           gap_extend: float = 0.1, want_terms: bool = False):
    """Kernel B6 on the CUDA device ``dev``: log P(read | hap) (n_haps, B)
    of the read windows against each (hap, hap_len, max_hap) of ``haps``
    (one or two) from one copy in, one launch and one copy out; with
    ``want_terms`` also each haplotype's (B, max_read + max_hap) terms."""
    from focalsv_tpu_torch.ops import pairhmm_cuda
    out, terms = pairhmm_cuda.pairhmm_cuda(
        *kernel_inputs(reads, read_lens, haps, quals, max_read, dev,
                       gap_open, gap_extend), want_terms=want_terms)
    out = out.cpu().numpy()
    if want_terms:
        return out, [t.cpu().numpy() for t in terms]
    return out


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
    """log P(read | hap) under the 3-state pair-HMM, free hap flanks (see
    ``pairhmm_forward_batch_plain``): kernel B6 on a CUDA device, the plain
    version on the CPU."""
    dev = resolve_device(device)
    if dev.type == "cpu":
        return pairhmm_forward_batch_plain(
            reads, read_lens, haps, hap_lens, quals, max_read=max_read,
            max_hap=max_hap, gap_open=gap_open, gap_extend=gap_extend,
            device=dev)
    return pairhmm_forward_kernel(reads, read_lens,
                                  [(haps, hap_lens, max_hap)], quals,
                                  max_read, dev, gap_open, gap_extend)[0]


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
    assignment evidence longshot derives from realignment.  On a CUDA
    device both haplotypes are one launch of B6."""
    dev = resolve_device(kw.pop("device", None))
    if dev.type == "cuda":
        out = pairhmm_forward_kernel(
            read_segs, seg_lens,
            [(ref_windows, window_lens_ref, ref_windows.shape[1]),
             (alt_windows, window_lens_alt, alt_windows.shape[1])],
            quals, read_segs.shape[1], dev, **kw)
        return out[0], out[1]
    lr = pairhmm_forward_batch(read_segs, seg_lens, ref_windows,
                               window_lens_ref, quals,
                               max_read=read_segs.shape[1],
                               max_hap=ref_windows.shape[1], device=dev, **kw)
    la = pairhmm_forward_batch(read_segs, seg_lens, alt_windows,
                               window_lens_alt, quals,
                               max_read=read_segs.shape[1],
                               max_hap=alt_windows.shape[1], device=dev, **kw)
    return np.asarray(lr), np.asarray(la)
