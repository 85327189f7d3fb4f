"""Batched pair-HMM forward likelihoods (the longshot/GATK-HC realignment core).

The counterpart of ``focalsv_tpu/ops/pairhmm.py``: the classic 3-state
(M/I/D) forward algorithm evaluated over *anti-diagonal wavefronts*, so
every step is a fully parallel update over the diagonal and over the batch
-- no within-row sequential dependency (cf. PAPERS.md gpuPairHMM/Endeavor,
which use the same wavefront dataflow on GPUs).

On a CUDA device the forward pass is kernel B6 (``csrc/pairhmm.cu``, wrapper
``ops/pairhmm_cuda.py``), one launch for a batch and one for both
haplotypes of ``site_allele_loglik``: a call is one copy in (lengths,
qualities and codes from a pinned buffer), the launch and one copy out, the
emissions read by B6 from a table of the device's own; a failure to build
or launch raises.
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

import functools
import threading

import numpy as np
import torch
import torch.nn.functional as F

from focalsv_tpu_torch.device import resolve_device

LOG0 = -1e30

_lock = threading.Lock()
plain_calls = 0      # calls of the plain version (the CPU path)
copies = 0           # copies between host and card that B6's entry made
_tables: dict = {}   # device -> B6's emission table
_pinned = threading.local()   # each thread's staging buffer for B6


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


def emission_table(dev) -> torch.Tensor:
    """(2, 256) float32 on ``dev``: lm_match and lm_mis of each phred
    quality 0..255, from ``_emissions``' own ops on that device, built once
    a device.  Indexed by the quality clamped to [0, 255] it gives the
    bytes of ``_emissions`` (the error probability saturates at 0.75 below
    quality 2 and at 1e-10 above 100)."""
    dev = torch.device(dev)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    with _lock:
        table = _tables.get(dev)
        if table is None:
            q = torch.arange(256, dtype=torch.int32, device=dev)[None, :]
            table = torch.cat(_emissions(q, 1, 256, dev)).contiguous()
            _tables[dev] = table
        return table


def qual_bytes(quals, B: int, M: int, out: np.ndarray | None = None):
    """Phred qualities as B6 takes them: (B, M) uint8, clamped to [0, 255]
    after the int32 conversion that ``_emissions`` makes (into ``out``
    when given)."""
    q = np.asarray(quals).reshape(B, -1)[:, :M]
    if q.dtype != np.int32:
        q = q.astype(np.int32)
    if out is None:
        out = np.empty((B, M), np.uint8)
    return np.clip(q, 0, 255, out=out, casting="unsafe")


@functools.lru_cache(maxsize=16)
def _gaps_f32(gap_open: float, gap_extend: float) -> tuple:
    """B6's float32 (l_mm, l_gm, l_go, l_ge, l_ins)."""
    g = _gap_logs(gap_open, gap_extend)
    return tuple(np.float32(g[k]) for k in ("l_mm", "l_gm", "l_go", "l_ge",
                                            "l_ins"))


def _count_copies(n: int) -> None:
    global copies
    with _lock:
        copies += n


def _staging(n: int) -> torch.Tensor:
    """This thread's pinned host buffer, at least n bytes, reused from call
    to call.  Its last copy to the card is waited for first (an event
    recorded after it), so a call that failed before its copy out cannot
    leave a copy reading the buffer while it is rewritten."""
    local = _pinned
    if getattr(local, "copied", None) is not None:
        local.copied.synchronize()
    buf = getattr(local, "buf", None)
    if buf is None or buf.numel() < n:
        size = max(n, 2 * (0 if buf is None else buf.numel()), 1 << 16)
        local.buf = buf = torch.empty(size, dtype=torch.uint8,
                                      pin_memory=True)
    return buf


def kernel_inputs(reads, read_lens, haps, quals, max_read: int,
                  dev: torch.device, gap_open: float = 1e-3,
                  gap_extend: float = 0.1) -> tuple:
    """The arguments of ``pairhmm_cuda.pairhmm_cuda`` on ``dev`` for the
    read windows against each (hap, hap_len, max_hap) of ``haps``: the
    lengths, qualities (uint8, clamped) and codes are written into one
    host buffer (this thread's pinned one on a CUDA device) and cross in
    one copy; the emission table is the device's own."""
    M = int(max_read)
    reads = np.asarray(reads)
    B = reads.shape[0]
    if reads.ndim != 2 or reads.shape[1] < M:
        raise ValueError(f"reads must be (B, >= {M}), got {reads.shape}")
    hs = [np.asarray(hap) for hap, _, _ in haps]
    widths = [int(n) for _, _, n in haps]
    for hap, N in zip(hs, widths):
        if hap.ndim != 2 or hap.shape[0] != B or hap.shape[1] < N:
            raise ValueError(f"haps must be ({B}, >= {N}), got {hap.shape}")
    # the int32 lengths (read, then each window's), then the uint8 quals,
    # read codes and window codes
    H = len(haps)
    n_int = 4 * B * (1 + H)
    n_q = 0 if quals is None else B * M
    n = n_int + n_q + B * M + B * sum(widths)
    cuda = dev.type == "cuda"
    staged = _staging(n) if cuda else torch.empty(n, dtype=torch.uint8)
    host = staged.numpy()
    lens = host[:n_int].view(np.int32).reshape(1 + H, B)
    lens[0] = read_lens
    for h, (_, hap_len, _) in enumerate(haps):
        lens[1 + h] = hap_len
    off = n_int
    if quals is not None:
        qual_bytes(quals, B, M, out=host[off: off + n_q].reshape(B, M))
        off += n_q
    np.copyto(host[off: off + B * M].reshape(B, M), reads[:, :M],
              casting="unsafe")
    off += B * M
    for hap, N in zip(hs, widths):
        np.copyto(host[off: off + B * N].reshape(B, N), hap[:, :N],
                  casting="unsafe")
        off += B * N
    if cuda:
        buf = torch.empty(n, dtype=torch.uint8, device=dev)
        buf.copy_(staged[:n], non_blocking=True)
        _count_copies(1)
        if getattr(_pinned, "copied", None) is None:
            _pinned.copied = torch.cuda.Event()
        _pinned.copied.record(torch.cuda.current_stream(dev))
    else:
        buf = staged
    words = buf[:n_int].view(torch.int32).view(1 + H, B)
    off = n_int
    quals_d = None
    if quals is not None:
        quals_d = buf[off: off + n_q].view(B, M)
        off += n_q
    reads_d = buf[off: off + B * M].view(B, M)
    off += B * M
    haps_d = []
    for h, N in enumerate(widths):
        haps_d.append((buf[off: off + B * N].view(B, N), words[1 + h]))
        off += B * N
    return (reads_d, words[0], quals_d, emission_table(dev), haps_d,
            _gaps_f32(float(gap_open), float(gap_extend)))


def pairhmm_forward_kernel(reads, read_lens, haps, quals, max_read: int,
                           dev: torch.device, gap_open: float = 1e-3,
                           gap_extend: float = 0.1, want_terms: bool = False,
                           pairs_per_warp: int | None = None):
    """Kernel B6 on the CUDA device ``dev``: log P(read | hap) (n_haps, B)
    of the read windows against each (hap, hap_len, max_hap) of ``haps``
    (one or two) from one copy in, one launch and one copy out (after the
    device's first call, which also builds its emission table); with
    ``want_terms`` also each haplotype's (B, max_read + max_hap) terms,
    copied out after the results.  The copy out waits for the stream, on
    which the copy in ran before the launch, so the thread's pinned buffer
    is free again when this returns."""
    from focalsv_tpu_torch.ops import pairhmm_cuda
    out, terms = pairhmm_cuda.pairhmm_cuda(
        *kernel_inputs(reads, read_lens, haps, quals, max_read, dev,
                       gap_open, gap_extend), want_terms=want_terms,
        pairs_per_warp=pairs_per_warp)
    out = out.cpu().numpy()
    _count_copies(1 + (len(terms) if want_terms else 0))
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
