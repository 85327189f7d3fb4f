"""Device-batched region compute: the production phasing + consensus step.

The host builds one tile per region (pipeline/device_exec.py bucketizes
them); the device then runs, for a whole region batch in ONE call:

- het-site detection: per-column base counts, integer-thresholded het band,
  f32-balance strip site selection (phasing/phase.py::find_het_sites +
  select_sites_strips, bit-identical by construction);
- 3-sigma co-phasing site purification (phasing/phase.py::purify_sites,
  exact integer reformulation);
- MEC phasing: chained adjacent-site parity init (as a cumulative XOR) +
  alternating majority refinement, per phase block (phasing/phase.py::
  mec_phase);
- haplotype consensus voting: per-column 6-symbol counts {A,C,G,T,N,DEL}
  weighted by the read assignment, unphased reads voting in both haplotypes
  (assembly/consensus.py::_column_vote over group_reads_by_block groups).

This is the PyTorch port of focalsv_tpu/parallel/region_step.py, which is
XLA device code.  The reference vmaps one region's function over the batch;
here every function takes the region batch G as its leading axis, scatters
write into one flat (G x (L+1)) buffer at per-region offsets, and Python
loops replace lax.fori_loop.  Every threshold comparison is integer
arithmetic (int32 throughout: sums and cumsums name their dtype, since torch
would promote them to int64) and every ratio is a correctly-rounded f32
division, so the results are byte-identical to the reference's and to the
host implementations -- the contract tests/test_torch_region_step.py
enforces.

Transfer format: each chunk arrives as ONE uint8 buffer (parallel/wire.py
delta_flat_layout / rows_flat_layout) and results leave as one flat uint8
buffer per region (wire.flat_layout / flat_layout_rle).

The ``sharded_*`` entries split a region batch over a mesh
(parallel/mesh.py): host arrays in, each shard's step on its device and its
own stream, the unsharded call's result back on the host in region order.
Where the reference caches a jitted ``shard_map`` per mesh and shape to
avoid retracing, there is nothing to cache here.
"""

from __future__ import annotations

import numpy as np
import torch

from focalsv_tpu_torch.parallel.mesh import (PendingResult, host_array,
                                       map_to_host, split_batch)
# flat_layout, pack_row_tile and unflatten_result live in wire.py (no torch
# needed) and are handed on to this module's callers, as the reference does
from focalsv_tpu_torch.parallel.wire import (BLOCK, DEL_SYM, NOCOV,  # noqa: F401
                                       delta_flat_layout, flat_layout,
                                       pack_row_tile, rows_flat_layout,
                                       unflatten_result)

i32 = torch.int32
ALLELE_CODES = (0, 1, 2, 3, DEL_SYM)
# working-set bound of the dense entry: expanded (R, L) pileups alive at once
DENSE_INNER = 8
# the step's knobs and their defaults (phase_consensus_kwargs sets the first
# eight from a PhasingConfig)
STEP_DEFAULTS = dict(
    max_sites=512, mec_iters=30, min_site_depth=4, min_minor_count=2,
    lo_num=1, lo_den=4,         # min_allele_frac as a rational
    hi_num=3, hi_den=4,         # max_allele_frac as a rational
    purify_window=4, purify_min_pairs=4,
    purify_num=1, purify_den=2,  # purify min_corr as a rational
)


def _step_kw(kw: dict) -> dict:
    unknown = set(kw) - set(STEP_DEFAULTS)
    if unknown:
        raise TypeError(f"unknown region-step arguments {sorted(unknown)}")
    return {**STEP_DEFAULTS, **kw}


def _argmax_first(x: torch.Tensor) -> torch.Tensor:
    """argmax over a short last axis taking the FIRST maximum, as
    jnp.argmax does (written out so the tie rule holds on every device)."""
    best = x[..., 0]
    idx = torch.zeros_like(best, dtype=torch.int64)
    for k in range(1, x.shape[-1]):
        upd = x[..., k] > best
        idx = torch.where(upd, k, idx)
        best = torch.maximum(best, x[..., k])
    return idx


def _flat_add(G: int, n: int, idx: torch.Tensor, w: torch.Tensor
              ) -> torch.Tensor:
    """Per-region scatter-add into a (G, n) int32 buffer: idx/w are (G, D)
    and region g's indices are offset by g * n into one flat buffer."""
    off = torch.arange(G, dtype=torch.int64, device=idx.device)[:, None] * n
    out = torch.zeros(G * n, dtype=i32, device=idx.device)
    out.index_add_(0, (idx.long() + off).reshape(-1), w.reshape(-1).to(i32))
    return out.reshape(G, n)


def _span_counts(G: int, L: int, a: torch.Tensor, b: torch.Tensor,
                 w: torch.Tensor) -> torch.Tensor:
    """(G, L) count of weighted [a, b) spans covering each column: a
    diff-array scatter plus an int32 prefix sum."""
    d = _flat_add(G, L + 1, torch.cat([a, b], 1), torch.cat([w, -w], 1))
    return torch.cumsum(d, dim=1, dtype=i32)[:, :L]


def _unpack_nibbles(packed: torch.Tensor, L: int) -> torch.Tensor:
    """(..., L/2) split-half packed -> (..., L) uint8 pileup symbols
    (n < 5 -> n, 5 -> DEL_SYM, else NOCOV)."""
    def inv(n):
        return torch.where(n < 5, n, torch.where(n == 5, DEL_SYM, NOCOV)
                           ).to(torch.uint8)
    lo = inv(packed & 0xF)
    hi = inv(packed >> 4)
    return torch.cat([lo, hi], dim=-1)[..., :L]


def _select_sites_strips_dynamic(bal: torch.Tensor, L_true: torch.Tensor,
                                 S: int):
    """Per-strip best-balance site selection with the TRUE region length.

    The padded kernel length L_pad is a bucket shape; strip geometry must
    come from the region's REAL length or the partition differs from the
    host's `select_sites_strips`.  Two exact segment reductions over the
    strip ids: per-strip max balance, then per-strip MIN column among the
    balance ties -- argmax's lowest-index tie rule.  bal (G, Lp) f32,
    L_true (G,).  Returns (site_pos (G, S) i32, sel (G, S) bool), site s
    belonging to strip s in ascending position order.
    """
    G, Lp = bal.shape
    dev = bal.device
    strip = torch.clamp((L_true.to(i32) + S - 1) // S, min=1)
    col = torch.arange(Lp, dtype=i32, device=dev)[None, :]
    stripe = torch.clamp(col // strip[:, None], max=S - 1).long()
    best_bal = torch.full((G, S), -1.0, dtype=torch.float32, device=dev
                          ).scatter_reduce(1, stripe, bal, "amax",
                                           include_self=True)
    is_best = bal == torch.gather(best_bal, 1, stripe)
    best_col = torch.full((G, S), Lp, dtype=i32, device=dev).scatter_reduce(
        1, stripe, torch.where(is_best, col, Lp).to(i32), "amin",
        include_self=True)
    sel = best_bal > 0
    return torch.where(sel, best_col, 0).to(i32), sel


def _het_sites(counts: torch.Tensor, L_true: torch.Tensor, *, S,
               min_site_depth, min_minor_count, lo_num, lo_den, hi_num,
               hi_den):
    """Het-site detection over the 5 allele symbols {A,C,G,T,DEL} and strip
    selection, compacted to the front.  counts (G, L, 5) int32.  Returns
    (a0, a1, site_pos, sel, sa0, sa1, code_map)."""
    dev = counts.device
    depth = counts.sum(2, dtype=i32)
    a0 = _argmax_first(counts)
    masked = torch.where(
        torch.arange(5, device=dev) == a0[..., None], -1, counts)
    a1 = _argmax_first(masked)
    top1 = masked.amax(2)                 # minor-allele count
    n0 = counts.amax(2)                   # major-allele count
    is_het = ((depth >= max(min_site_depth, 1))
              & (top1 * lo_den >= depth * lo_num)
              & (top1 * hi_den <= depth * hi_num)
              & (top1 >= min_minor_count))
    bal = torch.where(
        is_het,
        top1.to(torch.float32)
        / torch.clamp(n0 + top1, min=1).to(torch.float32),
        torch.tensor(-1.0, dtype=torch.float32, device=dev))
    site_pos, sel = _select_sites_strips_dynamic(bal, L_true, S)
    # compact selected sites to the front (position order preserved)
    slot0 = torch.arange(S, dtype=i32, device=dev)
    order0 = torch.argsort(torch.where(sel, slot0, S + slot0), dim=1,
                           stable=True)
    site_pos = torch.gather(site_pos, 1, order0)
    sel = torch.gather(sel, 1, order0)
    site_pos = torch.where(sel, site_pos, 0)   # keep invalid gathers in range
    code_map = torch.tensor(ALLELE_CODES, dtype=torch.uint8, device=dev)
    sa0 = code_map[torch.gather(a0, 1, site_pos.long())]
    sa1 = code_map[torch.gather(a1, 1, site_pos.long())]
    return a0, a1, site_pos, sel, sa0, sa1, code_map


def _allele_matrix(sub, sa0, sa1, sel, rv):
    """(G, R, S) int8: 0 = major allele, 1 = minor, -1 = neither/unused."""
    A = torch.where(sub == sa0[:, None, :], 0,
                    torch.where(sub == sa1[:, None, :], 1, -1)).to(torch.int8)
    return torch.where(sel[:, None, :] & rv[:, :, None], A, -1).to(torch.int8)


def _phase_core(A, site_pos, sel, rv, a0, a1, code_map, *,
                mec_iters, purify_window, purify_min_pairs,
                purify_num, purify_den):
    """Shared phasing core: purification -> site compaction -> PER-BLOCK
    MEC -> per-read haplotype/block assignment -> per-site summaries.

    Blocks are maximal runs of consecutive sites linked by >=1 co-covering
    read (phasing/phase.py::phase_blocks); MEC runs independently per
    block via prefix-sum block aggregation, bit-matching the host's
    per-block mec_phase loop.  Reads take the assignment of the block of
    their FIRST covered site.  A (G, R, S) int8.

    Returns (site_pos, n_sites, A, hp, read_block (G, R) i16 (-1 =
    unphased), sa0, sa1, site_h, conn).
    """
    G, R, S = A.shape
    dev = A.device

    # --- purification (integer 3-sigma co-phasing test) ---------------
    covA = A >= 0
    passed = torch.zeros((G, S), dtype=torch.bool, device=dev)
    for d in range(1, min(purify_window, S - 1) + 1):
        both = covA[:, :, :-d] & covA[:, :, d:]
        n = both.sum(1, dtype=i32)
        same = ((A[:, :, :-d] == A[:, :, d:]) & both).sum(1, dtype=i32)
        dv = torch.abs(2 * same - n)
        ok = ((n >= purify_min_pairs)
              & (dv * purify_den >= n * purify_num)
              & (dv * dv >= 9 * n))
        pad = torch.zeros((G, d), dtype=torch.bool, device=dev)
        passed = passed | torch.cat([ok, pad], 1) | torch.cat([pad, ok], 1)
    n_het = sel.sum(1, dtype=i32)
    # <2 sites: purify is a no-op
    passed = torch.where(n_het[:, None] >= 2, passed, sel)
    new_valid = sel & passed
    # re-compact (valid sites keep ascending position order)
    slot = torch.arange(S, dtype=i32, device=dev)
    order2 = torch.argsort(torch.where(new_valid, slot, S + slot), dim=1,
                           stable=True)
    A = torch.gather(A, 2, order2[:, None, :].expand(G, R, S))
    site_pos = torch.gather(site_pos, 1, order2)
    new_valid = torch.gather(new_valid, 1, order2)
    A = torch.where(new_valid[:, None, :], A, -1).to(torch.int8)
    n_sites = new_valid.sum(1, dtype=i32)

    # --- block structure ----------------------------------------------
    covA = A >= 0
    link = (covA[:, :, :-1] & covA[:, :, 1:]).any(1)          # (G, S-1)
    ar = torch.arange(S, dtype=i32, device=dev)[None, :]
    ones = torch.ones((G, 1), dtype=torch.bool, device=dev)
    is_start = torch.cat([ones, ~link], 1)
    start_of = torch.cummax(torch.where(is_start, ar, 0), dim=1).values
    is_end = torch.cat([~link, ones], 1)
    end_of = torch.flip(torch.cummin(
        torch.flip(torch.where(is_end, ar, S - 1), [1]), dim=1).values, [1])
    blk = torch.cumsum(torch.cat([torch.zeros((G, 1), dtype=i32, device=dev),
                                  (~link).to(i32)], 1), dim=1, dtype=i32)

    # --- MEC phasing (per block) --------------------------------------
    # chained adjacent-site parity init (cumulative XOR, reset per block)
    both = covA[:, :, :-1] & covA[:, :, 1:]
    nb = both.sum(1, dtype=i32)
    same = ((A[:, :, :-1] == A[:, :, 1:]) & both).sum(1, dtype=i32)
    flip = ((nb > 0) & (same < nb - same)).to(i32)
    H = torch.cat([torch.zeros((G, 1), dtype=i32, device=dev),
                   torch.cumsum(flip, dim=1, dtype=i32)], 1)
    h = ((H - torch.gather(H, 1, start_of.long())) % 2).to(torch.int8)

    end_idx = end_of.long()[:, None, :].expand(G, R, S)
    lo_idx = torch.clamp(start_of - 1, min=0).long()[:, None, :].expand(
        G, R, S)
    has_lo = (start_of > 0)[:, None, :]

    def bsum(Mx):
        """Per-site sums of Mx over the site's block (prefix-sum gather)."""
        P = torch.cumsum(Mx, dim=2, dtype=i32)
        hi = torch.gather(P, 2, end_idx)
        lo = torch.where(has_lo, torch.gather(P, 2, lo_idx), 0)
        return hi - lo

    def assign(h):
        agree = bsum(((A == h[:, None, :]) & covA).to(i32))
        dis = bsum(((A == (1 - h)[:, None, :]) & covA).to(i32))
        return agree >= dis        # read assigned hap1 within s's block

    is1 = (A == 1) & covA
    is0 = (A == 0) & covA
    for _ in range(mec_iters):
        as0 = assign(h)
        v1 = (is1 & as0).sum(1, dtype=i32) + (is0 & ~as0).sum(1, dtype=i32)
        v0 = (is0 & as0).sum(1, dtype=i32) + (is1 & ~as0).sum(1, dtype=i32)
        h = torch.where(v1 > v0, 1, 0).to(torch.int8)
    as0 = assign(h)
    # first covered site (argmax of the coverage row; 0 when uncovered)
    has = covA.any(2)
    fs = torch.where(covA, ar[:, None, :], S).amin(2)
    fs = torch.where(has, fs, 0).long()
    a_first = torch.gather(as0, 2, fs[..., None])[..., 0]
    ok = rv & has
    hp = torch.where(ok, torch.where(a_first, 1, 2), 0).to(torch.int8)
    read_block = torch.where(ok, torch.gather(blk, 1, fs), -1
                             ).to(torch.int16)

    # --- per-site summaries shipped INSTEAD of the (R, S) allele matrix
    sp = site_pos.long()
    sa0 = code_map[torch.gather(a0, 1, sp)]
    sa1 = code_map[torch.gather(a1, 1, sp)]
    hap1 = (hp == 1)[:, :, None]
    hap2 = (hp == 2)[:, :, None]
    v1 = (((A == 1) & hap1).sum(1, dtype=i32)
          + ((A == 0) & hap2).sum(1, dtype=i32))
    v0 = (((A == 0) & hap1).sum(1, dtype=i32)
          + ((A == 1) & hap2).sum(1, dtype=i32))
    site_h = (v1 > v0).to(torch.uint8)
    conn = torch.cat([link, torch.zeros((G, 1), dtype=torch.bool,
                                        device=dev)], 1).to(torch.uint8)
    return site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h, conn


def _one_region(
    m, rv, L_true, *,
    max_sites, mec_iters, min_site_depth, min_minor_count,
    lo_num, lo_den, hi_num, hi_den,
    purify_window, purify_min_pairs, purify_num, purify_den,
):
    """Phasing + consensus of a batch of dense pileup tiles.

    m (G, R, L) uint8 (254 = del, 255 = nocov), rv (G, R) bool, L_true
    (G,) the regions' REAL lengths (strip geometry; L is a padded bucket).

    Returns (site_pos (G,S) i32, n_sites (G,) i32, A (G,R,S) i8, hp (G,R)
    i8, sym (G,2,L) u8, covered (G,2,L) bool, sa0, sa1, site_h, conn,
    read_block).
    """
    S = max_sites
    counts = torch.stack([(m == b).sum(1, dtype=i32) for b in ALLELE_CODES],
                         dim=2)
    a0, a1, site_pos, sel, sa0, sa1, code_map = _het_sites(
        counts, L_true, S=S, min_site_depth=min_site_depth,
        min_minor_count=min_minor_count, lo_num=lo_num, lo_den=lo_den,
        hi_num=hi_num, hi_den=hi_den)
    G, R, _ = m.shape
    sub = torch.gather(m, 2, site_pos.long()[:, None, :].expand(G, R, S))
    A = _allele_matrix(sub, sa0, sa1, sel, rv)

    (site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h,
     conn) = _phase_core(
        A, site_pos, sel, rv, a0, a1, code_map,
        mec_iters=mec_iters, purify_window=purify_window,
        purify_min_pairs=purify_min_pairs, purify_num=purify_num,
        purify_den=purify_den)

    # --- consensus votes per haplotype (unphased reads vote in both) --
    def vote(mask):
        use = ((mask | (hp == 0)) & rv)[:, :, None]
        c = torch.stack(
            [((m == b) & use).sum(1, dtype=i32) for b in range(5)]
            + [((m == DEL_SYM) & use).sum(1, dtype=i32)], dim=2)
        return _argmax_first(c).to(torch.uint8), c.sum(2, dtype=i32) > 0

    s1, c1 = vote(hp == 1)
    s2, c2 = vote(hp == 2)
    return (site_pos, n_sites, A, hp,
            torch.stack([s1, s2], 1), torch.stack([c1, c2], 1),
            sa0, sa1, site_h, conn, read_block)


def _u8(x: torch.Tensor) -> torch.Tensor:
    """(G, ...) tensor -> (G, nbytes) uint8, little-endian like the host's
    np .view packing."""
    G = x.shape[0]
    return x.contiguous().reshape(G, -1).view(torch.uint8)


def _packbits(bits: torch.Tensor) -> torch.Tensor:
    """(G, n) bool -> (G, n/8) uint8, big-endian bit order (jnp.packbits)."""
    G, n = bits.shape
    w = torch.tensor([128, 64, 32, 16, 8, 4, 2, 1], dtype=i32,
                     device=bits.device)
    return (bits.reshape(G, n // 8, 8).to(i32) * w).sum(2, dtype=i32
                                                        ).to(torch.uint8)


def _flat_parts(res_tuple, L):
    """Assemble the regions' flat result buffers (wire.flat_layout)."""
    (site_pos, n_sites, _A, hp, sym, cov,
     sa0, sa1, site_h, conn, read_block) = res_tuple
    G = sym.shape[0]
    # split-half 4-bit pack of the (2, L) consensus symbols (values 0..5)
    h = L // 2
    symnib = (sym[:, :, :h] | (sym[:, :, h:] << 4)).to(torch.uint8)
    return torch.cat([
        _u8(n_sites), _u8(site_pos), sa0, sa1, site_h, conn,
        _u8(hp), _u8(read_block), symnib.reshape(G, -1),
        _packbits(cov.reshape(G, -1)),
    ], dim=1)


def _flat_parts_rle(res_tuple, ref, ltrue, Drle):
    """Flat result with RUN-LENGTH-ENCODED consensus tracks (vs the region
    reference the delta step already holds): wire.flat_layout_rle.

    state = voted symbol 0..5 when covered, 7 when uncovered; a track whose
    true run count exceeds Drle reports it via n_runs and the host falls
    back to the per-region host path (exact, just slower).  Runs are
    located with cumsum + searchsorted (left-sided, the default on both
    sides): the i-th run starts at the first column whose boundary-cumsum
    is i+1.
    """
    (site_pos, n_sites, _A, hp, sym, cov,
     sa0, sa1, site_h, conn, read_block) = res_tuple
    G, _, L = sym.shape
    dev = sym.device
    colv = torch.arange(L, dtype=i32, device=dev)[None, :] < ltrue[:, None]
    targets = torch.arange(1, Drle + 2, dtype=i32, device=dev
                           ).expand(G, Drle + 1).contiguous()

    def track(k):
        s = sym[:, k]
        c = cov[:, k]
        state = torch.where(c, s, 7).to(torch.uint8)
        dv = colv & ~(c & (s == ref))
        prev_dev = torch.cat([torch.zeros((G, 1), dtype=torch.bool,
                                          device=dev), dv[:, :-1]], 1)
        prev_state = torch.cat([torch.full((G, 1), 255, dtype=torch.uint8,
                                           device=dev), state[:, :-1]], 1)
        boundary = dv & (~prev_dev | (state != prev_state))
        cb = torch.cumsum(boundary.to(i32), dim=1, dtype=i32)
        n_runs = cb[:, -1]
        cd2 = torch.cat([torch.zeros((G, 1), dtype=i32, device=dev),
                         torch.cumsum(dv.to(i32), dim=1, dtype=i32)], 1)
        starts = torch.searchsorted(cb, targets)                # (G, Drle+1)
        run_start = starts[:, :Drle]
        run_len = (torch.gather(cd2, 1, starts[:, 1:])
                   - torch.gather(cd2, 1, run_start))
        run_val = torch.gather(state, 1, torch.clamp(run_start, 0, L - 1))
        return n_runs, run_start.to(i32), run_len.to(i32), run_val

    n0, rs0, rl0, rv0 = track(0)
    n1, rs1, rl1, rv1 = track(1)
    return torch.cat([
        _u8(n_sites), _u8(site_pos), sa0, sa1, site_h, conn,
        _u8(hp), _u8(read_block),
        _u8(torch.stack([n0, n1], 1)),
        _u8(torch.stack([rs0, rs1], 1)),
        _u8(torch.stack([rl0, rl1], 1)),
        rv0, rv1,
    ], dim=1)


def _one_region_delta(
    ref, starts, ends, rv, sub_pos, sub_read, sub_sym,
    del_read, del_a, del_b, L_true, *,
    max_sites, mec_iters, min_site_depth, min_minor_count,
    lo_num, lo_den, hi_num, hi_den,
    purify_window, purify_min_pairs, purify_num, purify_den,
):
    """Phasing + consensus of a region batch from REFERENCE-DELTA reads.

    The pileup never exists: each read is its covered span [start, end)
    plus sparse deviations from the reference -- substitutions (col, sym)
    and deletion runs [a, b).  Column symbol counts are reconstructed
    exactly (integer event cumsums + scatter-adds), so every downstream
    quantity is bit-identical to the dense-tile step `_one_region`.

    Shapes: ref (G, L) u8; starts/ends (G, R) i32 region columns; rv (G, R)
    bool; sub_* (G, Dsub) with read < 0 on padding; del_* (G, Ddel)
    likewise; L_true (G,).  Returns the `_one_region` output tuple.
    """
    G, L = ref.shape
    R = starts.shape[1]
    S = max_sites
    dev = ref.device

    rw = rv.to(i32)
    vstart = torch.where(rv, starts, 0)
    vend = torch.where(rv, ends, 0)
    cov = _span_counts(G, L, vstart, vend, rw)

    wd = del_read >= 0
    wdi = wd.to(i32)
    da = torch.where(wd, del_a, 0)
    db = torch.where(wd, del_b, 0)
    delcov = _span_counts(G, L, da, db, wdi)

    ws = sub_read >= 0
    wsi = ws.to(i32)
    sp = torch.where(ws, sub_pos, L)          # padding -> dump column L
    nsubs = _flat_add(G, L + 1, sp, wsi)[:, :L]
    # per-symbol substitution counts incl. N (col 4): alleles use :4,
    # the consensus vote uses all 5
    sym5 = torch.clamp(sub_sym, 0, 4).to(i32)
    subcnt = _flat_add(G, (L + 1) * 5, sp * 5 + sym5, wsi
                       ).reshape(G, L + 1, 5)[:, :L]

    base = cov - delcov - nsubs             # reads matching ref per column
    ref_i = ref.to(i32)
    oh4 = ref_i[:, :, None] == torch.arange(4, dtype=i32, device=dev)
    counts = torch.cat([base[:, :, None] * oh4 + subcnt[:, :, :4],
                        delcov[:, :, None]], 2)

    a0, a1, site_pos, sel, sa0, sa1, code_map = _het_sites(
        counts, L_true, S=S, min_site_depth=min_site_depth,
        min_minor_count=min_minor_count, lo_num=lo_num, lo_den=lo_den,
        hi_num=hi_num, hi_den=hi_den)

    # --- allele matrix from the deltas (dense: sub = m[:, site_pos]) ----
    # per-site read symbol = ref unless a substitution lands on the site
    # (col->slot inverse map + one scatter) or a deletion run covers it.
    # Both index_put_ calls write duplicate indices only into dump slots
    # (column L; row R / column S), whose values are never read.
    slots = torch.arange(S, dtype=i32, device=dev).expand(G, S)
    offL = torch.arange(G, dtype=torch.int64, device=dev)[:, None] * (L + 1)
    col2slot = torch.full((G * (L + 1),), S, dtype=i32, device=dev)
    col2slot[(torch.where(sel, site_pos, L).long() + offL).reshape(-1)] = \
        slots.reshape(-1)
    col2slot = col2slot.reshape(G, L + 1)
    base_sym = torch.gather(ref, 1, site_pos.long())               # (G, S)
    a_sym = torch.full((G, R + 1, S + 1), NOCOV, dtype=torch.uint8,
                       device=dev)
    a_sym[:, :R, :S] = base_sym[:, None, :]
    sub_r = torch.where(ws, sub_read, R).long()
    sub_slot = torch.where(ws, torch.gather(col2slot, 1, sp.long()), S).long()
    offRS = torch.arange(G, dtype=torch.int64, device=dev)[:, None] * (
        (R + 1) * (S + 1))
    a_sym.view(-1)[(offRS + sub_r * (S + 1) + sub_slot).reshape(-1)] = \
        sub_sym.reshape(-1)
    # deletion-run coverage of sites: (Ddel, S) membership, scatter-add
    # into reads (duplicate rows accumulate)
    spn = site_pos[:, None, :]
    inside = ((spn >= da[:, :, None]) & (spn < db[:, :, None])
              & wd[:, :, None] & sel[:, None, :]).to(i32)       # (G, Dd, S)
    del_r = torch.where(wd, del_read, R).long()
    offR = torch.arange(G, dtype=torch.int64, device=dev)[:, None] * (R + 1)
    a_del = torch.zeros((G * (R + 1), S), dtype=i32, device=dev)
    a_del.index_add_(0, (del_r + offR).reshape(-1), inside.reshape(-1, S))
    a_del = a_del.reshape(G, R + 1, S)[:, :R]
    span_cov = ((spn >= starts[:, :, None]) & (spn < ends[:, :, None])
                & rv[:, :, None])
    sub = torch.where(a_del > 0, DEL_SYM, a_sym[:, :R, :S]).to(torch.uint8)
    sub = torch.where(span_cov, sub, NOCOV).to(torch.uint8)
    A = _allele_matrix(sub, sa0, sa1, sel, rv)

    (site_pos, n_sites, A, hp, read_block, sa0, sa1, site_h,
     conn) = _phase_core(
        A, site_pos, sel, rv, a0, a1, code_map,
        mec_iters=mec_iters, purify_window=purify_window,
        purify_min_pairs=purify_min_pairs, purify_num=purify_num,
        purify_den=purify_den)

    # --- consensus votes per haplotype from the deltas -----------------
    # (dense `vote` reconstruction: per-column 6-symbol counts over the
    # use-mask; ref-matching reads contribute to the ref symbol, subs to
    # their own symbol incl. N, deletion runs to the DEL column)
    oh5 = ref_i[:, :, None] == torch.arange(5, dtype=i32, device=dev)

    def vote(mask):
        use = (mask | (hp == 0)) & rv
        cov_u = _span_counts(G, L, vstart, vend, use.to(i32))
        use1 = torch.cat([use, torch.zeros((G, 1), dtype=torch.bool,
                                           device=dev)], 1)
        wdu = (wd & torch.gather(use1, 1, del_r)).to(i32)
        del_u = _span_counts(G, L, da, db, wdu)
        wsu = (ws & torch.gather(use1, 1, sub_r)).to(i32)
        nsubs_u = _flat_add(G, L + 1, sp, wsu)[:, :L]
        subcnt_u = _flat_add(G, (L + 1) * 5, sp * 5 + sym5, wsu
                             ).reshape(G, L + 1, 5)[:, :L]
        base_u = cov_u - del_u - nsubs_u
        c = torch.cat([base_u[:, :, None] * oh5 + subcnt_u,
                       del_u[:, :, None]], 2)
        return _argmax_first(c).to(torch.uint8), c.sum(2, dtype=i32) > 0

    s1, c1 = vote(hp == 1)
    s2, c2 = vote(hp == 2)
    return (site_pos, n_sites, A, hp,
            torch.stack([s1, s2], 1), torch.stack([c1, c2], 1),
            sa0, sa1, site_h, conn, read_block)


def _u8_to_i32(seg: torch.Tensor, *shape: int) -> torch.Tensor:
    """uint8 segment -> int32 tensor (little-endian bitcast, matching the
    host's np .view packing).  Every wire section starts 4-byte aligned."""
    return seg.view(torch.int32).reshape(*shape)


def _sections(buf: torch.Tensor, lay: dict):
    def seg(name):
        a, b = lay[name]
        return buf[a:b]
    return seg


def phase_consensus_delta_flat(
    buf: torch.Tensor,       # (total,) uint8, delta_flat_layout
    *,
    G: int, R: int, L: int, Ds: int, Dd: int,
    Drle: int = 0,           # >0: RLE consensus tracks (flat_layout_rle)
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
) -> torch.Tensor:
    """Production entry for DELTA-encoded region chunks: unpacks
    delta_flat_layout on the buffer's device and returns (G, bytes) uint8,
    one flat result per region (flat_layout, or flat_layout_rle when
    Drle > 0)."""
    seg = _sections(buf, delta_flat_layout(G, R, L, Ds, Dd))
    ref = seg("ref").reshape(G, L)
    ltrue = _u8_to_i32(seg("ltrue"), G)
    out = _one_region_delta(
        ref,
        _u8_to_i32(seg("starts"), G, R),
        _u8_to_i32(seg("ends"), G, R),
        seg("rv").reshape(G, R) != 0,
        _u8_to_i32(seg("sub_pos"), G, Ds),
        _u8_to_i32(seg("sub_read"), G, Ds),
        seg("sub_sym").reshape(G, Ds),
        _u8_to_i32(seg("del_read"), G, Dd),
        _u8_to_i32(seg("del_a"), G, Dd),
        _u8_to_i32(seg("del_b"), G, Dd),
        ltrue,
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)
    if Drle:
        return _flat_parts_rle(out, ref, ltrue, Drle)
    return _flat_parts(out, L)


def phase_consensus_batch(mat: torch.Tensor, read_valid: torch.Tensor,
                          **kw):
    """Unpacked-tile entry (tests, dry runs): mat (G, R, L) uint8 pileup
    tiles (254 = del, 255 = nocov), read_valid (G, R) bool.  Returns, with a
    leading G axis: site_pos (S,) i32, n_sites i32, A (R, S) i8, hp (R,) i8,
    sym (2, L) u8, covered (2, L) bool."""
    G, _, L = mat.shape
    ltrue = torch.full((G,), L, dtype=i32, device=mat.device)
    return _one_region(mat, read_valid, ltrue, **_step_kw(kw))[:6]


def _dense_inner(G: int, one) -> torch.Tensor:
    """``one(g0, g1)`` over DENSE_INNER regions at a time, concatenated:
    the expanded (R, L) pileups and their vote temporaries exist for one
    inner chunk at a time."""
    return torch.cat([one(g0, min(g0 + DENSE_INNER, G))
                      for g0 in range(0, G, DENSE_INNER)], 0)


def phase_consensus_batch_packed(packed: torch.Tensor,
                                 read_valid: torch.Tensor, *, L: int, **kw
                                 ) -> torch.Tensor:
    """Packed 4-bit tiles in (packed (G, R, L//2), wire.pack_nibbles), ONE
    flat uint8 buffer per region out (flat_layout).  L must be a multiple
    of 8."""
    kw = _step_kw(kw)
    G = packed.shape[0]
    ltrue = torch.full((G,), L, dtype=i32, device=packed.device)

    def one(g0, g1):
        m = _unpack_nibbles(packed[g0:g1], L)
        return _flat_parts(_one_region(m, read_valid[g0:g1], ltrue[g0:g1],
                                       **kw), L)

    return _dense_inner(G, one)


def phase_consensus_delta(ref, starts, ends, read_valid, sub_pos, sub_read,
                          sub_sym, del_read, del_a, del_b, ltrue=None, *,
                          L: int, **kw) -> torch.Tensor:
    """DELTA-encoded region tiles as separate tensors (the arguments of
    `_one_region_delta`; ltrue None = L): ONE flat uint8 buffer per region
    out (flat_layout), bit-identical to the dense-tile entries."""
    if ltrue is None:
        ltrue = torch.full((ref.shape[0],), L, dtype=i32, device=ref.device)
    return _flat_parts(_one_region_delta(
        ref, starts, ends, read_valid, sub_pos, sub_read, sub_sym, del_read,
        del_a, del_b, ltrue, **_step_kw(kw)), L)


def phase_consensus_rows_packed(packed_rows: torch.Tensor,
                                row_qstart: torch.Tensor,
                                read_valid: torch.Tensor, ltrue=None, *,
                                L: int, W: int, **kw) -> torch.Tensor:
    """COMPACT row tiles: packed_rows (G, R, W//2) split-half packed rows,
    row_qstart (G, R) int32 region BLOCK index of each row (the host
    pre-shifts each row by start % BLOCK), read_valid (G, R) bool, ltrue
    (G,) int32 true region lengths (None = L).  Rows expand into the (R, L)
    pileup on the device, BLOCK-contiguous chunks at a time, at most
    DENSE_INNER expanded pileups at once.  Output: (G, bytes) uint8 in
    flat_layout."""
    kw = _step_kw(kw)
    if L % BLOCK or W % BLOCK:
        raise ValueError(f"L={L} and W={W} must be multiples of {BLOCK}")
    nb_out, nb_in = L // BLOCK, W // BLOCK
    G, R = packed_rows.shape[:2]
    dev = packed_rows.device
    if ltrue is None:
        ltrue = torch.full((G,), L, dtype=i32, device=dev)

    def one(g0, g1):
        n = g1 - g0
        rb = _unpack_nibbles(packed_rows[g0:g1], W).reshape(n, R, nb_in,
                                                            BLOCK)
        idx = (torch.arange(nb_out, dtype=i32, device=dev)[None, None]
               - row_qstart[g0:g1, :, None])                  # (n, R, nb_out)
        inb = (idx >= 0) & (idx < nb_in)
        gat = torch.gather(rb, 2, torch.clamp(idx, 0, nb_in - 1).long()
                           [..., None].expand(n, R, nb_out, BLOCK))
        m = torch.where(inb[..., None], gat, NOCOV).to(torch.uint8
                                                       ).reshape(n, R, L)
        return _flat_parts(_one_region(m, read_valid[g0:g1], ltrue[g0:g1],
                                       **kw), L)

    return _dense_inner(G, one)


def phase_consensus_rows_flat(
    buf: torch.Tensor,       # (total,) uint8, rows_flat_layout
    *,
    G: int, R: int, L: int, W: int,
    max_sites: int = 512,
    mec_iters: int = 30,
    min_site_depth: int = 4,
    min_minor_count: int = 2,
    lo_num: int = 1, lo_den: int = 4,
    hi_num: int = 3, hi_den: int = 4,
    purify_window: int = 4,
    purify_min_pairs: int = 4,
    purify_num: int = 1, purify_den: int = 2,
) -> torch.Tensor:
    """Production entry for COMPACT row chunks (the dense fallback):
    unpacks rows_flat_layout on the buffer's device and runs
    phase_consensus_rows_packed."""
    seg = _sections(buf, rows_flat_layout(G, R, W))
    return phase_consensus_rows_packed(
        seg("rows").reshape(G, R, W // 2),
        _u8_to_i32(seg("qstart"), G, R),
        seg("rv").reshape(G, R) != 0,
        _u8_to_i32(seg("ltrue"), G), L=L, W=W,
        max_sites=max_sites, mec_iters=mec_iters,
        min_site_depth=min_site_depth, min_minor_count=min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
        purify_window=purify_window, purify_min_pairs=purify_min_pairs,
        purify_num=purify_num, purify_den=purify_den)


def phase_consensus_kwargs(phasing_cfg) -> dict:
    """Static kernel knobs from a PhasingConfig (rationalized thresholds)."""
    from focalsv_tpu_torch.phasing.phase import frac_parts
    lo_num, lo_den = frac_parts(phasing_cfg.min_allele_frac)
    hi_num, hi_den = frac_parts(phasing_cfg.max_allele_frac)
    return dict(
        max_sites=phasing_cfg.max_sites,
        mec_iters=phasing_cfg.mec_iters,
        min_site_depth=phasing_cfg.min_site_depth,
        min_minor_count=phasing_cfg.min_minor_count,
        lo_num=lo_num, lo_den=lo_den, hi_num=hi_num, hi_den=hi_den,
    )


# ---------------------------------------------------------------------------
# the entries sharded over a mesh
# ---------------------------------------------------------------------------


def _repack_per_device(buf, lay: dict, names: tuple, G: int, n: int
                       ) -> list[tuple]:
    """A G-major wire buffer as n self-contained buffers of G/n regions: a
    plain slice of the buffer is not a valid layout of G/n regions (every
    section is G-major), so each section is cut into per-device contiguous
    blocks and the blocks of a device are concatenated in section order."""
    if G % n:
        raise ValueError(f"G={G} does not split over {n} devices")
    buf = host_array(buf)
    Gd = G // n
    parts = []
    for d in range(n):
        segs = []
        for name in names:
            a, b = lay[name]
            per = (b - a) // G
            segs.append(buf[a + d * Gd * per : a + (d + 1) * Gd * per])
        parts.append((np.concatenate(segs),))
    return parts


def sharded_phase_consensus_delta_flat(buf, mesh, *, G, R, L, Ds, Dd, **kw):
    """phase_consensus_delta_flat sharded over the mesh: ``buf`` is the host
    wire buffer (G divisible by the mesh size), re-packed per device.  The
    (G, bytes) result is on its way into pinned host memory when the call
    returns (mesh.PendingResult)."""
    parts = _repack_per_device(
        buf, delta_flat_layout(G, R, L, Ds, Dd),
        ("ref", "starts", "ends", "rv", "sub_pos", "sub_read", "sub_sym",
         "del_read", "del_a", "del_b", "ltrue"), G, mesh.size)
    hosts, events = map_to_host(
        mesh, parts, lambda b: phase_consensus_delta_flat(
            b, G=G // mesh.size, R=R, L=L, Ds=Ds, Dd=Dd, **kw))
    return PendingResult(hosts[0], events)


def sharded_phase_consensus_rows_flat(buf, mesh, *, G, R, L, W, **kw):
    """phase_consensus_rows_flat sharded over the mesh (per-device re-pack,
    as sharded_phase_consensus_delta_flat)."""
    parts = _repack_per_device(buf, rows_flat_layout(G, R, W),
                               ("rows", "qstart", "rv", "ltrue"), G,
                               mesh.size)
    hosts, events = map_to_host(
        mesh, parts, lambda b: phase_consensus_rows_flat(
            b, G=G // mesh.size, R=R, L=L, W=W, **kw))
    return PendingResult(hosts[0], events)


def _sharded(mesh, args, fn):
    """``fn`` over equal shards of host arrays ``args``; the results, whole
    and in region order, as host tensors (waited for)."""
    hosts, events = map_to_host(mesh, split_batch(args, mesh.size), fn)
    for e in events:
        e.synchronize()
    return hosts


def sharded_phase_consensus_delta(args: tuple, mesh, *, L, **kw):
    """phase_consensus_delta sharded over the mesh's regions axis."""
    return _sharded(mesh, args,
                    lambda *a: phase_consensus_delta(*a, L=L, **kw))[0]


def sharded_phase_consensus_rows_packed(packed_rows, row_start, read_valid,
                                        mesh, *, L, W, **kw):
    """phase_consensus_rows_packed sharded over the mesh's regions axis."""
    return _sharded(
        mesh, (packed_rows, row_start, read_valid),
        lambda p, st, rv: phase_consensus_rows_packed(p, st, rv, L=L, W=W,
                                                      **kw))[0]


def sharded_phase_consensus(mat, read_valid, mesh, **kw):
    """phase_consensus_batch sharded over the mesh's regions axis."""
    return tuple(_sharded(mesh, (mat, read_valid),
                          lambda m, rv: phase_consensus_batch(m, rv, **kw)))


def sharded_phase_consensus_packed(packed, read_valid, mesh, *, L, **kw):
    """phase_consensus_batch_packed sharded over the mesh's regions axis."""
    return _sharded(
        mesh, (packed, read_valid),
        lambda p, rv: phase_consensus_batch_packed(p, rv, L=L, **kw))[0]
