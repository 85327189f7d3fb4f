"""Tests of the port that need the card: kernels B1 (banded DP) and B4
(traceback) and the region step on CUDA against their plain versions, byte
for byte (tolerance 0).

They skip without a CUDA device.  This file imports no jax, so that it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.ops import align_cuda
from focalsv_tpu_torch.testing import dp_cases

OLC_SCORING = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
ALIGNER_SCORING = dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2)
UNIT_COSTS = dict(match=0, mismatch=-1, gap_open=-1, gap_extend=-1)


@pytest.fixture()
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _pairs(seed, B, L, W):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    q = t.copy()
    for b in range(B):
        i0 = int(rng.integers(10, L // 2))
        ln = int(rng.integers(1, 20))
        if b % 3 == 0:
            q[b, i0 : i0 + ln] = rng.integers(0, 4)
        elif b % 3 == 1:
            q[b] = np.concatenate([np.delete(q[b], slice(i0, i0 + ln)),
                                   np.full(ln, 5, np.uint8)])
        else:
            q[b] = np.concatenate([rng.integers(0, 4, ln).astype(np.uint8),
                                   q[b][: L - ln]])
    q_len = rng.integers(L // 2, L - 20, B).astype(np.int32)
    t_len = rng.integers(L // 2 + 20, L + 1, B).astype(np.int32)
    d_lo = np.clip(((t_len - q_len) // 2 - W // 2),
                   t_len - q_len - W + 1, 0).astype(np.int32)
    return q, q_len, t, t_len, d_lo


@pytest.mark.cuda
@pytest.mark.parametrize("W,scoring,store", [
    (64, OLC_SCORING, True), (128, ALIGNER_SCORING, True),
    (100, OLC_SCORING, True), (2048, UNIT_COSTS, False),
    (16384, UNIT_COSTS, False)])
def test_kernel_matches_plain_on_card(cuda, W, scoring, store):
    args = [torch.from_numpy(a).to(cuda) for a in _pairs(W, 6, 600, W)]
    before = align_cuda.launches
    s_k, d_k = talign.banded_align(*args, band=W, store_dirs=store,
                                   **scoring)
    s_p, d_p = talign.banded_align_batch(*args, band=W, store_dirs=store,
                                         **scoring)
    torch.cuda.synchronize()
    assert align_cuda.launches == before + 1
    assert torch.equal(s_k, s_p)
    assert (d_k is None) == (not store)
    if store:
        assert torch.equal(d_k, d_p)


@pytest.mark.cuda
@pytest.mark.parametrize("cells", [4, 8, 16])
@pytest.mark.parametrize("B", [1, 3, 300])
def test_kernel_configurations_match_plain_on_card(cuda, cells, B):
    """Every cells-per-thread setting, one warp and a warp group per pair
    (W 100 and 700), lone pairs and more pairs than the card has SMs."""
    for W in (100, 700):
        args = [torch.from_numpy(a).to(cuda) for a in _pairs(B, B, 400, W)]
        s_k, d_k = align_cuda.banded_align_batch_cuda(
            *args, band=W, cells_per_thread=cells, **OLC_SCORING)
        s_p, d_p = talign.banded_align_batch(*args, band=W, **OLC_SCORING)
        torch.cuda.synchronize()
        assert torch.equal(s_k, s_p) and torch.equal(d_k, d_p)


def _edge_pairs(W):
    """Pairs at the corners of the walk: along the band's lower and upper
    edge, an empty query, an empty target, both empty, leading insertions."""
    q, q_len, t, t_len, d_lo = _pairs(W + 1, 7, 500, W)
    t_len[0] = max(t_len[0], q_len[0])
    d_lo[0] = 0
    d_lo[1] = t_len[1] - q_len[1] - W + 1
    q_len[2] = 0
    t_len[3] = 0
    q_len[4] = t_len[4] = 0
    d_lo[5] = -W // 4
    return q, q_len, t, t_len, d_lo


@pytest.mark.cuda
@pytest.mark.parametrize("W", [64, 100, 128, 512])
def test_traceback_kernel_matches_plain_and_host(cuda, W):
    args = [torch.from_numpy(a).to(cuda) for a in _edge_pairs(W)]
    q, q_len, t, t_len, d_lo = args
    scores, dirs = talign.banded_align(*args, band=W, **OLC_SCORING)
    before = align_cuda.traceback_launches
    ops_k, n_k = talign.traceback_ops(dirs, q_len, t_len, d_lo, band=W,
                                      max_rows=q.shape[1])
    ops_p, n_p = talign.traceback_device(dirs, q_len, t_len, d_lo, band=W,
                                         max_rows=q.shape[1])
    torch.cuda.synchronize()
    assert align_cuda.traceback_launches == before + 1
    assert torch.equal(ops_k, ops_p) and torch.equal(n_k, n_p)
    for b in range(q.shape[0]):
        if int(scores[b]) <= talign.NEG // 2:
            continue                   # off the band: no alignment to walk
        host = talign.traceback(dirs[b].cpu().numpy(), int(q_len[b]),
                                int(t_len[b]), int(d_lo[b]))
        assert talign.ops_to_cigar(ops_k[b].cpu().numpy(),
                                   int(n_k[b])) == host


WALK_CASES = {c[0]: c[1:] for c in dp_cases.walk_cases(with_stop=True)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_traceback_kernel_matches_plain_on_crafted_walks(cuda, name):
    """Gap runs longer than 32 ops, than a tile's 64 rows and 128 columns,
    runs ending on the band's edge, a full op string, a band that is no
    multiple of 16, random bytes."""
    dirs, q_len, t_len, d_lo, W, M = WALK_CASES[name]
    args = [torch.from_numpy(a).to(cuda) for a in (dirs, q_len, t_len, d_lo)]
    ops_k, n_k = talign.traceback_ops(*args, band=W, max_rows=M)
    ops_p, n_p = talign.traceback_device(*args, band=W, max_rows=M)
    torch.cuda.synchronize()
    assert torch.equal(ops_k, ops_p) and torch.equal(n_k, n_p)


@pytest.mark.cuda
def test_traceback_kernel_matches_plain_on_noisy_walk(cuda):
    rng = np.random.default_rng(3)
    args = [torch.from_numpy(a).to(cuda)
            for a in dp_cases.noisy_pairs(rng, 6, 2048, 256, 1200)]
    q, q_len, t, t_len, d_lo = args
    scores, dirs = talign.banded_align(*args, band=256, **OLC_SCORING)
    ops_k, n_k = talign.traceback_ops(dirs, q_len, t_len, d_lo, band=256,
                                      max_rows=2048)
    ops_p, n_p = talign.traceback_device(dirs, q_len, t_len, d_lo, band=256,
                                         max_rows=2048)
    torch.cuda.synchronize()
    assert (scores > 0).all()
    assert torch.equal(ops_k, ops_p) and torch.equal(n_k, n_p)
    for b in range(6):
        host = talign.traceback(dirs[b].cpu().numpy(), int(q_len[b]),
                                int(t_len[b]), int(d_lo[b]))
        assert talign.ops_to_cigar(ops_k[b].cpu().numpy(),
                                   int(n_k[b])) == host


@pytest.mark.cuda
def test_pairhmm_on_card_matches_cpu(cuda):
    """The pair-HMM's tensor code on the card against the CPU: float32 sums
    of a few terms in the same order, 1e-3 absolute."""
    from focalsv_tpu_torch.ops import pairhmm
    rng = np.random.default_rng(0)
    B, L = 2000, 29
    haps = rng.integers(0, 4, (B, L)).astype(np.uint8)
    reads = np.full((B, L), 5, np.uint8)
    reads[:, :21] = haps[:, 4:25]
    flip = rng.random((B, 21)) < 0.05
    reads[:, :21][flip] = (reads[:, :21][flip] + 1) % 4
    rl = np.full(B, 21, np.int32)
    hl = np.full(B, L, np.int32)
    kw = dict(max_read=L, max_hap=L)
    on_card = pairhmm.pairhmm_forward_batch(reads, rl, haps, hl, device=cuda,
                                            **kw)
    on_cpu = pairhmm.pairhmm_forward_batch(reads, rl, haps, hl, device="cpu",
                                           **kw)
    assert np.isfinite(on_cpu).all()
    np.testing.assert_allclose(on_card, on_cpu, rtol=0, atol=1e-3)


@pytest.mark.cuda
def test_banded_align_pair_on_card_matches_native(cuda, monkeypatch):
    """Past the native size cap the pair call runs B1 and B4 on the card;
    its (score, cigar) equal the native host DP's."""
    rng = np.random.default_rng(3)
    t = rng.integers(0, 4, 900).astype(np.uint8)
    q = np.concatenate([t[:300], rng.integers(0, 4, 25).astype(np.uint8),
                        t[340:]])
    want = talign.banded_align_pair(q, t, band=128)
    monkeypatch.setattr(talign, "NATIVE_DP_MAX_CELLS", 0)
    before = (align_cuda.launches, align_cuda.traceback_launches)
    assert talign.banded_align_pair(q, t, band=128) == want
    assert (align_cuda.launches, align_cuda.traceback_launches) == (
        before[0] + 1, before[1] + 1)


@pytest.mark.cuda
def test_region_step_on_card_matches_cpu(cuda):
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.testing import simulate as sim
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg = preset("HIFI")
    rgs = [sim.simulate_region(seed=s, ref_len=9000, coverage=20, n_snps=10,
                               read_len_mean=4000) for s in (1, 2)]
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg) for rg in rgs]
    k0, k1 = (dx._bucket_key(t, cfg) for t in tiles)
    key = (k0[0],) + tuple(max(a, b) for a, b in zip(k0[1:], k1[1:]))
    buf = dx.pack_chunk(tiles + [None], [0, 1, 2], key, 3)
    on_card = np.asarray(dx.dispatch_packed(buf, key, 3, cfg, cuda))
    on_cpu = np.asarray(dx.dispatch_packed(buf, key, 3, cfg,
                                           torch.device("cpu")))
    np.testing.assert_array_equal(on_card, on_cpu)
