"""Tests of the port that need the card: kernel B1 and the region step on
CUDA against their plain versions, byte for byte (tolerance 0).

They skip without a CUDA device.  This file imports no jax, so that it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.ops import align_cuda

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
def test_region_step_on_card_matches_cpu(cuda):
    from focalsv_tpu.config import preset
    from focalsv_tpu.testing import simulate as sim
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
