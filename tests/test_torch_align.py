"""The port's banded DP (focalsv_tpu_torch/ops/align.py) against the JAX
package's: the plain PyTorch version of kernel B1 must give the scores and
direction bytes of the XLA scan and of the Pallas kernel (interpret mode),
byte for byte, on the same numpy inputs.  Tolerance 0: the DP is integer
arithmetic."""

import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl

import focalsv_tpu.ops.align_pallas as ap
from focalsv_tpu.ops import align as jalign
from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.ops import align_cuda

OLC_SCORING = dict(match=2, mismatch=-4, gap_open=-4, gap_extend=-2)
ALIGNER_SCORING = dict(match=2, mismatch=-8, gap_open=-24, gap_extend=-2)
UNIT_COSTS = dict(match=0, mismatch=-1, gap_open=-1, gap_extend=-1)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


@pytest.fixture()
def interpret_mode(monkeypatch):
    orig = pl.pallas_call

    def patched(*a, **k):
        k["interpret"] = True
        return orig(*a, **k)

    monkeypatch.setattr(ap.pl, "pallas_call", patched)


def _pairs(seed, B=4, L=120, W=64):
    """Mutated pairs: substitution runs, deletions and leading query
    insertions (the j == 0, F-only column)."""
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, L)).astype(np.uint8)
    q = t.copy()
    for b in range(B):
        i0 = int(rng.integers(10, 60))
        ln = int(rng.integers(1, 20))
        if b % 3 == 0:
            q[b, i0 : i0 + ln] = rng.integers(0, 4)
        elif b % 3 == 1:
            q[b] = np.concatenate([np.delete(q[b], slice(i0, i0 + ln)),
                                   np.full(ln, 5, np.uint8)])
        else:
            q[b] = np.concatenate([rng.integers(0, 4, ln).astype(np.uint8),
                                   q[b][: L - ln]])
    q_len = rng.integers(60, L - 20, B).astype(np.int32)
    t_len = rng.integers(80, L + 1, B).astype(np.int32)
    d_lo = np.clip(((t_len - q_len) // 2 - W // 2),
                   t_len - q_len - W + 1, 0).astype(np.int32)
    return q, q_len, t, t_len, d_lo


def _torch_args(*arrays):
    return [torch.from_numpy(np.ascontiguousarray(a)) for a in arrays]


def _port(args, **kw):
    s, d = talign.banded_align_batch(*_torch_args(*args), **kw)
    return s.numpy(), (None if d is None else d.numpy())


@pytest.mark.parametrize("scoring", [OLC_SCORING, ALIGNER_SCORING],
                         ids=["olc", "aligner"])
@pytest.mark.parametrize("seed", range(3))
def test_plain_matches_jax_scan(seed, scoring):
    args = _pairs(seed)
    s_j, d_j = jalign.banded_align_batch(*args, band=64, **scoring)
    s_t, d_t = _port(args, band=64, **scoring)
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    assert (s_t > talign.NEG).all()


@pytest.mark.parametrize("seed", range(2))
def test_plain_matches_pallas_interpret(interpret_mode, seed):
    args = _pairs(seed + 10)
    s_p, d_p = ap.banded_align_batch_pallas(*args, band=64)
    s_t, d_t = _port(args, band=64)
    np.testing.assert_array_equal(s_t, np.asarray(s_p))
    np.testing.assert_array_equal(d_t, np.asarray(d_p))


def test_leading_insertion_column():
    """A query that starts with an insertion walks the j == 0 column."""
    rng = np.random.default_rng(5)
    t = rng.integers(0, 4, 90).astype(np.uint8)
    q = np.concatenate([rng.integers(0, 4, 12).astype(np.uint8), t[:78]])
    args = (q[None], np.array([90], np.int32), t[None],
            np.array([78], np.int32), np.array([-40], np.int32))
    s_j, d_j = jalign.banded_align_batch(*args, band=64)
    s_t, d_t = _port(args, band=64)
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    np.testing.assert_array_equal(d_t, np.asarray(d_j))
    # the query's first rows sit on j == 0: H from F, F-extend after row 1
    k0 = 0 - 1 - (-40)
    assert d_t[0, 0, k0] & 0b11 == 2
    assert d_t[0, 1, k0 - 1] == (2 | talign.DIR_F_EXT)


def test_score_only_unit_costs():
    args = _pairs(21, B=3, L=200, W=128)
    s_j, d_j = jalign.banded_align_batch(*args, band=128, store_dirs=False,
                                         **UNIT_COSTS)
    s_t, d_t = _port(args, band=128, store_dirs=False, **UNIT_COSTS)
    assert d_j is None and d_t is None
    np.testing.assert_array_equal(s_t, np.asarray(s_j))


def test_off_band_endpoint_scores_neg():
    args = list(_pairs(3, B=2))
    args[4] = np.array([50, -200], np.int32)   # endpoint outside the band
    s_j, _ = jalign.banded_align_batch(*args, band=64)
    s_t, _ = _port(args, band=64)
    np.testing.assert_array_equal(s_t, np.asarray(s_j))
    assert (s_t == talign.NEG).all()


def test_dispatcher_runs_plain_version_on_cpu_tensors():
    args = _torch_args(*_pairs(4))
    before = align_cuda.launches
    s, d = talign.banded_align(*args, band=64)
    s_r, d_r = talign.banded_align_batch(*args, band=64)
    assert torch.equal(s, s_r) and torch.equal(d, d_r)
    assert align_cuda.launches == before


def test_kernel_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        align_cuda.banded_align_batch_cuda(*_torch_args(*_pairs(0)), band=64)


@pytest.mark.parametrize("seed", range(3))
def test_banded_align_pair_device_route(monkeypatch, seed):
    """Past the native size cap both packages take their device route: the
    port's plain version with the host traceback gives the same CIGAR."""
    rng = np.random.default_rng(100 + seed)
    t = rng.integers(0, 4, 300).astype(np.uint8)
    q = np.concatenate([t[:100], rng.integers(0, 4, 30).astype(np.uint8),
                        t[140:]])
    monkeypatch.setattr(jalign, "NATIVE_DP_MAX_CELLS", 0)
    monkeypatch.setattr(talign, "NATIVE_DP_MAX_CELLS", 0)
    for scoring in (OLC_SCORING, ALIGNER_SCORING):
        assert (talign.banded_align_pair(q, t, band=128, **scoring)
                == jalign.banded_align_pair(q, t, band=128, **scoring))


def test_banded_align_pair_native_route():
    rng = np.random.default_rng(7)
    t = rng.integers(0, 4, 500).astype(np.uint8)
    q = np.delete(t, slice(200, 240))
    assert (talign.banded_align_pair(q, t, band=128)
            == jalign.banded_align_pair(q, t, band=128))


def test_edit_similarity_score_only_route(monkeypatch):
    rng = np.random.default_rng(9)
    a = rng.integers(0, 4, 400).astype(np.uint8)
    b = np.concatenate([a[:150], a[190:], rng.integers(0, 4, 10)]
                       ).astype(np.uint8)
    native = talign.edit_similarity(a, b)
    assert native == jalign.edit_similarity(a, b)
    monkeypatch.setattr(jalign, "NATIVE_DP_MAX_CELLS", 0)
    monkeypatch.setattr(talign, "NATIVE_DP_MAX_CELLS", 0)
    assert talign.edit_similarity(a, b) == jalign.edit_similarity(a, b)


def test_no_cuda_device_raises(monkeypatch):
    """Without FOCALSV_TORCH_DEVICE=cpu the port asks for CUDA and, with
    no card, raises instead of carrying on on the CPU."""
    from focalsv_tpu_torch.device import resolve_device
    monkeypatch.delenv("FOCALSV_TORCH_DEVICE")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device()
    assert resolve_device("cpu").type == "cpu"
