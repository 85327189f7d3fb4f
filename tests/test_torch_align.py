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
from focalsv_tpu_torch.testing import dp_cases

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


# -- the traceback on the device (kernel B4's plain version) ----------------

def _traceback_case(kind: str, seed: int, B=4, L=150, W=64):
    """Pairs whose walks exercise one corner each."""
    q, q_len, t, t_len, d_lo = _pairs(seed, B=B, L=L, W=W)
    if kind == "band_edge":          # the path runs along the band's edge
        d_lo = np.zeros(B, np.int32)
        t_len = np.maximum(t_len, q_len).astype(np.int32)
    elif kind == "band_edge_high":
        d_lo = (t_len - q_len - W + 1).astype(np.int32)
    elif kind == "leading_gap":      # the j == 0 column: leading insertions
        q = np.concatenate([np.full((B, 12), 1, np.uint8), q[:, : L - 12]], 1)
        d_lo = np.full(B, -40, np.int32)
    elif kind == "trailing_gap":     # the target runs on past the query
        q_len = (q_len - 30).astype(np.int32)
        d_lo = np.clip((t_len - q_len) // 2 - W // 2, t_len - q_len - W + 1,
                       0).astype(np.int32)
    elif kind == "empty":
        q_len[0], t_len[1] = 0, 0
        q_len[2], t_len[2] = 0, 0
    elif kind == "off_band":         # endpoint outside the band
        d_lo = np.array([50, -200, 0, 7][:B], np.int32)
    return q, q_len, t, t_len, d_lo


TRACEBACK_KINDS = ["mixed", "band_edge", "band_edge_high", "leading_gap",
                   "trailing_gap", "empty", "off_band"]


@pytest.mark.parametrize("scoring", [OLC_SCORING, ALIGNER_SCORING],
                         ids=["olc", "aligner"])
@pytest.mark.parametrize("kind", TRACEBACK_KINDS)
def test_traceback_device_matches_jax_and_host(kind, scoring):
    """Ops and n equal the JAX traceback_device byte for byte (tolerance
    0), and the CIGAR equals the host traceback's wherever the pair scored
    (in both packages the two walks part on a pair whose endpoint is off the
    band: its score is NEG and its direction bytes hold no alignment)."""
    W, L = 64, 150
    for seed in range(2):
        args = _traceback_case(kind, 40 + seed, L=L, W=W)
        q, q_len, t, t_len, d_lo = args
        _, d_j = jalign.banded_align_batch(*args, band=W, **scoring)
        ops_j, n_j = jalign.traceback_device(d_j, q_len, t_len, d_lo,
                                             band=W, max_rows=L)
        ta = _torch_args(*args)
        s_t, d_t = talign.banded_align_batch(*ta, band=W, **scoring)
        ops_t, n_t = talign.traceback_device(d_t, ta[1], ta[3], ta[4],
                                             band=W, max_rows=L)
        assert ops_t.dtype == torch.uint8 and n_t.dtype == torch.int32
        assert ops_t.shape == (len(q), 2 * L + W + 8)
        np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))
        np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
        scored = [b for b in range(len(q)) if int(s_t[b]) > talign.NEG // 2]
        assert scored or kind == "off_band"
        for b in scored:
            host = talign.traceback(d_t[b].numpy(), int(q_len[b]),
                                    int(t_len[b]), int(d_lo[b]))
            assert talign.ops_to_cigar(ops_t[b].numpy(), int(n_t[b])) == host
            assert sum(l for _, l in host) == int(n_t[b])


WALK_CASES = {c[0]: c[1:] for c in dp_cases.walk_cases()}


@pytest.mark.parametrize("name", sorted(WALK_CASES))
def test_traceback_device_matches_jax_on_crafted_walks(name):
    """Direction bytes crafted so that the walk has gap runs longer than 32
    ops, than 64 rows and than 128 columns, runs that end on the band's
    edge, a full op string, and random bytes: the plain version equals the
    JAX traceback_device byte for byte (tolerance 0)."""
    dirs, q_len, t_len, d_lo, W, M = WALK_CASES[name]
    ops_j, n_j = jalign.traceback_device(dirs, q_len, t_len, d_lo, band=W,
                                         max_rows=M)
    ops_t, n_t = talign.traceback_device(*_torch_args(dirs, q_len, t_len,
                                                      d_lo), band=W,
                                         max_rows=M)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))


def _runs(ops, n):
    return talign.ops_to_cigar(ops.numpy(), int(n))


def test_crafted_walks_hold_what_they_claim():
    """The long-gap cases really walk runs past 32 ops, 64 rows and 128
    columns, end runs on the band's edge and fill the op string."""
    CDEL, CINS = talign.bamio.CDEL, talign.bamio.CINS

    def walk(name):
        dirs, q_len, t_len, d_lo, W, M = WALK_CASES[name]
        ops, n = talign.traceback_device(*_torch_args(dirs, q_len, t_len,
                                                      d_lo), band=W,
                                         max_rows=M)
        return [_runs(ops[b], n[b]) for b in range(len(dirs))], n, W, M

    runs, _, _, _ = walk("long_e_runs")
    assert (CDEL, 200) in runs[0]
    assert {(CDEL, 33), (CDEL, 32), (CDEL, 31)} <= set(runs[1])
    runs, _, _, _ = walk("long_f_runs")
    assert (CINS, 150) in runs[0]
    assert {(CINS, 33), (CINS, 32), (CINS, 80)} <= set(runs[1])
    runs, _, _, _ = walk("band_edge_runs")
    assert (CDEL, 30) in runs[0] and (CINS, 23) in runs[2]
    # a run that leaves the band is cut there and the walk goes on diagonal
    assert (CDEL, 22) in runs[1] and (CINS, 35) in runs[3]
    _, n, W, M = walk("full_op_string")
    assert int(n[0]) == int(n[1]) == 2 * M + W + 8


def test_noisy_pairs_walk_short_runs():
    """The CLR-like pairs of testing/dp_cases.py: the plain DP and walk
    equal the JAX package's, and the walk changes state every few ops."""
    rng = np.random.default_rng(3)
    args = dp_cases.noisy_pairs(rng, 2, 1024, 128, 600)
    s_j, d_j = jalign.banded_align_batch(*args, band=128, **OLC_SCORING)
    ta = _torch_args(*args)
    s_t, d_t = talign.banded_align_batch(*ta, band=128, **OLC_SCORING)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    assert (s_t > 0).all()
    ops_j, n_j = jalign.traceback_device(d_j, args[1], args[3], args[4],
                                         band=128, max_rows=1024)
    ops_t, n_t = talign.traceback_device(d_t, ta[1], ta[3], ta[4], band=128,
                                         max_rows=1024)
    np.testing.assert_array_equal(ops_t.numpy(), np.asarray(ops_j))
    np.testing.assert_array_equal(n_t.numpy(), np.asarray(n_j))
    for b in range(2):
        runs = _runs(ops_t[b], n_t[b])
        assert int(n_t[b]) / len(runs) < 10


@pytest.mark.parametrize("seed", range(3))
def test_ops_to_cigar_matches_reference(seed):
    rng = np.random.default_rng(seed)
    runs = rng.integers(1, 9, 40)
    codes = np.concatenate([np.full(r, rng.integers(0, 3), np.uint8)
                            for r in runs])
    ops = np.concatenate([codes, np.full(11, 255, np.uint8)])
    for n in (0, 1, len(codes) // 2, len(codes)):
        assert talign.ops_to_cigar(ops, n) == jalign.ops_to_cigar(ops, n)


def test_traceback_dispatcher_runs_plain_version_on_cpu_tensors():
    args = _torch_args(*_pairs(6))
    _, dirs = talign.banded_align_batch(*args, band=64)
    before = align_cuda.traceback_launches
    ops, n = talign.traceback_ops(dirs, args[1], args[3], args[4], band=64,
                                  max_rows=dirs.shape[1])
    ops_r, n_r = talign.traceback_device(dirs, args[1], args[3], args[4],
                                         band=64, max_rows=dirs.shape[1])
    assert torch.equal(ops, ops_r) and torch.equal(n, n_r)
    assert align_cuda.traceback_launches == before


def test_traceback_wrapper_refuses_cpu_tensors():
    args = _torch_args(*_pairs(0))
    _, dirs = talign.banded_align_batch(*args, band=64)
    with pytest.raises(ValueError, match="CUDA"):
        align_cuda.traceback_cuda(dirs, args[1], args[3], args[4], 64,
                                  dirs.shape[1])


@pytest.mark.parametrize("scoring", [OLC_SCORING, ALIGNER_SCORING],
                         ids=["olc", "aligner"])
def test_batcher_on_cpu_device_returns_the_host_cigar(scoring):
    """Through the DP batcher on a CPU device a job gets its op string from
    the plain traceback; (score, cigar) equal the JAX package's pair call
    and the host traceback of the same dirs."""
    from focalsv_tpu_torch.parallel import batch_executor as tbe
    rng = np.random.default_rng(17)
    t = rng.integers(0, 4, 260).astype(np.uint8)
    pairs = [(np.delete(t, slice(100, 100 + g)), t) for g in (5, 17)]
    pairs.append((np.concatenate([rng.integers(0, 4, 9).astype(np.uint8),
                                  t[:200]]), t[:215]))
    want = [jalign.banded_align_pair(q, tt, band=128, **scoring)
            for q, tt in pairs]
    with tbe.dp_batching(init_rt_ms=0.0, max_wait_ms=20.0,
                         device="cpu") as batcher:
        got = [talign.banded_align_pair(q, tt, band=128, **scoring)
               for q, tt in pairs]
    assert got == want
    assert batcher.n_jobs == len(pairs)
    # per job: the score, the op string and its length, not Lq * band dirs
    lq = talign._pad_bucket(pairs[0][0]).shape[0]
    assert batcher.d2h_bytes == len(pairs) * (4 + (2 * lq + 128 + 8) + 4)
