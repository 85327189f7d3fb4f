"""Kernel B2 (csrc/region_step.cu) from the CPU: its plain version against
the JAX package's phase_consensus_delta_flat on every case of
testing/region_cases.py, numpy models of the reformulations the kernel
rests on held against the JAX functions, the routing of a CPU buffer, and
the wrapper's checks.  Tolerance 0: the step is integer arithmetic plus one
correctly rounded f32 division.  The kernel itself runs only on a card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import jax
import numpy as np
import pytest
import torch

from focalsv_tpu.parallel import region_step as jrs
from focalsv_tpu_torch.ops import region_cuda
from focalsv_tpu_torch.parallel import region_step as trs
from focalsv_tpu_torch.parallel.wire import delta_flat_layout, flat_layout_rle
from focalsv_tpu_torch.testing import region_cases

CASES = sorted(region_cases.CASES)
KNOBS = tuple(trs.STEP_DEFAULTS)


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


_JAX = {}


def _jax_flat(name):
    """The case and the JAX function's flat result (computed once)."""
    if name not in _JAX:
        buf, args = region_cases.build(name)
        _JAX[name] = buf, args, np.asarray(
            jrs.phase_consensus_delta_flat(buf, **args))
    return _JAX[name]


def _regions(buf, args):
    """Each region's inputs as numpy arrays, and the step's knobs."""
    G, R, L, Ds, Dd = (args[k] for k in ("G", "R", "L", "Ds", "Dd"))
    lay = delta_flat_layout(G, R, L, Ds, Dd)

    def sect(name, dt, *shape):
        a, b = lay[name]
        return buf[a:b].view(dt).reshape(*shape)

    ins = dict(ref=sect("ref", np.uint8, G, L),
               starts=sect("starts", np.int32, G, R),
               ends=sect("ends", np.int32, G, R),
               rv=sect("rv", np.uint8, G, R) != 0,
               sub_pos=sect("sub_pos", np.int32, G, Ds),
               sub_read=sect("sub_read", np.int32, G, Ds),
               sub_sym=sect("sub_sym", np.uint8, G, Ds),
               del_read=sect("del_read", np.int32, G, Dd),
               del_a=sect("del_a", np.int32, G, Dd),
               del_b=sect("del_b", np.int32, G, Dd),
               ltrue=sect("ltrue", np.int32, G))
    kw = {**trs.STEP_DEFAULTS, **{k: v for k, v in args.items()
                                   if k in KNOBS}}
    return [{k: v[g] for k, v in ins.items()} for g in range(G)], kw


_ONE_REGION = jax.jit(jrs._one_region_delta, static_argnames=KNOBS)


def _jax_region(r, kw):
    """One region through the JAX package's _one_region_delta."""
    out = _ONE_REGION(
        r["ref"], r["starts"], r["ends"], r["rv"], r["sub_pos"],
        r["sub_read"], r["sub_sym"], r["del_read"], r["del_a"], r["del_b"],
        r["ltrue"], **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("name", CASES)
def test_plain_matches_jax_on_case(name):
    buf, args, want = _jax_flat(name)
    got = trs.phase_consensus_delta_flat_plain(torch.from_numpy(buf), **args)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


# -- numpy models of the kernel's reformulations ---------------------------

def _tile_sweep_counts(r, L, T):
    """Column counts (L, 5) by the kernel's sweep: each tile of T columns
    rebuilt from the event lists into difference arrays, with the span and
    deletion counts carried from tile to tile."""
    counts = np.zeros((L, 5), np.int64)
    carry_c = carry_d = 0
    for t0 in range(0, L, T):
        dcov = np.zeros(T, np.int64)
        ddel = np.zeros(T, np.int64)
        dsub = np.zeros((5, T), np.int64)
        for ok, a, b, d in ((r["rv"], r["starts"], r["ends"], dcov),
                            (r["del_read"] >= 0, r["del_a"], r["del_b"],
                             ddel)):
            for x, w in ((a, 1), (b, -1)):
                q = x[ok] - t0
                np.add.at(d, q[(q >= 0) & (q < T)], w)
        ok = r["sub_read"] >= 0
        q = r["sub_pos"][ok] - t0
        s = np.minimum(r["sub_sym"][ok], 4)
        m = (q >= 0) & (q < T)
        np.add.at(dsub, (s[m], q[m]), 1)
        cov = carry_c + np.cumsum(dcov)
        dl = carry_d + np.cumsum(ddel)
        carry_c, carry_d = cov[-1], dl[-1]
        n = min(T, L - t0)
        base = cov[:n] - dl[:n] - dsub.sum(0)[:n]
        ref = r["ref"][t0:t0 + n]
        for k in range(4):
            counts[t0:t0 + n, k] = np.where(ref == k, base, 0) + dsub[k, :n]
        counts[t0:t0 + n, 4] = dl[:n]
    return counts


def _keyed_sites(counts, ltrue, kw):
    """The kernel's site search: each het column's 64-bit key (balance bits,
    ~column, a0, a1), the largest key of each strip, compacted in strip
    order.  Returns [(column, a0, a1)]."""
    S = kw["max_sites"]
    L = len(counts)
    col = np.arange(L)
    a0 = np.argmax(counts, 1)                 # the first maximum
    masked = counts.copy()
    masked[col, a0] = -1
    a1 = np.argmax(masked, 1)
    top1, n0 = masked[col, a1], counts[col, a0]
    depth = counts.sum(1)
    het = ((depth >= max(kw["min_site_depth"], 1))
           & (top1 * kw["lo_den"] >= depth * kw["lo_num"])
           & (top1 * kw["hi_den"] <= depth * kw["hi_num"])
           & (top1 >= kw["min_minor_count"]))
    bal = top1.astype(np.float32) / np.maximum(n0 + top1, 1).astype(
        np.float32)
    het &= bal > 0
    key = ((bal.view(np.uint32).astype(np.uint64) << np.uint64(32))
           | ((((1 << 26) - 1 - col) << 6) | (a0 << 3) | a1).astype(
               np.uint64))
    strip = max((int(ltrue) + S - 1) // S, 1)
    best = np.zeros(S, np.uint64)
    np.maximum.at(best, np.minimum(col // strip, S - 1)[het], key[het])
    lows = [int(k) & 0xFFFFFFFF for k in best if k]
    return [((1 << 26) - 1 - (lo >> 6), (lo >> 3) & 7, lo & 7) for lo in lows]


@pytest.mark.parametrize("name", ["hifi_blocks", "crowded_strips", "lengths",
                                  "bands", "bands_half", "zero_and_one_het"])
def test_tile_sweep_and_keyed_strips_match_jax(name):
    """Counts by tiles with carries, strips by the largest key: the selected
    columns and their alleles are the JAX function's (its site list holds
    the sites that passed purification, then those that failed, then 0)."""
    buf, args = region_cases.build(name)
    regions, kw = _regions(buf, args)
    code = (0, 1, 2, 3, 254)
    for r in regions:
        site_pos, _n, _A, _hp, _sym, _cov, sa0, sa1, *_ = _jax_region(r, kw)
        for T in (64, 1000):
            sites = _keyed_sites(_tile_sweep_counts(r, args["L"], T),
                                 r["ltrue"], kw)
            n = len(sites)
            got = sorted((c, code[a0], code[a1]) for c, a0, a1 in sites)
            want = sorted(zip(site_pos[:n].tolist(), sa0[:n].tolist(),
                              sa1[:n].tolist()))
            assert got == want
            assert (site_pos[n:] == 0).all()


def _mec_model(A, mec_iters):
    """The kernel's MEC on a (R, S) allele matrix: one signed agree count per
    (read, block), rounds until h stops changing.  Returns hp, read_block,
    site_h and the rounds run before h stood still (None if it never did)."""
    R, S = A.shape
    cov = A >= 0
    link = (cov[:, :-1] & cov[:, 1:]).any(0)
    blk = np.concatenate([[0], np.cumsum(~link)])
    both = cov[:, :-1] & cov[:, 1:]
    nb = both.sum(0)
    same = ((A[:, :-1] == A[:, 1:]) & both).sum(0)
    flip = (nb > 0) & (same < nb - same)
    H = np.concatenate([[0], np.cumsum(flip)])
    start = {b: int(np.argmax(blk == b)) for b in np.unique(blk)}
    h = np.array([(H[j] - H[start[blk[j]]]) % 2 for j in range(S)])
    sign = np.where(cov, 1, 0)

    def assign(h):
        agree = np.where(A == h[None, :], sign, -sign)
        per_block = np.zeros((R, blk[-1] + 1), np.int64)
        np.add.at(per_block.T, blk, agree.T)
        return per_block >= 0                  # (R, blocks)

    settled = None
    for it in range(mec_iters):
        as0 = assign(h)[:, blk]
        n = cov.sum(0)
        v1 = (cov & (A == as0.astype(A.dtype))).sum(0)
        new = (v1 > n - v1).astype(int)
        if (new == h).all():
            settled = it
            break
        h = new
    as0 = assign(h)
    has = cov.any(1)
    fs = np.argmax(cov, 1)
    hp = np.where(has, np.where(as0[np.arange(R), blk[fs]], 1, 2), 0)
    read_block = np.where(has, blk[fs], -1)
    v1 = ((A == 1) & (hp == 1)[:, None]).sum(0) + (
        (A == 0) & (hp == 2)[:, None]).sum(0)
    v0 = ((A == 0) & (hp == 1)[:, None]).sum(0) + (
        (A == 1) & (hp == 2)[:, None]).sum(0)
    return hp, read_block, (v1 > v0).astype(np.uint8), settled


def test_block_constant_mec_with_early_stop_matches_jax():
    """The kernel's MEC (a signed count per (read, block), stopped when a
    round leaves h as it was) gives the JAX function's hp, read_block and
    site_h; the cases hold MECs that settle in round 0 and in round 1, and
    one whose only round changes h (the loop ends on its count)."""
    settled = []
    for name in ("hifi_blocks", "lengths", "mec_settles_late",
                 "mec_one_round", "zero_and_one_het", "r1024_s512"):
        buf, args = region_cases.build(name)
        regions, kw = _regions(buf, args)
        for r in regions:
            _sp, _n, A, hp, _sym, _cov, _a0, _a1, site_h, _conn, rb = \
                _jax_region(r, kw)
            if not r["rv"].any():
                continue
            m_hp, m_rb, m_h, rounds = _mec_model(A, kw["mec_iters"])
            np.testing.assert_array_equal(m_hp, hp)
            np.testing.assert_array_equal(m_rb, rb)
            np.testing.assert_array_equal(m_h, site_h)
            settled.append((name, rounds))
    assert ("hifi_blocks", 0) in settled, settled
    assert ("mec_settles_late", 1) in settled, settled
    assert ("mec_one_round", None) in settled, settled


def _rle_model(sym, cov, ref, ltrue, Drle, T):
    """The kernel's RLE track: tiles of T columns, a running boundary count
    and deviating-column count carried across tiles; a run's length is the
    deviating columns between its start and the next start."""
    L = len(sym)
    starts, cd_at = [], []
    prev_st, prev_dv, ndev = 255, False, 0
    for t0 in range(0, L, T):
        for col in range(t0, min(t0 + T, L)):
            st = int(sym[col]) if cov[col] else 7
            dv = col < ltrue and not (cov[col] and sym[col] == ref[col])
            if dv and (not prev_dv or st != prev_st):
                starts.append((col, st))
                cd_at.append(ndev)
            ndev += dv
            prev_st, prev_dv = st, dv
    n_runs = len(starts)
    starts += [(L, prev_st)] * max(Drle + 1 - n_runs, 0)
    cd_at += [ndev] * max(Drle + 1 - len(cd_at), 0)
    return (n_runs, [s for s, _ in starts[:Drle]],
            [cd_at[i + 1] - cd_at[i] for i in range(Drle)],
            [v for _, v in starts[:Drle]])


@pytest.mark.parametrize("name", ["hifi_blocks", "hifi_overflow", "lengths",
                                  "l262144"])
def test_tile_sweep_runs_match_jax(name):
    """Runs found by a running boundary count give the JAX function's RLE
    bytes, an overflowing track, padded regions and a run that ends on the
    last column among them."""
    buf, args, flat = _jax_flat(name)
    regions, kw = _regions(buf, args)
    R, S, D = args["R"], kw["max_sites"], args["Drle"]
    lay = flat_layout_rle(R, S, D)

    def sect(g, key, dt, *shape):
        a, b = lay[key]
        return flat[g, a:b].view(dt).reshape(*shape)

    ended_on_last = False
    for g, r in enumerate(regions):
        _sp, _n, _A, _hp, sym, cov, *_ = _jax_region(r, kw)
        for k in range(2):
            for T in (64, 2048):
                n, st, ln, val = _rle_model(sym[k], cov[k], r["ref"],
                                            r["ltrue"], D, T)
                assert n == sect(g, "n_runs", np.int32, 2)[k]
                assert st == sect(g, "run_start", np.int32, 2, D)[k].tolist()
                assert ln == sect(g, "run_len", np.int32, 2, D)[k].tolist()
                assert val == sect(g, "run_val", np.uint8, 2, D)[k].tolist()
            if 0 < n <= D:
                ended_on_last |= st[n - 1] + ln[n - 1] == args["L"]
    if name == "l262144":
        assert ended_on_last


# -- routing and the wrapper's checks ---------------------------------------

def test_cpu_buffer_takes_the_plain_version(monkeypatch):
    buf, args = region_cases.build("zero_and_one_het")

    def no_kernel(*a, **k):
        raise AssertionError("a CPU buffer reached the kernel's wrapper")

    monkeypatch.setattr(region_cuda, "phase_consensus_delta_flat_cuda",
                        no_kernel)
    region_cuda.reset_launches()
    tbuf = torch.from_numpy(buf)
    got = trs.phase_consensus_delta_flat(tbuf, **args)
    assert region_cuda.launches == 0
    assert torch.equal(got, trs.phase_consensus_delta_flat_plain(tbuf,
                                                                 **args))


def test_wrapper_refuses_what_the_kernel_does_not_take():
    buf, args = region_cases.build("zero_and_one_het")
    kw = {**trs.STEP_DEFAULTS, **args}
    tbuf = torch.from_numpy(buf)
    with pytest.raises(ValueError, match="CUDA"):
        region_cuda.phase_consensus_delta_flat_cuda(tbuf, **kw)
    with pytest.raises(TypeError, match="uint8"):
        region_cuda.phase_consensus_delta_flat_cuda(tbuf.view(torch.int32),
                                                    **kw)
    with pytest.raises(ValueError, match="bytes"):
        region_cuda.phase_consensus_delta_flat_cuda(tbuf[:-4], **kw)
    with pytest.raises(ValueError, match="1-D"):
        region_cuda.phase_consensus_delta_flat_cuda(tbuf.reshape(2, -1),
                                                    **kw)
    with pytest.raises(ValueError, match="L % 8"):
        lay = delta_flat_layout(kw["G"], kw["R"], 4100, kw["Ds"], kw["Dd"])
        region_cuda.phase_consensus_delta_flat_cuda(
            torch.zeros(lay["__total__"][1], dtype=torch.uint8),
            **{**kw, "L": 4100, "Drle": 0})
    assert region_cuda.launches == 0
