"""Kernels B2 and B3 (csrc/region_step.cu) from the CPU: their plain
versions against the JAX package's phase_consensus_delta_flat and
phase_consensus_rows_flat on every case of testing/region_cases.py, numpy
models of the reformulations B2 rests on held against the JAX functions, the
routing of a CPU buffer, the wrappers' checks, and the kernels' own source
built for the CPU (testing/host_kernel.py) against the plain versions.
Tolerance 0: the step is integer arithmetic plus one correctly rounded f32
division.  On a card: tests/test_torch_cuda.py, chip_smoke.py."""

import jax
import numpy as np
import pytest
import torch

from focalsv_tpu.parallel import region_step as jrs
from focalsv_tpu_torch.ops import region_cuda
from focalsv_tpu_torch.parallel import region_step as trs
from focalsv_tpu_torch.parallel.wire import (delta_flat_layout,
                                             flat_layout_rle,
                                             rows_flat_layout)
from focalsv_tpu_torch.testing import region_cases

CASES = sorted(region_cases.CASES)
ROWS_CASES = sorted(region_cases.ROWS_CASES)
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


def _strip_keys(counts, ltrue, kw, lo=0, hi=None):
    """The kernel's site search over columns [lo, hi): each het column's
    64-bit key (balance bits, ~column, a0, a1), the largest key of each
    strip (0 where none)."""
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
    het &= (bal > 0) & (col >= lo) & (col < (L if hi is None else hi))
    key = ((bal.view(np.uint32).astype(np.uint64) << np.uint64(32))
           | ((((1 << 26) - 1 - col) << 6) | (a0 << 3) | a1).astype(
               np.uint64))
    strip = max((int(ltrue) + S - 1) // S, 1)
    best = np.zeros(S, np.uint64)
    np.maximum.at(best, np.minimum(col // strip, S - 1)[het], key[het])
    return best


def _sites_of(best):
    """[(column, a0, a1)] of the strips' keys, in strip order."""
    lows = [int(k) & 0xFFFFFFFF for k in best if k]
    return [((1 << 26) - 1 - (lo >> 6), (lo >> 3) & 7, lo & 7) for lo in lows]


def _keyed_sites(counts, ltrue, kw):
    """The kernel's site search: each het column's 64-bit key (balance bits,
    ~column, a0, a1), the largest key of each strip, compacted in strip
    order.  Returns [(column, a0, a1)]."""
    return _sites_of(_strip_keys(counts, ltrue, kw))


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


# -- numpy models of the redesigned kernel: events binned by tile, column
# ranges of a cluster, both votes from one packed sweep ---------------------

MODEL_CASES = ["hifi_blocks", "hifi_overflow", "lengths", "range_edges",
               "ltrue_in_last_range", "del_spans_range"]


def _events(r, L):
    """The kernel's events of a region: (column, kind, read), kinds 0/1 a
    valid read's span start/end, 2/3 a deletion run's start/end, 4 + s a
    substitution of symbol s; those outside [0, L) dropped."""
    rv = r["rv"]
    reads = np.arange(len(rv))
    wd, ws = r["del_read"] >= 0, r["sub_read"] >= 0
    cols = [r["starts"][rv], r["ends"][rv], r["del_a"][wd], r["del_b"][wd],
            r["sub_pos"][ws]]
    kinds = [np.zeros(rv.sum(), int), np.ones(rv.sum(), int),
             np.full(wd.sum(), 2), np.full(wd.sum(), 3),
             4 + np.minimum(r["sub_sym"][ws], 4)]
    who = [reads[rv], reads[rv], r["del_read"][wd], r["del_read"][wd],
           r["sub_read"][ws]]
    col, kind, read = (np.concatenate(x).astype(np.int64)
                       for x in (cols, kinds, who))
    keep = (col >= 0) & (col < L)
    return col[keep], kind[keep], read[keep]


def _bin(col, T, rng):
    """A counting sort of the events by tile (histogram, scan, scatter),
    each bucket in an arbitrary order, as the kernel's atomics leave it.
    Returns the tile offsets and the events' order."""
    tile = col // T
    n_tiles = int(tile.max(initial=-1)) + 1
    off = np.concatenate([[0], np.cumsum(np.bincount(tile,
                                                     minlength=n_tiles))])
    order = np.empty(len(col), np.int64)
    cur = off[:-1].copy()
    for e in rng.permutation(len(col)):
        order[cur[tile[e]]] = e
        cur[tile[e]] += 1
    return off, order


def _signed(kind, w):
    return np.where((kind == 1) | (kind == 3), -w, w)


def _tile_dif(col, kind, w, t0, T):
    """A tile's difference arrays (span, deletion, 5 substitution rows)
    from its events, int32 as the kernel's."""
    dif = np.zeros((7, T), np.int32)
    row = np.where(kind < 2, 0, np.where(kind < 4, 1, kind - 2))
    np.add.at(dif, (row, col - t0), _signed(kind, w).astype(np.int32))
    return dif


def _counts_from_bins(r, L, T, weight, rng, tiles=None):
    """Column counts (L, 7): span and deletion counts and the 5
    substitution counts, each tile rebuilt from its bucket alone, its carry
    the sum of the tile sums before it, the tiles taken in the order given
    (all, in reverse, by default).  weight(kind, read) weights an event."""
    col, kind, read = _events(r, L)
    w = weight(kind, read)
    off, order = _bin(col, T, rng)
    n_tiles = len(off) - 1
    sums = np.zeros((n_tiles + 1, 2), np.int64)
    for t in range(n_tiles):
        e = order[off[t]:off[t + 1]]
        s = _signed(kind[e], w[e])
        sums[t + 1] = (s[kind[e] < 2].sum(), s[(kind[e] >= 2)
                                                & (kind[e] < 4)].sum())
    carry = np.cumsum(sums, 0).astype(np.int32)
    out = np.zeros((L, 7), np.int32)
    for t in (reversed(range(n_tiles)) if tiles is None else tiles):
        e = order[off[t]:off[t + 1]]
        dif = _tile_dif(col[e], kind[e], w[e], t * T, T)
        n = min(T, L - t * T)
        out[t * T:t * T + n, :2] = (np.cumsum(dif[:2], 1, dtype=np.int32)
                                    + carry[t][:, None])[:, :n].T
        out[t * T:t * T + n, 2:] = dif[2:, :n].T
    return out


def _site_counts(c):
    """(L, 5) allele counts {A, C, G, T, DEL} from the (L, 7) columns."""
    sub = c[:, 2:].astype(np.int64)
    base = c[:, 0] - c[:, 1] - sub.sum(1)
    return base, sub


@pytest.mark.parametrize("T", [64, 1000, 4096])
def test_events_binned_by_tile_match_jax(T):
    """Each tile rebuilt from its own bucket of a counting sort, its carry
    taken from the sums of the tiles before it, the tiles in reverse: the
    sites and their alleles are the JAX function's."""
    rng = np.random.default_rng(T)
    code = (0, 1, 2, 3, 254)
    for name in MODEL_CASES:
        buf, args = region_cases.build(name)
        regions, kw = _regions(buf, args)
        for r in regions:
            site_pos, *_rest = _jax_region(r, kw)
            sa0, sa1 = _rest[5], _rest[6]
            c = _counts_from_bins(r, args["L"], T,
                                  lambda k, rd: np.ones(len(k), np.int64),
                                  rng)
            base, sub = _site_counts(c)
            counts = np.zeros((args["L"], 5), np.int64)
            for s in range(4):
                counts[:, s] = np.where(r["ref"] == s, base, 0) + sub[:, s]
            counts[:, 4] = c[:, 1]
            sites = _keyed_sites(counts, r["ltrue"], kw)
            n = len(sites)
            got = sorted((col, code[a0], code[a1]) for col, a0, a1 in sites)
            want = sorted(zip(site_pos[:n].tolist(), sa0[:n].tolist(),
                              sa1[:n].tolist()))
            assert got == want, name
            assert (site_pos[n:] == 0).all()


def _class_weight(hp, rv):
    """The vote's packed weight of each read: hp 0 votes in both tracks (1 +
    65536), hp 1 in the first (1), hp 2 in the second (65536), a read that
    is not valid in none."""
    cls = np.where(rv, np.where(hp == 0, 3, hp), 0).astype(np.int64)
    w = (cls & 1) + ((cls & 2) << 15)

    def weight(kind, read):
        return np.where(read < len(hp), w[np.minimum(read, len(hp) - 1)], 0)
    return weight


def _unpack(x):
    """The two 16-bit halves of packed int32 counts."""
    x = x.astype(np.int64)
    lo = ((x & 0xFFFF) ^ 0x8000) - 0x8000
    return lo, (x - lo) >> 16


def _states(c, ref, ltrue, L):
    """Both tracks' (symbol, covered, state, deviates) from the (L, 7)
    packed columns, as the kernel votes them."""
    out = []
    cols = np.arange(L)
    for half in (0, 1):
        v = np.stack([_unpack(c[:, i])[half] for i in range(7)], 1)
        base = v[:, 0] - v[:, 1] - v[:, 2:].sum(1)
        cnt = np.zeros((L, 6), np.int64)
        for s in range(5):
            cnt[:, s] = np.where(ref == s, base, 0) + v[:, 2 + s]
        cnt[:, 5] = v[:, 1]
        sym = np.argmax(cnt, 1)
        covered = cnt.sum(1) > 0
        state = np.where(covered, sym, 7)
        dv = (cols < ltrue) & ~(covered & (sym == ref))
        out.append((sym, covered, state, dv))
    return out


def test_both_votes_from_one_packed_sweep_match_jax():
    """One sweep of packed difference arrays (hp 0 weighted 65537, hp 1
    1, hp 2 65536) gives both tracks' symbols and coverage, the JAX
    function's, with the tiles of 4096 columns in reverse."""
    rng = np.random.default_rng(0)
    for name in MODEL_CASES + ["hifi_dense"]:
        buf, args = region_cases.build(name)
        regions, kw = _regions(buf, args)
        for r in regions:
            _sp, _n, _A, hp, sym, cov, *_ = _jax_region(r, kw)
            c = _counts_from_bins(r, args["L"], 4096,
                                  _class_weight(hp, r["rv"]), rng)
            for k, (s, covered, _st, _dv) in enumerate(
                    _states(c, r["ref"], r["ltrue"], args["L"])):
                np.testing.assert_array_equal(s, sym[k])
                np.testing.assert_array_equal(covered, cov[k])


def _range_runs(state, dv, lo, hi, before, D):
    """One CTA's runs over [lo, hi): a run starts at a deviating column
    after one that does not deviate or holds another state (`before`: the
    column before lo as (state, deviates)).  Returns its first D + 1 runs as
    (start, state, deviating columns of the range before it) and the
    range's boundary and deviating-column counts."""
    runs, nb, nd = [], 0, 0
    ps, pd = before
    for col in range(lo, hi):
        if dv[col] and (not pd or state[col] != ps):
            if nb <= D:
                runs.append((col, int(state[col]), nd))
            nb += 1
        nd += int(dv[col])
        ps, pd = int(state[col]), bool(dv[col])
    return runs, nb, nd


def _column_before(r, lo, L, weight):
    """Both tracks' (state, deviates) at column lo - 1, from the events
    before lo alone: the span and deletion carries and the substitutions at
    lo - 1 (what a CTA whose range starts at lo computes itself)."""
    col, kind, read = _events(r, L)
    w = _signed(kind, weight(kind, read))
    before = col < lo
    c = np.zeros((1, 7), np.int64)
    c[0, 0] = w[before & (kind < 2)].sum()
    c[0, 1] = w[before & (kind >= 2) & (kind < 4)].sum()
    for s in range(5):
        c[0, 2 + s] = w[(col == lo - 1) & (kind == 4 + s)].sum()
    c = c.astype(np.int32)
    return [(int(st[0]), bool(dv[0])) for _s, _c, st, dv in
            _states(c, r["ref"][lo - 1:lo], r["ltrue"] - (lo - 1), 1)]


@pytest.mark.parametrize("n_ranges", [2, 4])
def test_column_ranges_merge_keys_and_offset_runs(n_ranges):
    """Columns split into 2 and 4 ranges of whole tiles of 4096, each swept
    from the carries of the events before it: the strips' keys of the
    ranges merged by their maximum give the JAX function's sites, and each
    range's runs, started from the state of the column before it (from its
    own events) and offset by the boundary and deviating-column counts of
    the ranges before it, give the JAX function's RLE tracks byte for
    byte."""
    rng = np.random.default_rng(n_ranges)
    code = (0, 1, 2, 3, 254)
    split = 0
    for name in MODEL_CASES:
        buf, args, flat = _jax_flat(name)
        regions, kw = _regions(buf, args)
        L, D, T = args["L"], args["Drle"], 4096
        lay = flat_layout_rle(args["R"], kw["max_sites"], D)
        n_tiles = -(-L // T)
        bounds = [min(k * n_tiles // n_ranges * T, L)
                  for k in range(n_ranges + 1)]
        split += len(set(bounds)) - 1 == n_ranges

        def sect(g, key, dt, *shape):
            a, b = lay[key]
            return flat[g, a:b].view(dt).reshape(*shape)

        for g, r in enumerate(regions):
            site_pos, _n, _A, hp, _sym, _cov, sa0, sa1, *_ = _jax_region(r,
                                                                         kw)
            ones = lambda k, rd: np.ones(len(k), np.int64)  # noqa: E731
            c = _counts_from_bins(r, L, T, ones, rng)
            base, sub = _site_counts(c)
            counts = np.zeros((L, 5), np.int64)
            for s in range(4):
                counts[:, s] = np.where(r["ref"] == s, base, 0) + sub[:, s]
            counts[:, 4] = c[:, 1]
            best = np.zeros(kw["max_sites"], np.uint64)
            for lo, hi in zip(bounds, bounds[1:]):
                best = np.maximum(best, _strip_keys(counts, r["ltrue"], kw,
                                                    lo, hi))
            sites = _sites_of(best)
            n = len(sites)
            assert [(col, code[a0], code[a1]) for col, a0, a1 in sites] == \
                sorted(zip(site_pos[:n].tolist(), sa0[:n].tolist(),
                           sa1[:n].tolist()))
            weight = _class_weight(hp, r["rv"])
            states = _states(_counts_from_bins(r, L, T, weight, rng),
                             r["ref"], r["ltrue"], L)
            for k, (_s, _c, state, dv) in enumerate(states):
                runs, n_runs, total = {}, 0, 0
                for lo, hi in zip(bounds, bounds[1:]):
                    before = (_column_before(r, lo, L, weight)[k] if lo
                              else (255, False))
                    rr, nb, nd = _range_runs(state, dv, lo, hi, before, D)
                    for i, (s0, st, ed) in enumerate(rr):
                        if n_runs + i <= D:
                            runs[n_runs + i] = (s0, st, total + ed)
                    n_runs += nb
                    total += nd
                cd = [runs[b][2] if b in runs else total
                      for b in range(D + 1)]
                assert n_runs == sect(g, "n_runs", np.int32, 2)[k], name
                assert [runs[b][0] if b in runs else L for b in range(D)] \
                    == sect(g, "run_start", np.int32, 2, D)[k].tolist()
                assert [cd[b + 1] - cd[b] for b in range(D)] == \
                    sect(g, "run_len", np.int32, 2, D)[k].tolist()
                assert [runs[b][1] if b in runs else int(state[L - 1])
                        for b in range(D)] == \
                    sect(g, "run_val", np.uint8, 2, D)[k].tolist()
    assert split >= 4          # most cases have n_ranges ranges


# -- the kernel's own source, built for the CPU (testing/host_kernel.py) ----

@pytest.mark.parametrize("name,cluster", [
    ("zero_and_one_het", 0), ("mec_one_round", 1), ("bands_half", 1),
    ("hifi_blocks", 1), ("hifi_blocks", 2), ("hifi_dense", 0),
    ("hifi_overflow", 4), ("range_edges", 2), ("range_edges", 4),
    ("ltrue_in_last_range", 4), ("del_spans_range", 2), ("r1024_s1024", 1),
])
def test_kernel_source_on_the_cpu_matches_plain(name, cluster):
    """csrc/region_step.cu compiled by g++ against the CPU stand-in for the
    CUDA runtime, with 1, 2 or 4 CTAs a region: the bytes of the plain
    version (which the other tests hold to the JAX package)."""
    from focalsv_tpu_torch.testing import host_kernel
    buf, args = region_cases.build(name)
    kw = {**trs.STEP_DEFAULTS, **args}
    want = trs.phase_consensus_delta_flat_plain(torch.from_numpy(buf), **kw)
    np.testing.assert_array_equal(
        host_kernel.region_step(buf, **kw, cluster=cluster), want.numpy())



# -- B3: the dense (rows) step ----------------------------------------------

@pytest.mark.parametrize("name", ROWS_CASES)
def test_rows_plain_matches_jax_on_case(name):
    """phase_consensus_rows_flat_plain against the JAX package's
    phase_consensus_rows_flat, byte for byte."""
    buf, args = region_cases.build_rows(name)
    want = np.asarray(jrs.phase_consensus_rows_flat(buf, **args))
    got = trs.phase_consensus_rows_flat_plain(torch.from_numpy(buf), **args)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_rows_cases_hold_what_they_name():
    """The dense cases' regions have the sites they are built for: none and
    one, a full strip set where strips are crowded, S sites at R 1024."""
    def n_sites(name):
        buf, args = region_cases.build_rows(name)
        out = trs.phase_consensus_rows_flat_plain(torch.from_numpy(buf),
                                                  **args)
        return out[:, :4].contiguous().view(torch.int32).reshape(-1).tolist()

    assert n_sites("rows_zero_and_one_het") == [0, 1, 0, 0]
    assert n_sites("rows_crowded_strips") == [16]
    assert n_sites("rows_tile_edges")[0] >= 6
    _buf, args = region_cases.build_rows("rows_r1024_s1024")
    assert (args["R"], args["max_sites"]) == (1024, 1024)
    # three planes of S rows by R bits: past a CTA's 232,448 bytes
    assert 3 * args["max_sites"] * args["R"] // 8 > 232448


def test_rows_cpu_buffer_takes_the_plain_version(monkeypatch):
    buf, args = region_cases.build_rows("rows_zero_and_one_het")

    def no_kernel(*a, **k):
        raise AssertionError("a CPU buffer reached B3's wrapper")

    monkeypatch.setattr(region_cuda, "phase_consensus_rows_flat_cuda",
                        no_kernel)
    region_cuda.reset_launches()
    tbuf = torch.from_numpy(buf)
    got = trs.phase_consensus_rows_flat(tbuf, **args)
    assert region_cuda.rows_launches == 0
    assert torch.equal(got, trs.phase_consensus_rows_flat_plain(tbuf,
                                                                **args))
    # the packed-arrays entry on the CPU: the same plain version
    G, R, W = args["G"], args["R"], args["W"]
    lay = rows_flat_layout(G, R, W)

    def sect(name):
        a, b = lay[name]
        return tbuf[a:b]

    packed = trs.phase_consensus_rows_packed(
        sect("rows").reshape(G, R, W // 2),
        sect("qstart").view(torch.int32).reshape(G, R),
        sect("rv").reshape(G, R) != 0, sect("ltrue").view(torch.int32),
        L=args["L"], W=W)
    assert torch.equal(packed, got)


def test_rows_wrapper_refuses_what_the_kernel_does_not_take():
    buf, args = region_cases.build_rows("rows_zero_and_one_het")
    kw = {**trs.STEP_DEFAULTS, **args}
    tbuf = torch.from_numpy(buf)
    cuda_rows = region_cuda.phase_consensus_rows_flat_cuda
    with pytest.raises(ValueError, match="CUDA"):
        cuda_rows(tbuf, **kw)
    with pytest.raises(TypeError, match="uint8"):
        cuda_rows(tbuf.view(torch.int32), **kw)
    with pytest.raises(ValueError, match="bytes"):
        cuda_rows(tbuf[:-4], **kw)
    with pytest.raises(ValueError, match="1-D"):
        cuda_rows(tbuf.reshape(2, -1), **kw)
    with pytest.raises(ValueError, match="multiples of 128"):
        cuda_rows(tbuf, **{**kw, "L": 8200})
    with pytest.raises(ValueError, match="multiples of 128"):
        cuda_rows(tbuf, **{**kw, "W": 4100})
    with pytest.raises(ValueError, match="32767 reads"):
        cuda_rows(tbuf, **{**kw, "R": 32768})
    # int32 sections off their boundary: R * G not a multiple of 4
    lay = rows_flat_layout(1, 9, 128)
    with pytest.raises(ValueError, match="aligned"):
        cuda_rows(torch.zeros(lay["__total__"][1], dtype=torch.uint8),
                  **{**kw, "G": 1, "R": 9, "W": 128})
    assert region_cuda.rows_launches == 0


@pytest.mark.parametrize("name,cluster", [
    ("rows_symbols", 0), ("rows_symbols", 2), ("rows_past_ltrue_and_l", 4),
    ("rows_zero_and_one_het", 1), ("rows_mec_settles_late", 2),
    ("rows_w_equals_l", 4), ("rows_crowded_strips", 1),
    ("rows_r1024_s1024", 1), ("rows_r1024_s1024", 4),
    ("rows_tile_edges", 1), ("rows_tile_edges", 2), ("rows_tile_edges", 4),
])
def test_rows_kernel_source_on_the_cpu_matches_plain(name, cluster):
    """B3's source (csrc/region_step.cu, RowsSrc) compiled by g++ against
    the CPU stand-in for the CUDA runtime, with 1, 2 or 4 CTAs a region
    (0: the kernel's choice on a card of 132 SMs): the bytes of the plain
    version."""
    from focalsv_tpu_torch.testing import host_kernel
    buf, args = region_cases.build_rows(name)
    kw = {**trs.STEP_DEFAULTS, **args}
    want = trs.phase_consensus_rows_flat_plain(torch.from_numpy(buf), **kw)
    np.testing.assert_array_equal(
        host_kernel.region_rows(buf, **kw, cluster=cluster), want.numpy())
