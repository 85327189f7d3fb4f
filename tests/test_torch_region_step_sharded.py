"""The port's unpacked and mesh-sharded region-step entries
(focalsv_tpu_torch/parallel/region_step.py) against the JAX package's, on
the same numpy inputs made from a seed, and each sharded entry against its
unsharded twin.  Tolerance 0: the step is integer arithmetic plus one
correctly rounded f32 division.  The port's meshes are logical shards of
the CPU; JAX's are slices of the virtual 8-device CPU mesh of
tests/conftest.py.  The last four cases are the counterparts of
tests/test_region_step.py."""

import dataclasses

import numpy as np
import pytest
import torch

from focalsv_tpu.config import preset
from focalsv_tpu.parallel import mesh as jmesh
from focalsv_tpu.parallel import region_step as jrs
from focalsv_tpu.pipeline import device_exec as jdx
from focalsv_tpu_torch.config import config_from_reference
from focalsv_tpu_torch.parallel import mesh as tmesh
from focalsv_tpu_torch.parallel import region_step as trs
from focalsv_tpu_torch.parallel import wire
from focalsv_tpu_torch.pipeline import device_exec as tdx
from focalsv_tpu_torch.testing import simulate as sim

KW = dict(max_sites=16, mec_iters=4)
G, R, L, W = 4, 12, 512, 512
DS, DD = 256, 16


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _pileup(seed, R=R, L=L):
    """One region's dense pileup with every symbol class: substitutions, N
    bases, reference-N columns, deletion runs, ragged spans, an invalid
    row.  Returns (mat (R, L), valid (R,), ref (L,))."""
    rng = np.random.default_rng(seed)
    ref = rng.integers(0, 4, L).astype(np.uint8)
    ref[100:103] = 4                       # reference-N columns
    mat = np.full((R, L), 255, np.uint8)
    valid = np.ones(R, bool)
    valid[R - 1] = False                   # one invalid row
    hap = rng.integers(0, 2, R)
    het_sites = np.arange(20, L - 20, 37)
    alt = (ref + 1) % 4
    for i in range(R - 1):
        s0 = int(rng.integers(0, L // 3))
        s1 = int(rng.integers(2 * L // 3, L)) + 1
        row = ref[s0:s1].copy()
        if hap[i]:                         # hap-1 carries the alt alleles
            for p in het_sites:
                if s0 <= p < s1:
                    row[p - s0] = alt[p]
        err = rng.random(row.size) < 0.02  # random subs incl. some N
        row[err] = rng.integers(0, 5, int(err.sum()))
        if i % 5 == 0:                     # a deletion run
            a = int(rng.integers(0, row.size - 40))
            row[a : a + 30] = 254
        mat[i, s0:s1] = row
    return mat, valid, ref


def _delta_arrays_from_dense(mat, valid, ref):
    """The delta wire arrays of a dense (R, L) pileup (per-read span +
    substitutions + DEL runs), the inverse of the step's count
    reconstruction."""
    R, L = mat.shape
    starts = np.zeros(R, np.int32)
    ends = np.zeros(R, np.int32)
    sp, sr, ss = [], [], []
    dr, da, db = [], [], []
    for i in range(R):
        cov = np.nonzero(mat[i] != 255)[0]
        if not valid[i] or cov.size == 0:
            continue
        s0, s1 = int(cov[0]), int(cov[-1]) + 1
        starts[i], ends[i] = s0, s1
        row = mat[i, s0:s1]
        isdel = row == 254
        sub_at = np.nonzero((row != ref[s0:s1]) & ~isdel)[0]
        sp.extend((s0 + sub_at).tolist())
        sr.extend([i] * sub_at.size)
        ss.extend(row[sub_at].tolist())
        d = np.diff(np.concatenate([[0], isdel.astype(np.int8), [0]]))
        for a, b in zip(np.nonzero(d == 1)[0], np.nonzero(d == -1)[0]):
            dr.append(i)
            da.append(s0 + int(a))
            db.append(s0 + int(b))
    return (starts, ends,
            (np.array(sp, np.int32), np.array(sr, np.int32),
             np.array(ss, np.uint8)),
            (np.array(dr, np.int32), np.array(da, np.int32),
             np.array(db, np.int32)))


def _padded(a, n, fill):
    out = np.full(n, fill, a.dtype)
    out[: a.size] = a
    return out


@pytest.fixture(scope="module")
def batch():
    """G regions as every entry's arguments."""
    mats, valids, refs, deltas, rows_packed, qstarts = [], [], [], [], [], []
    for g in range(G):
        mat, valid, ref = _pileup(40 + g)
        mats.append(mat)
        valids.append(valid)
        refs.append(ref)
        starts, ends, subs, dels = _delta_arrays_from_dense(mat, valid, ref)
        deltas.append((ref, starts, ends, valid,
                       _padded(subs[0], DS, 0), _padded(subs[1], DS, -1),
                       _padded(subs[2], DS, 0), _padded(dels[0], DD, -1),
                       _padded(dels[1], DD, 0), _padded(dels[2], DD, 0)))
        rows = [mat[i, starts[i] : ends[i]] for i in range(R)]
        offs = (starts % wire.BLOCK).astype(np.int32)
        rows_packed.append(wire.pack_row_tile(rows, W + wire.BLOCK,
                                              offsets=offs))
        qstarts.append((starts // wire.BLOCK).astype(np.int32))
    mat, valid = np.stack(mats), np.stack(valids)
    return dict(
        batch=(mat, valid),
        batch_packed=(np.stack([wire.pack_nibbles(m) for m in mats]), valid),
        delta=tuple(np.stack(col) for col in zip(*deltas)),
        rows_packed=(np.stack(rows_packed), np.stack(qstarts), valid))


def _tensors(args):
    return [torch.from_numpy(a) for a in args]


ENTRIES = {
    # name: (extra keywords, the sharded entries take the mesh after these)
    "batch": {},
    "batch_packed": dict(L=L),
    "delta": dict(L=L),
    "rows_packed": dict(L=L, W=W + wire.BLOCK),
}


def _unsharded(pkg, name, args, as_tensors):
    fn = getattr(pkg, "phase_consensus_" + name)
    out = fn(*(_tensors(args) if as_tensors else args), **ENTRIES[name], **KW)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(x) for x in out]


def _sharded(pkg, name, args, mesh):
    kw = dict(ENTRIES[name], **KW)
    if name == "batch":
        out = pkg.sharded_phase_consensus(*args, mesh, **kw)
    elif name == "batch_packed":
        out = pkg.sharded_phase_consensus_packed(*args, mesh, **kw)
    elif name == "delta":
        out = pkg.sharded_phase_consensus_delta(args, mesh, **kw)
    else:
        out = pkg.sharded_phase_consensus_rows_packed(*args, mesh, **kw)
    out = out if isinstance(out, tuple) else (out,)
    return [np.asarray(x) for x in out]


def _assert_all_equal(got, want):
    assert len(got) == len(want)
    for a, b in zip(got, want):
        assert a.shape == b.shape and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_unpacked_entry_matches_jax(batch, name):
    got = _unsharded(trs, name, batch[name], True)
    want = _unsharded(jrs, name, batch[name], False)
    _assert_all_equal(got, want)
    if name == "batch":
        assert (got[1] > 2).all() and (got[3] > 0).sum() > 3 * G


def test_unpacked_entries_agree_with_each_other(batch):
    """The four encodings of one batch give one result (the reference's
    parity between its dense and delta steps)."""
    site_pos, n_sites, _A, hp, sym, cov = _unsharded(trs, "batch",
                                                     batch["batch"], True)
    flats = [_unsharded(trs, n, batch[n], True)[0]
             for n in ("batch_packed", "delta", "rows_packed")]
    for flat in flats:
        np.testing.assert_array_equal(flat, flats[0])
    for g in range(G):
        sp, ns, hp2, sym2, cov2, *_ = trs.unflatten_result(flats[0][g], R, L,
                                                           KW["max_sites"])
        assert ns == n_sites[g]
        np.testing.assert_array_equal(sp[:ns], site_pos[g][:ns])
        np.testing.assert_array_equal(hp2, hp[g])
        np.testing.assert_array_equal(cov2, cov[g])


def test_step_refuses_unknown_keywords(batch):
    with pytest.raises(TypeError, match="max_site"):
        trs.phase_consensus_batch(*_tensors(batch["batch"]), max_site=4)


@pytest.mark.parametrize("name", sorted(ENTRIES))
def test_sharded_entry_matches_unsharded_and_jax(batch, name):
    local = _unsharded(trs, name, batch[name], True)
    got = _sharded(trs, name, batch[name], tmesh.make_mesh(2))
    _assert_all_equal(got, local)
    want = _sharded(jrs, name, batch[name], jmesh.make_mesh(2))
    _assert_all_equal(got, want)
    # one region a shard
    _assert_all_equal(_sharded(trs, name, batch[name], tmesh.make_mesh(G)),
                      local)


# -- the production (flat) entries, on tiles of simulated regions ------------

def _cfgs(dtype="HIFI"):
    cfg = preset(dtype)
    cfg = cfg.replace(
        phasing=dataclasses.replace(cfg.phasing, max_sites=32, mec_iters=5),
        # one region a batch for dense tiles, four for delta tiles
        execution=dataclasses.replace(cfg.execution, max_regions_per_batch=1))
    return cfg, config_from_reference(dataclasses.asdict(cfg))


def _tiles(n, dtype="HIFI", seed0=8200):
    noise = ({} if dtype == "HIFI"
             else dict(sub_rate=0.04, ins_rate=0.04, del_rate=0.02))
    cfg, tcfg = _cfgs(dtype)
    rgs = [sim.simulate_region(seed=seed0 + i, ref_len=3000, coverage=10,
                               n_snps=6, read_len_mean=1500, read_len_sd=200,
                               **noise) for i in range(n)]
    return cfg, tcfg, [tdx.build_tile(rg.reads, rg.ref, 0, rg.chrom, tcfg)
                       for rg in rgs]


def _force_dense(tile):
    from focalsv_tpu_torch import native
    out = native.build_tile_rows(tile.usable, 0, tile.region_len,
                                 tdx._wbucket, wire.BLOCK)
    assert out is not None
    tile.nib, starts, tile.row_lens, _ins, tile.W_pad = out
    tile.row_starts = starts
    tile.q_starts = (starts // wire.BLOCK).astype(np.int32)
    tile.encoding = "dense"
    return tile


def _common_key(tiles, cfg):
    keys = [tdx._bucket_key(t, cfg) for t in tiles]
    assert all(k is not None and k[0] == keys[0][0] for k in keys), keys
    return (keys[0][0],) + tuple(max(k[i] for k in keys)
                                 for i in range(1, len(keys[0])))


@pytest.mark.parametrize("encoding", ["delta", "dense"])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_flat_entry_matches_unsharded_and_jax(encoding, n_shards):
    """The wire buffer of a chunk, re-packed per device: 3 real regions and
    a padded slot over 2 and 4 shards."""
    cfg, tcfg, tiles = _tiles(3)
    if encoding == "dense":
        tiles = [_force_dense(t) for t in tiles]
    key = _common_key(tiles, tcfg)
    n = 4
    buf = tdx.pack_chunk(tiles + [None], list(range(n)), key, n)
    kw = trs.phase_consensus_kwargs(tcfg.phasing)
    assert kw == jrs.phase_consensus_kwargs(cfg.phasing)
    if encoding == "delta":
        _, Rp, Lp, Ds, Dd = key
        kw.update(G=n, R=Rp, L=Lp, Ds=Ds, Dd=Dd, Drle=tdx.drle_of(key))
        name = "delta_flat"
    else:
        _, Rp, Lp, Wp = key
        kw.update(G=n, R=Rp, L=Lp, W=Wp)
        name = "rows_flat"
    local = getattr(trs, "phase_consensus_" + name)(torch.from_numpy(buf),
                                                    **kw).numpy()
    pending = getattr(trs, "sharded_phase_consensus_" + name)(
        buf, tmesh.make_mesh(n_shards), **kw)
    assert isinstance(pending, tmesh.PendingResult) and pending.is_ready()
    got = np.asarray(pending)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, local)
    want = np.asarray(getattr(jrs, "sharded_phase_consensus_" + name)(
        buf, jmesh.make_mesh(n_shards), **kw))
    np.testing.assert_array_equal(got, want)


def test_sharded_flat_entry_refuses_an_uneven_batch():
    _cfg, tcfg, tiles = _tiles(3)
    key = _common_key(tiles, tcfg)
    buf = tdx.pack_chunk(tiles, [0, 1, 2], key, 3)
    _, Rp, Lp, Ds, Dd = key
    with pytest.raises(ValueError, match="does not split"):
        trs.sharded_phase_consensus_delta_flat(
            buf, tmesh.make_mesh(2), G=3, R=Rp, L=Lp, Ds=Ds, Dd=Dd)


def _assert_decoded_equal(got: dict, want: dict):
    assert sorted(got) == sorted(want)
    for i in want:
        assert len(got[i]) == len(want[i])
        for a, b in zip(got[i], want[i]):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


@pytest.mark.parametrize("n_shards,n_tiles", [(2, 3), (3, 4), (2, 5)])
def test_dispatch_device_chunks_pads_to_the_mesh(n_shards, n_tiles):
    """G not divisible by the mesh: _batch_size rounds the batch to the mesh,
    the tail is padded with empty regions, and only the real regions come
    back, equal to the unsharded run's and to the JAX package's on its
    mesh."""
    cfg, tcfg, tiles = _tiles(n_tiles)
    mesh = tmesh.make_mesh(n_shards)
    pending = tdx.dispatch_device_chunks(tiles, tcfg, mesh=mesh)
    for chunk, key, res in pending:
        G_chunk = np.asarray(res).shape[0]
        assert G_chunk % n_shards == 0 and len(chunk) <= G_chunk
    assert sorted(i for chunk, _, _ in pending for i in chunk) == \
        list(range(n_tiles))
    assert any(len(chunk) < np.asarray(res).shape[0]
               for chunk, _, res in pending), "no chunk was padded"
    got = tdx.run_device_step(tiles, tcfg, mesh=mesh)
    _assert_decoded_equal(got, tdx.run_device_step(tiles, tcfg))
    _assert_decoded_equal(
        got, jdx.run_device_step(tiles, cfg, mesh=jmesh.make_mesh(n_shards)))


def test_streamed_map_on_a_mesh_equals_one_device():
    """streamed_map through a 2-shard mesh finishes every region with the
    unsharded run's step outputs, padded slots never reaching finish."""
    from concurrent.futures import ThreadPoolExecutor
    _cfg, tcfg, tiles = _tiles(5)
    jobs = [(lambda t=t: t) for t in tiles]

    def run(mesh):
        seen = {}

        def finish(i, tile, dev):
            assert tile is tiles[i] and dev is not None
            seen[i] = dev
            return i
        stats = {}
        with ThreadPoolExecutor(max_workers=2) as pool:
            out = tdx.streamed_map(pool, jobs, tcfg, finish, stats=stats,
                                   mesh=mesh)
        assert out == list(range(5))
        return seen, stats

    sharded, st = run(tmesh.make_mesh(2))
    local, st1 = run(None)
    _assert_decoded_equal(sharded, local)
    assert st["n_chunks"] == st1["n_chunks"] == 2 and st["n_host_fallback"] == 0


# -- counterparts of tests/test_region_step.py --------------------------------

def _dense_tiles(regions, L):
    from focalsv_tpu_torch.assembly.consensus import pileup_with_dels
    n = len(regions)
    Rm = max(len(rg.reads) for rg in regions)
    mat = np.full((n, Rm, L), 255, np.uint8)
    valid = np.zeros((n, Rm), bool)
    for g, rg in enumerate(regions):
        m, _ = pileup_with_dels(rg.reads, list(range(len(rg.reads))), 0, L)
        mat[g, : m.shape[0], : m.shape[1]] = m[:, :L]
        valid[g, : len(rg.reads)] = True
    return mat, valid


def test_phase_consensus_batch_recovers_haplotypes():
    from focalsv_tpu_torch.config import preset as tpreset
    Lr = 12_000
    regions = [sim.simulate_region(seed=500 + i, ref_len=Lr, coverage=20,
                                   n_snps=15, read_len_mean=5_000,
                                   svs=[]) for i in range(4)]
    mat, valid = _dense_tiles(regions, Lr)
    kw = trs.phase_consensus_kwargs(tpreset("HIFI").phasing)
    kw.update(max_sites=32, mec_iters=15)
    out = trs.phase_consensus_batch(*_tensors((mat, valid)), **kw)
    site_pos, n_sites, A, hp, sym, cov = [x.numpy() for x in out]
    for g, rg in enumerate(regions):
        truth = np.array(rg.read_hap)
        h = hp[g, : len(rg.reads)]
        phased = h > 0
        assert phased.mean() > 0.6, f"region {g}: only {phased.mean()} phased"
        agree = (h[phased] - 1 == truth[phased]).mean()
        assert max(agree, 1 - agree) > 0.9, f"region {g} agreement {agree}"
        assert int(n_sites[g]) > 0
        sp = site_pos[g, : int(n_sites[g])]
        assert (np.diff(sp) > 0).all()     # ascending genome positions
        covered = cov[g, 0]
        s1 = sym[g, 0]
        base_cols = covered & (s1 < 4)
        match_frac = (s1[base_cols]
                      == rg.ref[np.nonzero(base_cols)[0]]).mean()
        assert match_frac > 0.95


def test_device_phasing_matches_host_reference():
    """The step's het sites and hp bit-match the port's host phasing (the
    device_exec parity contract, at the step's level)."""
    from focalsv_tpu_torch.config import preset as tpreset
    from focalsv_tpu_torch.phasing import phase as ph
    pcfg = tpreset("HIFI").phasing
    Lr = 8_000
    regions = [sim.simulate_region(seed=900 + i, ref_len=Lr, coverage=16,
                                   n_snps=10, read_len_mean=4_000)
               for i in range(3)]
    mat, valid = _dense_tiles(regions, Lr)
    out = trs.phase_consensus_batch(*_tensors((mat, valid)),
                                    **trs.phase_consensus_kwargs(pcfg))
    site_pos, n_sites, A, hp, sym, cov = [x.numpy() for x in out]
    for g, rg in enumerate(regions):
        pr = ph.phase_region(rg.reads, rg.ref, 0, pcfg)
        S = int(n_sites[g])
        np.testing.assert_array_equal(site_pos[g, :S], pr.site_positions,
                                      err_msg=f"region {g} het sites")
        if pr.n_blocks <= 1:
            np.testing.assert_array_equal(hp[g, : len(rg.reads)], pr.hp,
                                          err_msg=f"region {g} hp")


def test_sharded_region_step():
    from focalsv_tpu_torch.config import preset as tpreset
    Lr = 6_000
    regions = [sim.simulate_region(seed=600 + i, ref_len=Lr, coverage=12,
                                   n_snps=8, read_len_mean=3_000, svs=[])
               for i in range(8)]
    mat, valid = _dense_tiles(regions, Lr)
    kw = trs.phase_consensus_kwargs(tpreset("HIFI").phasing)
    kw.update(max_sites=16, mec_iters=10)
    out_sharded = trs.sharded_phase_consensus(mat, valid,
                                              tmesh.make_mesh(8), **kw)
    out_local = trs.phase_consensus_batch(*_tensors((mat, valid)), **kw)
    for a, b in zip(out_sharded, out_local):
        assert torch.equal(a, b)


def test_delta_kernel_matches_dense_kernel():
    """phase_consensus_delta bit-matches phase_consensus_batch on a pileup
    with every symbol class."""
    S = 64
    mat, valid, ref = _pileup(42, R=24)
    kw = dict(max_sites=S, mec_iters=10)
    d_site, d_n, _dA, d_hp, d_sym, d_cov = (
        x.numpy() for x in trs.phase_consensus_batch(
            *_tensors((mat[None], valid[None])), **kw))
    starts, ends, subs, dels = _delta_arrays_from_dense(mat, valid, ref)
    flat = trs.phase_consensus_delta(*_tensors(
        (ref[None], starts[None], ends[None], valid[None],
         subs[0][None], subs[1][None], subs[2][None],
         dels[0][None], dels[1][None], dels[2][None])), L=L, **kw).numpy()
    (site_pos, n_sites, hp, sym, cov, _a0, _a1, _h, _c,
     _rb) = trs.unflatten_result(flat[0], 24, L, S)
    assert n_sites == int(d_n[0])
    np.testing.assert_array_equal(site_pos[:n_sites], d_site[0][:n_sites])
    np.testing.assert_array_equal(hp, d_hp[0])
    np.testing.assert_array_equal(sym % 16, np.where(
        d_sym[0] == 254, 5, np.where(d_sym[0] == 255, 15, d_sym[0])) % 16)
    np.testing.assert_array_equal(cov, d_cov[0])
    assert n_sites > 4 and (hp > 0).sum() > 10   # the parity is exercised


def test_mp_executor_on_a_mesh_equals_one_device(tmp_path, monkeypatch):
    """MpRegionExecutor with a mesh: the parent splits each chunk over the
    shards (3 regions in batches rounded to the mesh) and the children
    finish the same records as without one."""
    from focalsv_tpu_torch.pipeline.mp_exec import MpRegionExecutor
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the children inherit it
    _cfg, tcfg, _ = _tiles(0)
    jobs = []
    for i in range(3):
        rg = sim.simulate_region(seed=8300 + i, ref_len=4000, coverage=12,
                                 n_snps=6, read_len_mean=1500,
                                 svs=[sim.SimSV("DEL", 2000, 90 + 10 * i,
                                                "1/1")])
        bam, ref = str(tmp_path / f"r{i}.bam"), str(tmp_path / f"r{i}.npy")
        sim.write_region_bam(rg, bam)
        np.save(ref, rg.ref)
        jobs.append((bam, ref, "chr21"))

    def keys(out):
        return [[(r.pos, r.ref, r.alt, r.gt) for r in res.records]
                for _n, res in out]

    mesh = tmesh.make_mesh(2)
    with MpRegionExecutor(tcfg, n_children=1, mesh=mesh) as ex:
        assert ex.n_devices == 2 and ex.device == mesh.devices[0]
        stats = {}
        sharded = keys(ex.run(jobs, collect="records", stats=stats))
        assert stats["n_chunks"] == 1 and stats["cuda_initialized"] == 0
    with MpRegionExecutor(tcfg, n_children=1) as ex:
        assert ex.n_devices == 1
        local = keys(ex.run(jobs, collect="records"))
    assert sharded == local and all(sharded)
