"""The port's region step (focalsv_tpu_torch/parallel/region_step.py)
against the JAX package's: tiles built by focalsv_tpu's device_exec, packed
by the shared wire module, must give the same flat result bytes from both.
Tolerance 0: the step is integer arithmetic plus one correctly rounded f32
division."""

import dataclasses

import numpy as np
import pytest
import torch

from focalsv_tpu.config import preset
from focalsv_tpu.parallel import region_step as jrs
from focalsv_tpu.pipeline import device_exec as dx
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.parallel import region_step as trs


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


NOISE = {"HIFI": dict(sub_rate=0.001),
         "CLR": dict(sub_rate=0.04, ins_rate=0.04, del_rate=0.02),
         "ONT": dict(sub_rate=0.03, ins_rate=0.02, del_rate=0.03)}


def _region(seed, dtype="HIFI", **kw):
    args = dict(ref_len=7000, coverage=16, n_snps=8, read_len_mean=3000,
                read_len_sd=500)
    args.update(NOISE[dtype])
    args.update(kw)
    return sim.simulate_region(seed=seed, **args)


def _with_n_bases(rg, seed):
    """Sprinkle N (code 4) into the reads: substitutions of symbol N."""
    rng = np.random.default_rng(seed)
    reads = []
    for r in rg.reads:
        seq = np.array(r.seq, np.uint8)
        seq[rng.integers(0, len(seq), 6)] = 4
        reads.append(dataclasses.replace(r, seq=seq))
    return dataclasses.replace(rg, reads=reads)


def _multi_block(rg):
    """Drop the middle reads so the het sites fall into two phase blocks."""
    L = len(rg.ref)
    reads = [r for r in rg.reads
             if r.reference_end < 0.4 * L or r.pos > 0.6 * L]
    return dataclasses.replace(rg, reads=reads)


def _common_key(tiles, cfg):
    """One bucket key that holds every tile (the widest of their keys)."""
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    assert all(k is not None and k[0] == keys[0][0] for k in keys), keys
    return (keys[0][0],) + tuple(max(k[i] for k in keys)
                                 for i in range(1, len(keys[0])))


def _compare(tiles, cfg, Drle=None):
    key = _common_key(tiles, cfg)
    G = len(tiles) + 1                      # one padded, empty slot
    buf = dx.pack_chunk(tiles + [None], list(range(G)), key, G)
    kw = jrs.phase_consensus_kwargs(cfg.phasing)
    assert trs.phase_consensus_kwargs(cfg.phasing) == kw
    tbuf = torch.from_numpy(buf)
    if key[0] == "delta":
        _, R, L, Ds, Dd = key
        kw["Drle"] = dx.drle_of(key) if Drle is None else Drle
        want = jrs.phase_consensus_delta_flat(buf, G=G, R=R, L=L, Ds=Ds,
                                              Dd=Dd, **kw)
        got = trs.phase_consensus_delta_flat(tbuf, G=G, R=R, L=L, Ds=Ds,
                                             Dd=Dd, **kw)
    else:
        _, R, L, W = key
        want = jrs.phase_consensus_rows_flat(buf, G=G, R=R, L=L, W=W, **kw)
        got = trs.phase_consensus_rows_flat(tbuf, G=G, R=R, L=L, W=W, **kw)
    want = np.asarray(want)
    assert got.dtype == torch.uint8 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)
    return key, want


def _force_dense(tile):
    from focalsv_tpu import native
    from focalsv_tpu.parallel.wire import BLOCK
    out = native.build_tile_rows(tile.usable, 0, tile.region_len,
                                 dx._wbucket, BLOCK)
    assert out is not None
    tile.nib, starts, tile.row_lens, _ins, tile.W_pad = out
    tile.row_starts = starts
    tile.q_starts = (starts // BLOCK).astype(np.int32)
    tile.encoding = "dense"
    return tile


@pytest.fixture(scope="module")
def hifi_tiles():
    cfg = preset("HIFI")
    rgs = [_region(8000), _region(8001),
           _with_n_bases(_region(8002), 1),
           _multi_block(_region(8003, ref_len=8000, coverage=20,
                                n_snps=16, read_len_mean=1500)),
           _region(8004, n_snps=0, svs=[])]
    return cfg, [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
                 for rg in rgs]


@pytest.mark.parametrize("drle", ["bucket", "dense", "overflow"])
def test_delta_chunk_hifi(hifi_tiles, drle):
    """HIFI delta chunk with N bases, a multi-block region and a region
    without het sites, under the RLE result layout, the dense result
    layout and an RLE budget that overflows."""
    cfg, tiles = hifi_tiles
    assert all(t.encoding == "delta" for t in tiles)
    Drle = {"bucket": None, "dense": 0, "overflow": 2}[drle]
    key, flat = _compare(tiles, cfg, Drle=Drle)
    from focalsv_tpu.parallel.wire import unflatten_result
    if drle == "dense":
        decoded = [unflatten_result(flat[g], key[1], key[2],
                                    cfg.phasing.max_sites)
                   for g in range(len(tiles))]
        conn = decoded[3][8][: decoded[3][1]]
        assert decoded[3][1] > 1 and (conn[:-1] == 0).any(), \
            "the carved region must phase as more than one block"
        assert decoded[4][1] == 0
    if drle == "overflow":
        from focalsv_tpu.parallel.wire import unflatten_result_rle
        assert any(unflatten_result_rle(flat[g], key[1],
                                        cfg.phasing.max_sites, 2,
                                        tiles[g].ref_codes) is None
                   for g in range(len(tiles)))


def test_dense_chunk_from_hifi(hifi_tiles):
    cfg, tiles = hifi_tiles
    dense = [_force_dense(dx.build_tile(t.usable, t.ref_codes, 0, t.chrom,
                                        cfg)) for t in tiles[:3]]
    _compare(dense, cfg)


@pytest.mark.parametrize("dtype", ["CLR", "ONT"])
def test_noisy_chunks(dtype):
    """Noisy reads: each encoding the tile builder picks gets a chunk."""
    cfg = preset(dtype)
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg)
             for rg in (_region(8100, dtype), _region(8101, dtype))]
    for enc in sorted({t.encoding for t in tiles}):
        _compare([t for t in tiles if t.encoding == enc], cfg)


def test_unpack_nibbles_and_packbits():
    rng = np.random.default_rng(0)
    packed = rng.integers(0, 256, (3, 8), dtype=np.uint8)
    got = trs._unpack_nibbles(torch.from_numpy(packed), 16).numpy()
    want = np.asarray(jrs._unpack_nibbles(packed, 16))
    np.testing.assert_array_equal(got, want)
    bits = rng.integers(0, 2, (2, 64)).astype(bool)
    np.testing.assert_array_equal(
        trs._packbits(torch.from_numpy(bits)).numpy(),
        np.packbits(bits, axis=1))


def test_argmax_ties_take_first():
    x = torch.tensor([[3, 3, 1], [0, 2, 2], [5, 5, 5]], dtype=torch.int32)
    assert trs._argmax_first(x).tolist() == [0, 1, 0]
