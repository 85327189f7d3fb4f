"""Tests of the port that need the card: kernels B1 (banded DP), B2 (the
delta region step), B3 (the dense region step) and B4 (traceback) and the
region step on CUDA against their plain versions, the mesh-sharded region
step and DP against the unsharded ones, byte for byte (tolerance 0), and an
NCCL group of one.

They skip without a CUDA device.  This file imports no jax, so that it runs
on a machine without it:

    python -m pytest --noconftest -m cuda tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.ops import align_cuda
from focalsv_tpu_torch.testing import dp_cases, region_cases

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


def _two_shards(cuda):
    """A mesh of the cards present, or two logical shards of the one card."""
    from focalsv_tpu_torch.parallel.mesh import make_mesh
    if torch.cuda.device_count() >= 2:
        return make_mesh(2)
    return make_mesh(devices=[torch.device("cuda", 0)] * 2)


@pytest.mark.cuda
@pytest.mark.parametrize("encoding", ["delta", "dense"])
def test_sharded_region_step_on_card_matches_unsharded(cuda, encoding):
    """Each chunk split over two shards, each on a stream of its own, gives
    the unsharded call's bytes; repeated so that a buffer freed under one
    stream and reused under another would show."""
    from focalsv_tpu_torch import native
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel.wire import BLOCK
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.testing import simulate as sim
    cfg = preset("HIFI")
    rgs = [sim.simulate_region(seed=s, ref_len=9000, coverage=20, n_snps=10,
                               read_len_mean=4000) for s in (1, 2, 3)]
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg) for rg in rgs]
    if encoding == "dense":
        for t in tiles:
            # one row width for all, so that they share a bucket
            t.nib, starts, t.row_lens, _ins, t.W_pad = native.build_tile_rows(
                t.usable, 0, t.region_len, lambda n: 12288, BLOCK)
            t.row_starts = starts
            t.q_starts = (starts // BLOCK).astype(np.int32)
            t.encoding = "dense"
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    key = (keys[0][0],) + tuple(max(k[i] for k in keys)
                                for i in range(1, len(keys[0])))
    buf = dx.pack_chunk(tiles + [None], [0, 1, 2, 3], key, 4)
    from focalsv_tpu_torch.ops import region_cuda
    region_cuda.reset_launches()
    want = np.asarray(dx.dispatch_packed(buf, key, 4, cfg, cuda))
    mesh = _two_shards(cuda)
    pending = [dx.dispatch_packed(buf, key, 4, cfg, None, mesh)
               for _ in range(4)]
    for res in pending:
        np.testing.assert_array_equal(np.asarray(res), want)
    assert all(res.is_ready() for res in pending)
    # B2 a delta shard, B3 a dense one: once unsharded, once a shard after
    counts = (region_cuda.launches, region_cuda.rows_launches)
    n = 1 + 4 * mesh.size
    assert counts == ((n, 0) if encoding == "delta" else (0, n))


@pytest.mark.cuda
def test_sharded_banded_align_on_card_matches_unsharded(cuda):
    """B1 once per shard, on the shard's device and stream; scores and
    direction bytes equal the unsharded kernel's and the plain version's."""
    from focalsv_tpu_torch.parallel import mesh as pmesh
    host = _pairs(5, 8, 600, 128)
    args = [torch.from_numpy(a).to(cuda) for a in host]
    mesh = _two_shards(cuda)
    before = align_cuda.launches
    s_sh, d_sh = pmesh.sharded_banded_align(*host, mesh=mesh, band=128)
    scores, cand, global_cand = pmesh.sharded_sv_candidate_step(*host,
                                                                mesh=mesh)
    torch.cuda.synchronize()
    assert align_cuda.launches == before + 2 * mesh.size
    s_k, d_k = talign.banded_align(*args, band=128)
    s_p, d_p = talign.banded_align_batch(*args, band=128)
    dev0 = mesh.devices[0]
    assert s_sh.device == dev0 and d_sh.device == dev0
    assert torch.equal(s_sh, s_k.to(dev0)) and torch.equal(d_sh, d_k.to(dev0))
    assert torch.equal(s_sh, s_p.to(dev0)) and torch.equal(d_sh, d_p.to(dev0))
    hdir = d_p & talign.DIR_H_MASK
    want = torch.stack([s_p, (hdir == 1).sum(dim=(1, 2), dtype=torch.int32),
                        (hdir == 2).sum(dim=(1, 2), dtype=torch.int32)], 1)
    assert torch.equal(scores, s_p.to(dev0))
    assert torch.equal(cand, want.to(dev0))
    assert [c.device for c in global_cand] == list(mesh.devices)
    assert all(torch.equal(c.cpu(), want.cpu()) for c in global_cand)


@pytest.mark.cuda
def test_kernel_runs_on_the_tensors_device(cuda):
    """B1 and B4 launched on the last card present (not the current
    device): the launcher switches to the tensors' device."""
    last = torch.device("cuda", torch.cuda.device_count() - 1)
    args = [torch.from_numpy(a).to(last) for a in _pairs(7, 4, 400, 128)]
    s_k, d_k = talign.banded_align(*args, band=128)
    s_p, d_p = talign.banded_align_batch(*args, band=128)
    assert s_k.device == last and torch.equal(s_k, s_p)
    assert torch.equal(d_k, d_p)
    ops_k, n_k = align_cuda.traceback_cuda(d_k, args[1], args[3], args[4],
                                           128, 400)
    ops_p, n_p = talign.traceback_device(d_k, args[1], args[3], args[4],
                                         128, 400)
    assert torch.equal(n_k, n_p) and torch.equal(ops_k, ops_p)


@pytest.mark.cuda
def test_nccl_group_of_one_on_card(cuda):
    """initialize(backend="nccl") at world size 1, an all_gather of a record
    payload through the card, shutdown."""
    import socket

    from focalsv_tpu_torch.io.vcf import VcfRecord
    from focalsv_tpu_torch.parallel import distributed, gather
    recs = [VcfRecord("chr1", 100 + i, f"r{i}", "A", "A" + "ACGT" * (3 + i),
                      ".", "PASS", {"SVTYPE": "INS", "SVLEN": 4 * (3 + i)},
                      "0/1") for i in range(5)]
    flat, lens = gather.encode_records(recs)
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    try:
        assert distributed.initialize(f"localhost:{port}", 1, 0,
                                      backend="nccl") == (0, 1)
        g_flat = gather._process_allgather(flat)
        g_lens = gather._process_allgather(lens)
        assert gather.allgather_records(recs) == recs
    finally:
        distributed.shutdown()
    assert distributed.world_size() == 1
    assert g_flat.shape == (1, flat.size) and g_lens.shape == (1, 5)
    back = gather.decode_records(g_flat[0], g_lens[0])
    assert [r.to_line() for r in back] == [r.to_line() for r in recs]


REGION_CASES = sorted(region_cases.CASES)


def _region_kernel_vs_plain(cuda, buf, args):
    """Kernel B2 through the region step's entry on the card, one launch,
    against the plain version on the card and on the CPU."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    dev = torch.from_numpy(buf).to(cuda)
    before = region_cuda.launches
    got = rs.phase_consensus_delta_flat(dev, **args)
    torch.cuda.synchronize()
    assert region_cuda.launches == before + 1
    want = rs.phase_consensus_delta_flat_plain(dev, **args)
    assert torch.equal(got, want)
    on_cpu = rs.phase_consensus_delta_flat(torch.from_numpy(buf), **args)
    assert torch.equal(got.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", REGION_CASES)
def test_region_kernel_matches_plain_on_card(cuda, name):
    _region_kernel_vs_plain(cuda, *region_cases.build(name))


@pytest.mark.cuda
@pytest.mark.parametrize("drle", ["bucket", "dense", "overflow"])
def test_region_kernel_on_hifi_chunk(cuda, drle):
    """The chunk of tests/test_torch_region_step.py::test_delta_chunk_hifi
    (N bases, a region in two blocks, one without het sites, a padded slot)
    under the RLE layout at its bucket, the dense layout and an RLE budget
    that overflows."""
    import dataclasses

    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.testing import simulate as sim
    cfg = preset("HIFI")

    def region(seed, **kw):
        args = dict(ref_len=7000, coverage=16, n_snps=8, read_len_mean=3000,
                    read_len_sd=500, sub_rate=0.001)
        args.update(kw)
        return sim.simulate_region(seed=seed, **args)

    rng = np.random.default_rng(1)
    with_n = region(8002)
    reads = []
    for r in with_n.reads:
        seq = np.array(r.seq, np.uint8)
        seq[rng.integers(0, len(seq), 6)] = 4
        reads.append(dataclasses.replace(r, seq=seq))
    with_n = dataclasses.replace(with_n, reads=reads)
    blocks = region(8003, ref_len=8000, coverage=20, n_snps=16,
                    read_len_mean=1500)
    L = len(blocks.ref)
    blocks = dataclasses.replace(blocks, reads=[
        r for r in blocks.reads
        if r.reference_end < 0.4 * L or r.pos > 0.6 * L])
    rgs = [region(8000), region(8001), with_n, blocks,
           region(8004, n_snps=0, svs=[])]
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg) for rg in rgs]
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    key = ("delta",) + tuple(max(k[i] for k in keys) for i in range(1, 5))
    G = len(tiles) + 1
    buf = dx.pack_chunk(tiles + [None], list(range(G)), key, G)
    _, R, L, Ds, Dd = key
    args = dict(G=G, R=R, L=L, Ds=Ds, Dd=Dd,
                Drle={"bucket": dx.drle_of(key), "dense": 0,
                      "overflow": 2}[drle],
                **rs.phase_consensus_kwargs(cfg.phasing))
    _region_kernel_vs_plain(cuda, buf, args)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("name", ["hifi_blocks", "hifi_overflow",
                                  "range_edges", "l262144"])
def test_region_kernel_at_each_cluster_size(cuda, monkeypatch, cluster,
                                            name):
    """B2 with 1, 2 and 4 CTAs a region (as many as the region has tiles)
    against its plain version: runs that cross a CTA's range, overflowing
    tracks, a long region."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    buf, args = region_cases.build(name)
    kw = {**rs.STEP_DEFAULTS, **args}
    plan = region_cuda.launch_plan(
        **{k: kw[k] for k in ("G", "R", "L", "Ds", "Dd", "Drle")},
        S=kw["max_sites"], cluster=cluster)
    assert plan["cluster"] == min(cluster, -(-kw["L"] // 4096))
    monkeypatch.setattr(region_cuda, "CLUSTER", cluster)
    _region_kernel_vs_plain(cuda, buf, args)


@pytest.mark.cuda
def test_named_card_runs_without_a_mesh(cuda, monkeypatch, tmp_path):
    """Device mode on a named card builds no mesh over the other cards,
    whatever their count, and writes the golden HIFI VCF on that card."""
    from pathlib import Path

    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import mesh as pmesh
    from focalsv_tpu_torch.pipeline import cli
    d = Path(__file__).resolve().parent / "data" / "golden" / "hifi"
    asked = []
    real = pmesh.mesh_for

    def spy(device, count, procs=1):
        mesh = real(device, count, procs)
        asked.append((str(device), count, procs, mesh))
        return mesh

    monkeypatch.setattr(pmesh, "mesh_for", spy)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cuda:0")
    before = region_cuda.launches
    rc = cli.main(["--bam_file", str(d / "reads.bam"), "--ref_file",
                   str(d / "ref.fa"), "--target_bed", str(d / "regions.bed"),
                   "--out_dir", str(tmp_path), "--data_type", "HIFI",
                   "--num_threads", "2", "--execution", "device"])
    assert rc == 0
    assert asked and all(a[0] == "cuda:0" and a[3] is None for a in asked)
    assert pmesh.mesh_for(torch.device("cuda:0"), 8) is None
    assert pmesh.mesh_for(torch.device("cuda"), 8).size == 8
    assert region_cuda.launches > before
    assert ((tmp_path / "FocalSV_Final_SV.vcf").read_text()
            == (d / "expected.vcf").read_text())


ROWS_CASES = sorted(region_cases.ROWS_CASES)


def _rows_kernel_vs_plain(cuda, buf, args):
    """Kernel B3 through the dense entry on the card, one launch, against
    the plain version on the card and on the CPU."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    dev = torch.from_numpy(buf).to(cuda)
    before = region_cuda.rows_launches
    got = rs.phase_consensus_rows_flat(dev, **args)
    torch.cuda.synchronize()
    assert region_cuda.rows_launches == before + 1
    want = rs.phase_consensus_rows_flat_plain(dev, **args)
    assert torch.equal(got, want)
    on_cpu = rs.phase_consensus_rows_flat(torch.from_numpy(buf), **args)
    assert torch.equal(got.cpu(), on_cpu)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ROWS_CASES)
def test_rows_kernel_matches_plain_on_card(cuda, name):
    _rows_kernel_vs_plain(cuda, *region_cases.build_rows(name))


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4])
@pytest.mark.parametrize("name", ["rows_symbols", "rows_tile_edges",
                                  "rows_r1024_s1024", "rows_g51"])
def test_rows_kernel_at_each_cluster_size(cuda, monkeypatch, cluster, name):
    """B3 with 1, 2 and 4 CTAs a region, each taking a share of both halves
    of the columns, against its plain version."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    buf, args = region_cases.build_rows(name)
    kw = {**rs.STEP_DEFAULTS, **args}
    plan = region_cuda.rows_launch_plan(
        **{k: kw[k] for k in ("G", "R", "L", "W")}, S=kw["max_sites"],
        cluster=cluster)
    assert plan["cluster"] == cluster
    monkeypatch.setattr(region_cuda, "CLUSTER", cluster)
    _rows_kernel_vs_plain(cuda, buf, args)


def _noisy_tiles(seeds, ref_len=15_000):
    """ONT tiles of noisy simulated regions (10 % substitutions, 3 %
    insertions, 3 % deletions, 30x): they take the dense encoding."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.pipeline import device_exec as dx
    from focalsv_tpu_torch.testing import simulate as sim
    cfg = preset("ONT")
    tiles = [dx.build_tile(rg.reads, rg.ref, 0, rg.chrom, cfg) for rg in (
        sim.simulate_region(seed=s, ref_len=ref_len, coverage=30.0,
                            n_snps=12, sub_rate=0.10, ins_rate=0.03,
                            del_rate=0.03) for s in seeds)]
    return cfg, tiles


@pytest.mark.cuda
def test_rows_dispatch_of_noisy_chunk_on_card(cuda):
    """dispatch_packed on a noisy dense chunk: one B3 launch, the CPU's
    bytes."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.pipeline import device_exec as dx
    cfg, tiles = _noisy_tiles((3000, 3004))
    keys = {dx._bucket_key(t, cfg) for t in tiles}
    assert len(keys) == 1 and next(iter(keys))[0] == "dense"
    key = keys.pop()
    G = dx._batch_size(key, cfg, 1)
    buf = dx.pack_chunk(tiles + [None], [0, 1] + [2] * (G - 2), key, G)
    before = region_cuda.rows_launches
    on_card = np.asarray(dx.dispatch_packed(buf, key, G, cfg, cuda))
    assert region_cuda.rows_launches == before + 1
    on_cpu = np.asarray(dx.dispatch_packed(buf, key, G, cfg,
                                           torch.device("cpu")))
    np.testing.assert_array_equal(on_card, on_cpu)


@pytest.mark.cuda
def test_rows_packed_entry_on_card_reaches_the_kernel(cuda):
    """phase_consensus_rows_packed with CUDA arrays packs them into one
    buffer there and launches B3 once; the plain version's bytes."""
    from focalsv_tpu_torch.ops import region_cuda
    from focalsv_tpu_torch.parallel import region_step as rs
    from focalsv_tpu_torch.parallel.wire import rows_flat_layout
    buf, args = region_cases.build_rows("rows_symbols")
    G, R, W = args["G"], args["R"], args["W"]
    lay = rows_flat_layout(G, R, W)
    dev = torch.from_numpy(buf).to(cuda)

    def sect(name):
        a, b = lay[name]
        return dev[a:b]

    before = region_cuda.rows_launches
    got = rs.phase_consensus_rows_packed(
        sect("rows").reshape(G, R, W // 2),
        sect("qstart").view(torch.int32).reshape(G, R),
        sect("rv").reshape(G, R) != 0, sect("ltrue").view(torch.int32),
        L=args["L"], W=W)
    torch.cuda.synchronize()
    assert region_cuda.rows_launches == before + 1
    assert torch.equal(got, rs.phase_consensus_rows_flat_plain(dev, **args))
