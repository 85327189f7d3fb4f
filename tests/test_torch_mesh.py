"""The port's mesh dispatch (focalsv_tpu_torch/parallel/mesh.py) against the
JAX package's on the virtual 8-device CPU mesh that tests/conftest.py sets
up: the same numpy inputs, made from a seed, through both.  Tolerance 0:
scores, direction bytes and candidate counts are integers.  The port's
meshes here are logical shards of the CPU; on CPU tensors its DP is the
plain version of kernel B1."""

from pathlib import Path

import numpy as np
import pytest
import torch

from focalsv_tpu.parallel import mesh as jmesh
from focalsv_tpu_torch.parallel import mesh as tmesh
from focalsv_tpu_torch.testing import dryrun

CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _mk_batch(B=8, LQ=256, LT=256, seed=0):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, (B, LT)).astype(np.uint8)
    q = t.copy()
    for b in range(B):                     # mismatches, a deletion, an insert
        i0 = int(rng.integers(20, LQ // 2))
        q[b, i0 : i0 + 5] = (q[b, i0 : i0 + 5] + 1) % 4
        if b % 3 == 1:
            q[b] = np.concatenate([np.delete(q[b], slice(i0 + 20, i0 + 29)),
                                   np.full(9, 5, np.uint8)])
        elif b % 3 == 2:
            q[b] = np.concatenate([q[b][:i0], rng.integers(0, 4, 7).astype(
                np.uint8), q[b][i0 : LQ - 7]])
    q_len = np.full(B, LQ - 32, np.int32)
    t_len = np.full(B, LT, np.int32)
    d_lo = ((t_len - q_len) // 2 - 64).astype(np.int32)
    return q, q_len, t, t_len, d_lo


def test_pad_batch_matches_jax():
    rng = np.random.default_rng(1)
    arrays = [rng.integers(0, 9, (5, 4)), rng.integers(0, 9, (5,))]
    got, n_got = tmesh.pad_batch_to_devices(arrays, 8)
    want, n_want = jmesh.pad_batch_to_devices(arrays, 8)
    assert n_got == n_want == 5 and got[0].shape == (8, 4)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    same, n = tmesh.pad_batch_to_devices(arrays, 5)
    assert same is arrays and n == 5


def test_make_mesh():
    m = tmesh.make_mesh(4)                 # the CPU was asked for: 4 shards
    assert m.size == 4 and m.devices == (CPU,) * 4
    assert m == tmesh.make_mesh(devices=["cpu"] * 4)
    assert hash(m) == hash(tmesh.make_mesh(4)) and m != tmesh.make_mesh(2)
    assert m.stream(0) is None
    with pytest.raises(ValueError):
        tmesh.make_mesh(3, devices=[CPU, CPU])
    with pytest.raises(ValueError):
        tmesh.Mesh([])
    with pytest.raises(ValueError, match="does not split"):
        tmesh.split_batch([np.zeros((5, 2))], 2)


def test_make_mesh_refuses_more_cards_than_present(monkeypatch):
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cuda")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    assert tmesh.make_mesh().devices == (torch.device("cuda", 0),
                                         torch.device("cuda", 1))
    assert tmesh.make_mesh(1).size == 1
    with pytest.raises(RuntimeError, match="3 cards"):
        tmesh.make_mesh(3)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_banded_align_matches_jax(n_shards):
    from focalsv_tpu_torch.ops.align import banded_align_batch
    args = _mk_batch()
    s_j, d_j = jmesh.sharded_banded_align(*args, mesh=jmesh.make_mesh(),
                                          band=128)
    mesh = tmesh.make_mesh(n_shards)
    s_t, d_t = tmesh.sharded_banded_align(*args, mesh=mesh, band=128)
    assert s_t.dtype == torch.int32 and d_t.dtype == torch.uint8
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    # and its unsharded twin
    s_l, d_l = banded_align_batch(*[torch.from_numpy(a) for a in args],
                                  band=128)
    assert torch.equal(s_t, s_l) and torch.equal(d_t, d_l)
    s_only, none = tmesh.sharded_banded_align(*args, mesh=mesh, band=128,
                                              store_dirs=False)
    assert none is None and torch.equal(s_only, s_l)


@pytest.mark.parametrize("n_shards", [2, 4])
def test_sv_candidate_step_matches_jax(n_shards):
    args = _mk_batch(B=16, seed=3)
    want = [np.asarray(x) for x in jmesh.sharded_sv_candidate_step(
        *args, mesh=jmesh.make_mesh())]
    mesh = tmesh.make_mesh(n_shards)
    scores, cand, global_cand = tmesh.sharded_sv_candidate_step(*args,
                                                                mesh=mesh)
    assert cand.shape == (16, 3) and cand.dtype == torch.int32
    np.testing.assert_array_equal(scores.numpy(), want[0])
    np.testing.assert_array_equal(cand.numpy(), want[1])
    assert len(global_cand) == n_shards   # every shard holds the whole table
    for copy in global_cand:
        np.testing.assert_array_equal(copy.numpy(), want[2])
    assert (want[1][:, 1:] > 0).any()      # the counts are exercised


def test_entry_point_matches_jax():
    import importlib.util
    from pathlib import Path
    spec = importlib.util.spec_from_file_location(
        "graft_entry", Path(__file__).resolve().parent.parent
        / "__graft_entry__.py")
    g = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(g)
    jfn, jargs = g.entry()
    tfn, targs = dryrun.entry()
    for a, b in zip(targs, jargs):
        assert a.device == CPU
        np.testing.assert_array_equal(a.numpy(), b)
    s_t, d_t = tfn(*targs)
    s_j, d_j = jfn(*jargs)
    assert s_t.shape == (8,)
    np.testing.assert_array_equal(s_t.numpy(), np.asarray(s_j))
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))


@pytest.mark.parametrize("devices", [None, [CPU, CPU]])
def test_dryrun_multichip(devices, capsys):
    dryrun.dryrun_multichip(2, devices=devices)
    assert "dryrun sharded dispatch" in capsys.readouterr().out


@pytest.mark.parametrize("device,count,procs,shards", [
    ("cuda", 4, 1, 4),         # one process on the unnamed card: every card
    ("cuda", 2, 1, 2),
    ("cuda:1", 4, 1, 0),       # a named card stays on its card
    ("cuda:0", 2, 1, 0),
    ("cuda", 4, 2, 0),         # a rank of a group of two stays on its card
    ("cuda", 1, 1, 0),         # one card: no mesh
    ("cpu", 4, 1, 0),
])
def test_mesh_for_follows_the_device_asked_for(device, count, procs, shards):
    mesh = tmesh.mesh_for(torch.device(device), count, procs)
    if shards == 0:
        assert mesh is None
    else:
        assert mesh.devices == tuple(torch.device("cuda", i)
                                     for i in range(shards))


def test_process_chromosome_hands_its_process_count_to_the_mesh_choice(
        monkeypatch):
    """run_target_mode's process_count reaches the mesh choice of device
    mode: a rank of a group of two asks mesh_for with 2."""
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.io.fasta import FastaFile
    from focalsv_tpu_torch.pipeline import main
    from focalsv_tpu_torch.io.bed import Region
    seen = []

    def run_regions(*args, mesh=None, process_count=1):
        seen.append((mesh, process_count))
        return []

    monkeypatch.setattr(main, "_run_regions_device", run_regions)
    fasta = FastaFile.load(str(Path(__file__).resolve().parent / "data" /
                               "golden" / "hifi" / "ref.fa"))
    cfg = preset("HIFI")
    for procs in (1, 2):
        main.process_chromosome(None, fasta, "chr21",
                                [Region("chr21", 10000, 26000)], cfg,
                                refine=False, process_count=procs)
    assert seen == [(None, 1), (None, 2)]
