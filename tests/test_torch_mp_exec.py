"""The port's multi-process region executor
(focalsv_tpu_torch/pipeline/mp_exec.py) against the single-process device
path of both packages: the same per-region BAM and reference files give the
same records (tolerance 0), on a second pass of the warm executor too; the
children never initialise CUDA; a child that fails raises in the parent."""

import numpy as np
import pytest
import torch

from focalsv_tpu.config import preset
from focalsv_tpu.io.bam import BamReader
from focalsv_tpu.pipeline import device_exec as jdx
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.config import preset as tpreset
from focalsv_tpu_torch.io.bam import BamReader as TBamReader
from focalsv_tpu_torch.pipeline import device_exec as tdx
from focalsv_tpu_torch.pipeline.mp_exec import MpRegionExecutor


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("OMP_NUM_THREADS", "1")      # the children inherit it


def _jobs(tmp_path, n=6):
    jobs = []
    for i in range(n):
        r = sim.simulate_region(seed=600 + i, ref_len=12_000, coverage=18,
                                n_snps=14,
                                svs=[sim.SimSV("DEL", 6_000, 80 + 10 * i,
                                               "0/1")])
        bam = str(tmp_path / f"r{i}.bam")
        ref = str(tmp_path / f"r{i}.npy")
        sim.write_region_bam(r, bam)
        np.save(ref, r.ref)
        jobs.append((bam, ref, "chr21"))
    return jobs


def _keys(res):
    return [(r.pos, r.ref, r.alt, r.gt) for r in res.records]


def test_mp_executor_matches_single_process_of_both_packages(tmp_path):
    jobs = _jobs(tmp_path)
    cfg_j, cfg_t = preset("HIFI"), tpreset("HIFI")
    want_jax, want_port = [], []
    for bam, ref, chrom in jobs:
        tile = jdx.build_tile(list(BamReader(bam)), np.load(ref), 0, chrom,
                              cfg_j)
        dev = jdx.run_device_step([tile], cfg_j)
        want_jax.append(_keys(jdx.process_region_device(tile, dev.get(0),
                                                        cfg_j)))
        tile = tdx.build_tile(list(TBamReader(bam)), np.load(ref), 0, chrom,
                              cfg_t)
        dev = tdx.run_device_step([tile], cfg_t)
        want_port.append(_keys(tdx.process_region_device(tile, dev.get(0),
                                                         cfg_t)))
    assert want_port == want_jax and any(want_port)

    with MpRegionExecutor(cfg_t, n_children=2) as ex:
        assert ex.device.type == "cpu"
        for _pass in range(2):
            stats = {}
            out = ex.run(jobs, collect="records", stats=stats)
            assert [_keys(res) for _n, res in out] == want_port
            assert [n for n, _res in out] == [len(k) for k in want_port]
            assert stats["n_chunks"] > 0 and stats["n_host_fallback"] == 0
            assert stats["cuda_initialized"] == 0
            assert stats["tile_build_s"] > 0 and stats["finish_s"] > 0
        counts = ex.run(jobs[:3], collect="count")
        assert [n for n, _ in counts] == [len(k) for k in want_port[:3]]
        assert all(res is None for _, res in counts)
    assert not any(p.is_alive() for p in ex.procs)


def test_failing_child_raises_in_the_parent(tmp_path):
    """A child's exception reaches the parent with its traceback."""
    jobs = _jobs(tmp_path, n=2)
    jobs.append((str(tmp_path / "missing.bam"), jobs[0][1], "chr21"))
    with MpRegionExecutor(tpreset("HIFI"), n_children=2) as ex:
        with pytest.raises(RuntimeError, match="mp child 0 failed") as info:
            ex.run(jobs)
        assert "missing.bam" in str(info.value)
        assert "Traceback" in str(info.value)


def test_dead_child_raises_in_the_parent(tmp_path):
    """A child that dies without a word (a native crash, a kill) is seen."""
    jobs = _jobs(tmp_path, n=2)
    with MpRegionExecutor(tpreset("HIFI"), n_children=2) as ex:
        ex.procs[1].kill()
        ex.procs[1].join(timeout=10)
        with pytest.raises(RuntimeError, match="mp child 1 died"):
            ex.run(jobs)
