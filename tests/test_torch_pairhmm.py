"""The port's pair-HMM (focalsv_tpu_torch/ops/pairhmm.py) and realignment
(phasing/realign.py) against the JAX package's on the same numpy inputs.

Tolerance: float32 log and exp round differently in XLA and in PyTorch, so
log-likelihoods agree to 1e-3 absolute.  The allele matrix compares
likelihood differences with a threshold, so it is equal wherever no
difference lies within 1e-2 of the threshold; the tests assert that none
does on their inputs, so that a near-tie would be reported, not hidden."""

import dataclasses

import numpy as np
import pytest
import torch

from focalsv_tpu.config import preset
from focalsv_tpu.ops import pairhmm as jhmm
from focalsv_tpu.phasing import phase as jphase
from focalsv_tpu.phasing import realign as jrealign
from focalsv_tpu.pipeline import region as jregion
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.config import config_from_reference
from focalsv_tpu_torch.ops import pairhmm as thmm
from focalsv_tpu_torch.phasing import phase as tphase
from focalsv_tpu_torch.phasing import realign as trealign
from focalsv_tpu_torch.pipeline import region as tregion
from focalsv_tpu_torch.testing import simulate as tsim

LL_ATOL = 1e-3
MIN_LR = 1.0          # realign_allele_matrix's default threshold
TIE_MARGIN = 1e-2


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _windows(seed, B=48, L=29):
    """Read windows against haplotype windows: exact, one substitution, a
    one-base deletion, N bases, low qualities, short and empty reads."""
    rng = np.random.default_rng(seed)
    reads = np.full((B, L), 5, np.uint8)
    haps = np.full((B, L), 5, np.uint8)
    quals = np.full((B, L), 30, np.int32)
    rl = np.zeros(B, np.int32)
    hl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(12, L + 1))
        hap = rng.integers(0, 4, n).astype(np.uint8)
        read = hap[2 : n - 2].copy()
        kind = b % 6
        if kind == 1:
            read[len(read) // 2] = (read[len(read) // 2] + 1) % 4
        elif kind == 2:
            read = np.delete(read, len(read) // 3)
        elif kind == 3:
            read[int(rng.integers(0, len(read)))] = 4
        elif kind == 4:
            quals[b] = rng.integers(2, 41, L)
        elif kind == 5:
            read = read[: int(rng.integers(0, 4))]
        reads[b, : len(read)] = read
        haps[b, :n] = hap
        rl[b], hl[b] = len(read), n
    return reads, rl, haps, hl, quals


@pytest.mark.parametrize("with_quals", [False, True], ids=["q30", "quals"])
@pytest.mark.parametrize("seed", range(3))
def test_forward_matches_jax(seed, with_quals):
    reads, rl, haps, hl, quals = _windows(seed)
    q = quals if with_quals else None
    want = np.asarray(jhmm.pairhmm_forward_batch(reads, rl, haps, hl, q,
                                                 max_read=29, max_hap=29))
    got = thmm.pairhmm_forward_batch(reads, rl, haps, hl, q, max_read=29,
                                     max_hap=29)
    assert got.dtype == np.float32 and got.shape == want.shape
    live = rl > 0
    assert live.sum() >= 40 and np.isfinite(want[live]).all()
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=LL_ATOL)
    # an empty read has no end cell: both give the same non-finite value
    np.testing.assert_array_equal(got[~live], want[~live])


def test_forward_longer_haplotype_windows():
    reads, rl, haps, hl, _ = _windows(11, B=16, L=20)
    haps = np.concatenate([haps, np.full((16, 12), 5, np.uint8)], 1)
    # (the reference's jit takes the gap costs only at their defaults)
    kw = dict(max_read=20, max_hap=32)
    want = np.asarray(jhmm.pairhmm_forward_batch(reads, rl, haps, hl, **kw))
    got = thmm.pairhmm_forward_batch(reads, rl, haps, hl, **kw)
    live = rl > 0
    np.testing.assert_allclose(got[live], want[live], rtol=0, atol=LL_ATOL)


def test_site_allele_loglik_matches_jax():
    reads, rl, haps, hl, quals = _windows(5, B=24)
    alt = haps.copy()
    alt[:, 8] = (alt[:, 8] + 1) % 4
    want = jhmm.site_allele_loglik(reads, rl, haps, hl, alt, hl, quals)
    got = thmm.site_allele_loglik(reads, rl, haps, hl, alt, hl, quals)
    live = rl > 0
    for g, w in zip(got, want):
        np.testing.assert_allclose(g[live], w[live], rtol=0, atol=LL_ATOL)


def _region(seed):
    kw = dict(seed=seed, ref_len=9000, coverage=14, n_snps=10,
              read_len_mean=3000, read_len_sd=400)
    return sim.simulate_region(**kw), tsim.simulate_region(**kw)


@pytest.mark.parametrize("seed", [5, 6])
def test_realign_allele_matrix_equal(seed, monkeypatch):
    rg_j, rg_t = _region(seed)
    cfg = preset("HIFI").phasing
    mat = jphase.pileup_matrix(rg_j.reads, 0, len(rg_j.ref))
    sites_j = jphase.find_het_sites(mat, rg_j.ref, cfg)
    base = (sites_j.allele0 <= 3) & (sites_j.allele1 <= 3)
    assert base.sum() >= 5
    sites_j = jphase.HetSites(sites_j.positions[base], sites_j.allele0[base],
                              sites_j.allele1[base])
    sites_t = tphase.HetSites(sites_j.positions, sites_j.allele0,
                              sites_j.allele1)
    # no likelihood difference near the threshold, so that equality of the
    # two matrices does not hang on float32 rounding
    seen = []
    orig = jrealign.site_allele_loglik

    def spy(*a, **k):
        lr, la = orig(*a, **k)
        seen.append(np.abs(np.abs(lr - la) - MIN_LR).min())
        return lr, la

    monkeypatch.setattr(jrealign, "site_allele_loglik", spy)
    want = jrealign.realign_allele_matrix(rg_j.reads, sites_j, rg_j.ref, 0)
    got = trealign.realign_allele_matrix(rg_t.reads, sites_t, rg_t.ref, 0)
    assert seen and min(seen) > TIE_MARGIN, "a near-tie: choose another seed"
    np.testing.assert_array_equal(got, want)
    assert (want >= 0).sum() > 50


def test_read_offsets_at_equal():
    rg_j, rg_t = _region(7)
    pos = np.arange(100, 8000, 397, dtype=np.int64)
    for rj, rt in list(zip(rg_j.reads, rg_t.reads))[:10]:
        np.testing.assert_array_equal(trealign.read_offsets_at(rt, pos),
                                      jrealign.read_offsets_at(rj, pos))


def test_host_region_with_pairhmm_matches_jax():
    """PhasingConfig.use_pairhmm in host execution: phase_region realigns
    the allele matrix; the port's records equal the JAX package's."""
    kw = dict(seed=21, ref_len=12_000, coverage=16, n_snps=12,
              svs=[sim.SimSV("DEL", 6_000, 120, "0/1")])
    rg_j = sim.simulate_region(**kw)
    kw["svs"] = [tsim.SimSV("DEL", 6_000, 120, "0/1")]
    rg_t = tsim.simulate_region(**kw)
    cfg_j = preset("HIFI")
    cfg_j = cfg_j.replace(phasing=dataclasses.replace(cfg_j.phasing,
                                                      use_pairhmm=True))
    cfg_t = config_from_reference(dataclasses.asdict(cfg_j))
    assert cfg_t.phasing.use_pairhmm
    res_j = jregion.process_region(rg_j.reads, rg_j.ref, 0, "chr21", cfg_j)
    res_t = tregion.process_region(rg_t.reads, rg_t.ref, 0, "chr21", cfg_t)
    want = [(r.pos, r.ref, r.alt, r.gt) for r in res_j.records]
    got = [(r.pos, r.ref, r.alt, r.gt) for r in res_t.records]
    assert got == want and got
    np.testing.assert_array_equal(res_t.phase_hp, res_j.phase_hp)
    assert res_t.n_phased == res_j.n_phased > 0
