"""Kernel B6 (the pair-HMM forward pass, ``csrc/pairhmm.cu``) on the CPU, and
the pair-HMM target mode through both packages' entry point.

B6's own source, built for the CPU (``testing/host_kernel.py::pairhmm``: g++
with the stand-in CUDA headers, a lane a thread), against its plain version,
``pairhmm_forward_batch_plain``, on every case of
``testing/pairhmm_cases.py`` (reads past 128 bases in strips of 32 rows,
several pairs a warp, workspaces in shared memory and in scratch). Tolerance
1e-4 absolute, with -inf at the same places: the host build's expf and logf
are glibc's, the plain version's PyTorch's vectorised ones, and the two may
differ by some ulps (on the card, where both are libdevice's, the terms are
compared byte for byte: tests/test_torch_cuda.py). The plain version is held
to the JAX package's ``pairhmm_forward_batch`` at 1e-3 on the same cases
(float32 log and exp round differently in XLA and in PyTorch; the
reference's jit takes the gap costs only at their defaults, so the case with
other costs is left out there). ``run_target_mode`` with
``use_pairhmm=True`` in device execution writes the same VCF in both
packages."""

import dataclasses

import numpy as np
import pytest
import torch

import focalsv_tpu.io.bam as bamio
from focalsv_tpu.config import preset
from focalsv_tpu.io.fasta import write_fasta
from focalsv_tpu.ops import pairhmm as jhmm
from focalsv_tpu.pipeline import main as jmain
from focalsv_tpu.testing import simulate as sim
from focalsv_tpu_torch.config import config_from_reference
from focalsv_tpu_torch.io.vcf import read_vcf
from focalsv_tpu_torch.ops import pairhmm as thmm
from focalsv_tpu_torch.ops import pairhmm_cuda
from focalsv_tpu_torch.phasing import realign as trealign
from focalsv_tpu_torch.pipeline import main as tmain
from focalsv_tpu_torch.testing import pairhmm_cases

HOST_ATOL = 1e-4
JAX_ATOL = 1e-3


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


@pytest.mark.parametrize("name", sorted(pairhmm_cases.CASES))
def test_kernel_source_on_the_cpu_matches_plain(name):
    case = pairhmm_cases.build(name)
    got = pairhmm_cases.host(case)
    want = pairhmm_cases.plain(case, "cpu")
    d = pairhmm_cases.differences(got, want)
    assert d["same_inf"], d
    assert d["terms_err"] <= HOST_ATOL and d["out_err"] <= HOST_ATOL, d
    # the case must reach what it is named for
    out, terms = want
    if name != "end_inf":
        assert np.isfinite(out).sum() >= out.size // 2
    else:
        empty = case["read_lens"] == 0
        assert np.isneginf(out[:, empty]).all()
        # an end cell at -inf reads as LOG0 in its diagonal's term
        assert (terms[0][empty] == np.float32(thmm.LOG0)).all()


@pytest.mark.parametrize("name", sorted(set(pairhmm_cases.CASES) - {"gaps"}))
def test_plain_matches_jax_on_kernel_cases(name):
    case = pairhmm_cases.build(name)
    out, _ = pairhmm_cases.plain(case, "cpu")
    for h, (hap, hl) in enumerate(case["haps"]):
        want = np.asarray(jhmm.pairhmm_forward_batch(
            case["reads"], case["read_lens"], hap, hl, case["quals"],
            max_read=case["max_read"], max_hap=hap.shape[1]))
        assert np.array_equal(np.isinf(out[h]), np.isinf(want))
        fin = np.isfinite(want)
        np.testing.assert_allclose(out[h][fin], want[fin], rtol=0,
                                   atol=JAX_ATOL)


def test_cpu_path_runs_the_plain_version():
    """On the CPU the forward pass is the plain version: one call for
    pairhmm_forward_batch, two for site_allele_loglik; B6 is not launched."""
    case = pairhmm_cases.build("realign")
    (ref, rhl), (alt, ahl) = case["haps"]
    args = (case["reads"], case["read_lens"])
    before, launched = thmm.plain_calls, pairhmm_cuda.launches
    one = thmm.pairhmm_forward_batch(*args, ref, rhl, case["quals"],
                                     max_read=29, max_hap=29)
    assert thmm.plain_calls == before + 1
    lr, la = thmm.site_allele_loglik(*args, ref, rhl, alt, ahl,
                                     case["quals"])
    assert thmm.plain_calls == before + 3
    assert pairhmm_cuda.launches == launched
    want, _ = pairhmm_cases.plain(case, "cpu")
    np.testing.assert_array_equal(one, want[0])
    np.testing.assert_array_equal(lr, want[0])
    np.testing.assert_array_equal(la, want[1])


def test_kernel_source_takes_any_width():
    """B6's source takes read windows past 128 bases: at 160 x 180 its
    workspaces sit in shared memory, at 300 x 320 in device scratch, and
    each case gives the same bytes with the workspaces moved to scratch
    (the stand-in card's shared memory shrunk to none)."""
    from focalsv_tpu_torch.testing import host_kernel
    for name, in_shared in (("wide_160x180", True), ("wide_300x320", False)):
        case = pairhmm_cases.build(name)
        B, M = case["reads"].shape
        widths = [hap.shape[1] for hap, _ in case["haps"]]
        assert M > 128 and case["read_lens"].max() > 128
        assert (host_kernel.pairhmm_scratch_bytes(B, M, widths) == 0) \
            == in_shared
        assert host_kernel.pairhmm_scratch_bytes(B, M, widths,
                                                 smem_bytes=0) > 0
        got = pairhmm_cases.host(case)
        moved = pairhmm_cases.host(case, smem_bytes=0)
        assert got[0].tobytes() == moved[0].tobytes()
        assert all(t.tobytes() == m.tobytes()
                   for t, m in zip(got[1], moved[1]))
        d = pairhmm_cases.differences(got, pairhmm_cases.plain(case, "cpu"))
        assert d["same_inf"], d
        assert d["terms_err"] <= HOST_ATOL and d["out_err"] <= HOST_ATOL, d


@pytest.mark.parametrize("pairs_per_warp", [1, 2, 4])
def test_kernel_source_counts_its_lane_steps(pairs_per_warp):
    """The lane-steps that B6's source adds to its counter (32 times each
    warp's steps) are those that ``pairhmm_cases.lane_steps`` reckons from
    the windows: on reads of one strip and of several, with out-of-range
    lengths, at this many pairs a warp."""
    for name in ("realign", "odd_lens", "end_inf", "wide_95x96"):
        case = dict(pairhmm_cases.build(name), pairs_per_warp=pairs_per_warp)
        counted = torch.zeros(1, dtype=torch.int64)
        pairhmm_cases.host(case, lane_steps=counted)
        widths = [hap.shape[1] for hap, _ in case["haps"]]
        want = pairhmm_cases.lane_steps(
            case["read_lens"], [hl for _, hl in case["haps"]],
            case["max_read"], widths, pairs_per_warp)
        assert want > 0 and int(counted[0]) == want, name


def test_emission_table_equals_elementwise():
    """B6's emission table, indexed by the quality clamped to [0, 255]
    (``qual_bytes``), gives the bytes of the plain version's elementwise
    emissions for every int32 quality in [-50, 400)."""
    rng = np.random.default_rng(4)
    q = rng.integers(-50, 400, (997, 29)).astype(np.int32)
    q[0, :] = np.arange(-50, -21)
    q.ravel()[29: 29 + 450] = np.arange(-50, 400)
    dev = torch.device("cpu")
    lm_match, lm_mis = thmm._emissions(q, *q.shape, dev)
    table = thmm.emission_table(dev)
    assert table.shape == (2, 256) and table.dtype == torch.float32
    assert thmm.emission_table(dev) is table          # built once
    idx = torch.from_numpy(thmm.qual_bytes(q, *q.shape).astype(np.int64))
    assert table[0][idx].numpy().tobytes() == lm_match.numpy().tobytes()
    assert table[1][idx].numpy().tobytes() == lm_mis.numpy().tobytes()


def test_wrapper_refuses_cpu_tensors():
    """B6's wrapper launches for CUDA tensors only; it never falls back."""
    B, M = 4, 29
    reads = torch.zeros((B, M), dtype=torch.uint8)
    lens = torch.full((B,), M, dtype=torch.int32)
    table = thmm.emission_table("cpu")
    with pytest.raises(ValueError, match="CUDA tensors"):
        pairhmm_cuda.pairhmm_cuda(reads, lens, None, table, [(reads, lens)],
                                  [0.0] * 5)


def _write_inputs(tmp_path, regions):
    """The regions end to end on one chromosome: BAM, FASTA and a BED."""
    offs = np.cumsum([0] + [len(rg.ref) for rg in regions])
    ref = np.concatenate([rg.ref for rg in regions])
    bam = str(tmp_path / "reads.bam")
    recs = sorted((dataclasses.replace(r, pos=r.pos + int(offs[i]))
                   for i, rg in enumerate(regions) for r in rg.reads),
                  key=lambda r: r.pos)
    w = bamio.BamWriter(bam, ["chr21"], [len(ref)])
    for rec in recs:
        w.write(rec)
    w.close()
    bamio.build_bai(bam)
    fasta = str(tmp_path / "ref.fa")
    write_fasta(fasta, [("chr21", ref)])
    bed = tmp_path / "t.bed"
    bed.write_text("".join(f"chr21\t{offs[i] + 100}\t{offs[i + 1] - 100}\n"
                           for i in range(len(regions))))
    return bam, fasta, str(bed)


def test_target_mode_with_pairhmm_matches_jax(tmp_path, monkeypatch):
    """run_target_mode with use_pairhmm=True in device execution, two
    regions: every tile takes the host phasing path, which realigns the
    allele matrix; the port's VCF equals the JAX package's."""
    ins = sim.random_seq(np.random.default_rng(22), 200)
    regions = [sim.simulate_region(seed=21, ref_len=12_000, coverage=16,
                                   n_snps=12,
                                   svs=[sim.SimSV("DEL", 6_000, 120, "0/1")]),
               sim.simulate_region(seed=22, ref_len=9_000, coverage=16,
                                   n_snps=10,
                                   svs=[sim.SimSV("INS", 4_000, 200, "0/1",
                                                  seq=ins)])]
    bam, fasta, bed = _write_inputs(tmp_path, regions)
    cfg = preset("HIFI")
    cfg = cfg.replace(
        phasing=dataclasses.replace(cfg.phasing, use_pairhmm=True),
        execution=dataclasses.replace(cfg.execution, mode="device"))
    calls = []
    real = trealign.site_allele_loglik

    def counted(*a, **k):
        calls.append(len(a[0]))
        return real(*a, **k)

    monkeypatch.setattr(trealign, "site_allele_loglik", counted)
    want = jmain.run_target_mode(bam, fasta, str(tmp_path / "jax"), cfg,
                                 target_bed=bed, num_workers=1)
    got = tmain.run_target_mode(bam, fasta, str(tmp_path / "torch"),
                                config_from_reference(dataclasses.asdict(cfg)),
                                target_bed=bed, num_workers=1)
    assert len(calls) >= 2 and min(calls) > 50
    _, want_recs = read_vcf(want)
    _, got_recs = read_vcf(got)
    assert [r.to_line() for r in got_recs] == [r.to_line() for r in want_recs]
    assert {r.info["SVTYPE"] for r in got_recs} == {"DEL", "INS"}
