"""The port's evaluation tools and utilities (focalsv_tpu_torch/evaluation,
focalsv_tpu_torch/tools) against the JAX package's on the same seeded call
and truth sets: the protocol matcher, the threshold grid, the figure data,
the INS/DEL filter, the somatic merge, the clean-up and the call-set
converter.  Every output file and result is equal (tolerance 0: the tools
are integer and string work, and the one device function they reach,
``edit_similarity``, is an integer DP)."""

import csv
import dataclasses
import io
import json
import os
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

from focalsv_tpu.evaluation import cli as jcli
from focalsv_tpu.evaluation import compare as jcompare
from focalsv_tpu.evaluation import figdata as jfigdata
from focalsv_tpu.evaluation import grid as jgrid
from focalsv_tpu.evaluation import somatic as jsomatic
from focalsv_tpu.evaluation import vcf_filter as jfilter
from focalsv_tpu.io import vcf as jvcf
from focalsv_tpu.ops import align as jalign
from focalsv_tpu.testing import simulate as jsim
from focalsv_tpu.tools import callset_to_bed as jbed
from focalsv_tpu.tools import clean as jclean
from focalsv_tpu_torch.evaluation import cli as tcli
from focalsv_tpu_torch.evaluation import compare as tcompare
from focalsv_tpu_torch.evaluation import figdata as tfigdata
from focalsv_tpu_torch.evaluation import grid as tgrid
from focalsv_tpu_torch.evaluation import somatic as tsomatic
from focalsv_tpu_torch.evaluation import vcf_filter as tfilter
from focalsv_tpu_torch.io import vcf as tvcf
from focalsv_tpu_torch.ops import align as talign
from focalsv_tpu_torch.testing import simulate as tsim
from focalsv_tpu_torch.tools import callset_to_bed as tbed
from focalsv_tpu_torch.tools import clean as tclean

BASES = np.array(list("ACGT"))


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _callsets(seed, n=24):
    """(truth, calls) as plain tuples: DELs and INSs on three chromosomes
    (one of them chrX), calls shifted, resized, mutated, some missing, some
    spurious, some with the wrong genotype."""
    rng = np.random.default_rng(seed)

    def seq(k):
        return "".join(BASES[rng.integers(0, 4, k)])

    truth, calls = [], []
    for i in range(n):
        chrom = ("chr1", "chr2", "chrX")[i % 3]
        pos = 5_000 + 4_000 * i + int(rng.integers(0, 500))
        size = int(rng.integers(40, 900))
        gt = ("0/1", "1/1", "1|0")[int(rng.integers(0, 3))]
        if i % 2:
            ins = seq(size)
            truth.append((chrom, pos, f"t{i}", "A", "A" + ins, "INS", size,
                          gt))
            mutated = list(ins)
            for at in rng.integers(0, size, int(size * rng.random() * 0.5)):
                mutated[at] = "A"
            alt, svlen = "A" + "".join(mutated), size
        else:
            truth.append((chrom, pos, f"t{i}", "A" + seq(size), "A", "DEL",
                          -size, gt))
            svlen = -max(30, size + int(rng.integers(-60, 60)))
            alt = "A"
        if rng.random() < 0.15:
            continue                       # a false negative
        cgt = gt if rng.random() < 0.8 else "0/1"
        cpos = pos + int(rng.integers(-700, 700) if rng.random() < 0.3
                         else rng.integers(-40, 40))
        ref = "A" if svlen > 0 else "A" + seq(-svlen)
        calls.append((chrom, cpos, f"c{i}", ref, alt,
                      "INS" if svlen > 0 else "DEL", svlen, cgt))
    for i in range(4):                     # false positives
        calls.append(("chr1", 300_000 + 5_000 * i, f"fp{i}", "A",
                      "A" + seq(120), "INS", 120, "0/1"))
    return truth, calls


def _records(rows, mod):
    return [mod.VcfRecord(c, p, i, r, a, info={"SVTYPE": t, "SVLEN": n},
                          gt=g) for c, p, i, r, a, t, n, g in rows]


def _write(tmp_path, seed):
    truth, calls = _callsets(seed)
    tp, cp = str(tmp_path / "truth.vcf"), str(tmp_path / "calls.vcf")
    tvcf.write_vcf(tp, _records(truth, tvcf))
    tvcf.write_vcf(cp, _records(calls, tvcf))
    return cp, tp


def _tree(root):
    """Every file below root: relative path -> text with root's own path
    taken out."""
    out = {}
    for d, _, files in os.walk(root):
        for name in files:
            p = os.path.join(d, name)
            with open(p, "rb") as f:
                data = f.read()
            if not name.endswith(".png"):
                data = data.replace(str(root).encode(), b"<root>")
            out[os.path.relpath(p, root)] = data
    return out


def _both(tmp_path, run):
    """run(cli, out_dir) for both packages; (stdout, file tree) of each."""
    got = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        out = tmp_path / name
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert run(cli, str(out)) == 0
        got[name] = (buf.getvalue().replace(str(out), "<root>"), _tree(out))
    return got["torch"], got["jax"]


@pytest.mark.parametrize("kw", [{}, dict(refdist=1000, pctsim=0.0),
                                dict(pctsize=0.9, sizemin=100),
                                dict(check_seq=False, pctovl=0.5)],
                         ids=["default", "loose", "strict", "noseq"])
@pytest.mark.parametrize("seed", range(2))
def test_match_records_equal(seed, kw):
    truth, calls = _callsets(seed)
    b_t = tcompare.match_records(_records(calls, tvcf), _records(truth, tvcf),
                                 **kw)
    b_j = jcompare.match_records(_records(calls, jvcf), _records(truth, jvcf),
                                 **kw)
    assert dataclasses.asdict(b_t) == dataclasses.asdict(b_j)
    assert (b_t.recall, b_t.precision, b_t.f1, b_t.gt_concordance) == (
        b_j.recall, b_j.precision, b_j.f1, b_j.gt_concordance)
    assert b_t.tp > 0 and b_t.fp > 0 and b_t.fn > 0


def test_edit_similarity_device_route_equal(monkeypatch):
    """Past the native size cap compare.py's similarity runs the score-only
    banded DP (kernel B1's plain version here)."""
    truth, _ = _callsets(3)
    seqs = [r[4][1:] for r in truth if r[5] == "INS"][:4]
    monkeypatch.setattr(jalign, "NATIVE_DP_MAX_CELLS", 0)
    monkeypatch.setattr(talign, "NATIVE_DP_MAX_CELLS", 0)
    from focalsv_tpu.ops import encode as jenc
    from focalsv_tpu_torch.ops import encode as tenc
    for a, b in zip(seqs, seqs[1:]):
        assert (talign.edit_similarity(tenc.encode(a), tenc.encode(b))
                == jalign.edit_similarity(jenc.encode(a), jenc.encode(b)))


def test_truth_from_sim_equal():
    kw = dict(seed=9, ref_len=20_000, coverage=4, n_snps=4)
    rg_j, rg_t = jsim.simulate_region(**kw), tsim.simulate_region(**kw)
    rec_j = jcompare.truth_from_sim(rg_j.svs, "chr21", rg_j.ref, 100)
    rec_t = tcompare.truth_from_sim(rg_t.svs, "chr21", rg_t.ref, 100)
    assert [dataclasses.astuple(r) for r in rec_t] == [
        dataclasses.astuple(r) for r in rec_j] and rec_t


@pytest.mark.parametrize("seed", range(2))
def test_cli_bench_equal(tmp_path, seed):
    cp, tp = _write(tmp_path, seed)
    (out_t, _), (out_j, _) = _both(
        tmp_path, lambda cli, out: cli.main(["bench", "--call", cp,
                                             "--truth", tp]))
    assert out_t == out_j
    assert json.loads(out_t)["INS"]["tp"] > 0
    (old_t, _), (old_j, _) = _both(
        tmp_path, lambda cli, out: cli.main(["--call", cp, "--truth", tp]))
    assert old_t == old_j == out_t


def test_cli_protocol_and_filter_equal(tmp_path):
    cp, tp = _write(tmp_path, 4)
    t, j = _both(tmp_path, lambda cli, out: cli.main(
        ["protocol", "--call", cp, "--truth", tp, "--out_dir", out]))
    assert t == j
    assert "Truvari_results.csv" in t[1]
    t, j = _both(tmp_path, lambda cli, out: cli.main(
        ["filter", "--vcf", cp, "--out_dir", os.path.join(out, "f")]))
    assert t == j
    paths_t = tfilter.filter_vcf(cp, str(tmp_path / "ft"))
    paths_j = jfilter.filter_vcf(cp, str(tmp_path / "fj"))
    assert sorted(paths_t) == sorted(paths_j) == ["DEL", "INS", "both"]
    for k in paths_t:
        with open(paths_t[k]) as ft, open(paths_j[k]) as fj:
            text = ft.read()
            assert text == fj.read() and "chrX" not in text


def test_grid_equal(tmp_path):
    cp, tp = _write(tmp_path, 5)
    kw = dict(pctsims=(0.0, 0.5, 0.9), refdists=(100, 500, 1000))
    g_t = tgrid.run_grid(cp, tp, str(tmp_path / "gt"), **kw)
    g_j = jgrid.run_grid(cp, tp, str(tmp_path / "gj"), **kw)
    assert g_t == g_j and set(g_t) == {"DEL", "INS"}
    assert _tree(tmp_path / "gt") == _tree(tmp_path / "gj")
    assert len({v for v in g_t["INS"].values()}) > 1
    t, j = _both(tmp_path, lambda cli, out: cli.main(
        ["grid", "--call", cp, "--truth", tp, "--out_dir", out,
         "--refdists", "100,500", "--pctsims", "0.0,0.5"]))
    assert t == j
    t, j = _both(tmp_path, lambda cli, out: cli.main(
        ["protocol", "--call", cp, "--truth", tp, "--out_dir", out]))
    rows_t = tgrid.f1_summary_rows({"port": str(tmp_path / "torch")})
    assert rows_t == jgrid.f1_summary_rows({"port": str(tmp_path / "jax")})
    assert len(rows_t) == 3


def test_figdata_equal(tmp_path):
    truth, calls = _callsets(6)
    rows_t = tfigdata.match_detail_rows(_records(calls, tvcf),
                                        _records(truth, tvcf))
    rows_j = jfigdata.match_detail_rows(_records(calls, jvcf),
                                        _records(truth, jvcf))
    assert rows_t == rows_j and len(rows_t) > 5
    cp, tp = _write(tmp_path, 6)
    t, j = _both(tmp_path, lambda cli, out: cli.main(
        ["figdata", "--call", cp, "--truth", tp, "--out_dir", out]))
    assert t == j
    with open(tmp_path / "torch" / "tp_match_details.csv") as f:
        assert len(list(csv.DictReader(f))) == len(rows_t)


def test_phasing_stats_equal():
    kw = dict(seed=12, ref_len=15_000, coverage=12, n_snps=12)
    rg_j, rg_t = jsim.simulate_region(**kw), tsim.simulate_region(**kw)
    rng = np.random.default_rng(0)
    hap = np.array(rg_j.read_hap)
    hp = np.where(rng.random(len(hap)) < 0.85, hap + 1, 0)
    hp[:3] = 3 - np.maximum(hp[:3], 1)            # a few switch errors
    ps = np.where(hp > 0, 1 + (np.arange(len(hp)) % 2), 0)
    truth = {r.name: int(h) + 1 for r, h in zip(rg_j.reads, hap)}
    s_t = tfigdata.phasing_stats(rg_t.reads, hp, ps, lambda r: truth[r.name])
    s_j = jfigdata.phasing_stats(rg_j.reads, hp, ps, lambda r: truth[r.name])
    assert s_t == s_j and s_t["phased_frac"] > 0.5
    assert s_t["switch_errors"] > 0 and s_t["n_blocks"] == 2


def _sv(mod, chrom, pos, svtype, svlen, end=None, filt="PASS"):
    info = {"SVTYPE": svtype, "SVLEN": svlen}
    if end is not None:
        info["END"] = end
    return mod.VcfRecord(chrom, pos, "x", "N", f"<{svtype}>", ".", filt,
                         info, "0/1")


def _somatic_sets(mod, seed):
    rng = np.random.default_rng(seed)
    normal, tumor = [], []
    for i in range(30):
        chrom = f"chr{1 + i % 3}"
        pos = 10_000 * (i + 1)
        svtype = ("INV", "DUP", "TRA", "INS")[i % 4]
        size = 0 if svtype == "TRA" else int(rng.integers(100, 8_000))
        end = None if svtype in ("TRA", "INS") else pos + size
        kind = int(rng.integers(0, 4))
        if kind in (0, 1):
            normal.append(_sv(mod, chrom, pos, svtype, size, end))
        if kind in (1, 2):
            shift = int(rng.integers(-1500, 1500))
            tumor.append(_sv(mod, chrom, pos + shift, svtype, size,
                             None if end is None else end + shift,
                             filt="PASS" if rng.random() < 0.9 else "LowQual"))
    return normal, tumor


@pytest.mark.parametrize("seed", range(2))
def test_somatic_equal(tmp_path, seed):
    n_t, t_t = _somatic_sets(tvcf, seed)
    n_j, t_j = _somatic_sets(jvcf, seed)
    for kw in ({}, dict(pass_only=False)):
        s_t = tsomatic.somatic_call(n_t, t_t, **kw)
        s_j = jsomatic.somatic_call(n_j, t_j, **kw)
        assert [dataclasses.astuple(r) for r in s_t] == [
            dataclasses.astuple(r) for r in s_j]
    m_t = tsomatic.survivor_merge([n_t, t_t], max_dist=101)
    m_j = jsomatic.survivor_merge([n_j, t_j], max_dist=101)
    assert sorted(m.supp_vec for m in m_t) == sorted(m.supp_vec for m in m_j)
    assert {m.supp_vec for m in m_t} >= {"01", "10"}
    nv, tv = str(tmp_path / "n.vcf"), str(tmp_path / "t.vcf")
    tvcf.write_vcf(nv, n_t)
    tvcf.write_vcf(tv, t_t)
    outs = {}
    for name, mod in (("torch", tsomatic), ("jax", jsomatic)):
        out = str(tmp_path / f"{name}.vcf")
        with redirect_stdout(io.StringIO()):
            assert mod.main(["-n", nv, "-t", tv, "-o", out]) == 0
        with open(out) as f:
            outs[name] = f.read()
    assert outs["torch"] == outs["jax"] and "SUPP_VEC=01" in outs["torch"]


def test_callset_to_bed_equal(tmp_path):
    src = tmp_path / "calls.csv"
    src.write_text(
        ",chrom1,pos1,chrom2,pos2,svsize,svtype\n"
        "0,chr1,1000000,chr1,1200000,200000,DUP\n"
        "1,chr2,5000000,chr2,11000000,6000000,DUP\n"
        "\n"
        "2,chr3,2000000,chr3,2500000,500000,INV\n"
        "3,chr4,9000000,chr7,3000000,0,TRA\n"
        "short,row\n"
        "4,chrX,100000,chrX,200000,100000,DUP\n")
    outs = {}
    for name, mod in (("torch", tbed), ("jax", jbed)):
        out = tmp_path / f"{name}.bed"
        assert mod.main([str(src), str(out)]) == 0
        outs[name] = out.read_text()
    assert outs["torch"] == outs["jax"]
    assert "chr1\t950000\t1250000\tDUP" in outs["torch"]


def test_clean_equal(tmp_path):
    removed = {}
    for name, mod in (("torch", tclean), ("jax", jclean)):
        root = tmp_path / name
        rdir = root / "chr21" / "regions" / "Region_chr21_S0_E100"
        rdir.mkdir(parents=True)
        for fname in ("region.bam", "region_phased.bam", "HP1.fa",
                      "PS1_hp1.fa", "region.vcf", "notes.txt"):
            (rdir / fname).write_text("x")
        (root / "FocalSV_Final_SV.vcf").write_text("x")
        dry = mod.clean_out_dir(str(root), dry_run=True)
        assert all(os.path.exists(p) for p in dry)
        with redirect_stdout(io.StringIO()):
            assert mod.main(["--out_dir", str(root)]) == 0
        removed[name] = (sorted(os.path.relpath(p, root) for p in dry),
                         sorted(_tree(root)))
    assert removed["torch"] == removed["jax"]
    assert "FocalSV_Final_SV.vcf" in removed["torch"][1]


def test_figures_render(tmp_path):
    """The port's `eval figures` renders the same set of images from the
    same grid, figure data and protocol results."""
    cp, tp = _write(tmp_path, 7)
    names = {}
    for name, cli in (("torch", tcli), ("jax", jcli)):
        base = tmp_path / name
        grid_dir, proto = str(base / "grid"), str(base / "proto")
        with redirect_stdout(io.StringIO()):
            assert cli.main(["grid", "--call", cp, "--truth", tp, "--out_dir",
                             grid_dir, "--refdists", "100,500", "--pctsims",
                             "0.0,0.5"]) == 0
            assert cli.main(["figdata", "--call", cp, "--truth", tp,
                             "--out_dir", grid_dir]) == 0
            assert cli.main(["protocol", "--call", cp, "--truth", tp,
                             "--out_dir", proto]) == 0
        buf = io.StringIO()
        with redirect_stdout(buf):
            assert cli.main([
                "figures", "--out_dir", str(base / "figs"), "--grid-dir",
                grid_dir, "--details",
                os.path.join(grid_dir, "tp_match_details.csv"), "--f1",
                f"focalsv={proto}", "--target-tool", "focalsv"]) == 0
        written = json.loads(buf.getvalue())["written"]
        assert all(os.path.getsize(p) > 1000 for p in written)
        names[name] = sorted(os.path.basename(p) for p in written)
    assert names["torch"] == names["jax"] and len(names["torch"]) == 9
