"""The port's measurement modules (focalsv_tpu_torch/benches/) against the
repository's scripts on the same inputs, on the CPU: the same counts and
records, tolerance 0.

- bench: _make_jobs writes the same bytes; on 4 regions of 15 kb the port's
  host pass gives the records of bench.run_host_mode's regions, region for
  region, its device pass (the plain versions on the CPU) gives its host
  pass's records, and its JSON line has bench.py's keys; under worker
  processes (--mp) its records equal the host baseline's, region for
  region.
- bench_accuracy: make_case gives the script's reads, reference and truth
  for every class; the (dtype, case) rows equal the script's, seed for
  seed.
- bench_accuracy_complex: each type's row equals the script's.
- bench_auto: the same regions and records as bench_auto.py's calls.
- bench_scaling: the same region-step results at 1 and 2 logical shards as
  the JAX package's step, unsharded and sharded over two CPU devices.
"""

import contextlib
import dataclasses
import io
import json
import os
import tempfile

import numpy as np
import pytest
import torch

import bench as jbench
import bench_accuracy as jacc
import bench_accuracy_complex as jcplx
import bench_auto as jauto
from focalsv_tpu.config import preset as jpreset
from focalsv_tpu.io.bed import read_bed as jread_bed
from focalsv_tpu.io.vcf import read_vcf as jread_vcf
from focalsv_tpu.parallel import mesh as jmesh
from focalsv_tpu.parallel import region_step as jrs
from focalsv_tpu.pipeline import region as jregion
from focalsv_tpu.pipeline import device_exec as jdx
from focalsv_tpu.pipeline.main import run_auto_mode as jrun_auto_mode
from focalsv_tpu_torch.benches import (bench, bench_accuracy,
                                       bench_accuracy_complex, bench_auto,
                                       bench_scaling)
from focalsv_tpu_torch.config import preset

# bench.py's JSON keys (bench.py:391-399)
BENCH_KEYS = {"metric", "value", "unit", "vs_baseline", "device", "baseline",
              "cold_start_s"}


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _files_equal(a, b) -> bool:
    with open(a, "rb") as fa, open(b, "rb") as fb:
        return fa.read() == fb.read()


def _make_jobs(make, d, *args):
    os.makedirs(d)
    return make(str(d), *args)


@pytest.fixture(scope="module")
def jobs(tmp_path_factory):
    """4 regions of 15 kb at 30x, written by both packages' _make_jobs."""
    d = tmp_path_factory.mktemp("bench")
    return (_make_jobs(bench._make_jobs, d / "port", 4, 30.0, 15_000),
            _make_jobs(jbench._make_jobs, d / "jax", 4, 30.0, 15_000))


def test_bench_jobs_are_the_scripts_bytes(tmp_path):
    """The size mix (15, 30, 50 and 100 kb) at 4x: the same BAM, index and
    reference bytes."""
    mine = _make_jobs(bench._make_jobs, tmp_path / "port", 4, 4.0)
    theirs = _make_jobs(jbench._make_jobs, tmp_path / "jax", 4, 4.0)
    assert [os.path.basename(j[0]) for j in mine] == \
        [os.path.basename(j[0]) for j in theirs]
    for (bam, ref, chrom), (jbam, jref, jchrom) in zip(mine, theirs):
        assert chrom == jchrom
        assert _files_equal(bam, jbam)
        assert _files_equal(bam + ".bai", jbam + ".bai")
        assert np.array_equal(np.load(ref), np.load(jref))


def test_bench_passes_match_the_script(jobs, monkeypatch):
    """Host pass: the records of bench.run_host_mode's regions (the JAX
    package's process_region, each call's records kept by its reference
    window), region for region, and its count; device pass (plain versions
    on the CPU): the host pass's records, region for region."""
    mine, theirs = jobs
    seen = {}
    process_region = jregion.process_region

    def keep(reads, ref, *args, **kw):
        res = process_region(reads, ref, *args, **kw)
        seen[ref.tobytes()] = [(r.pos, r.ref, r.alt, r.gt)
                               for r in res.records]
        return res

    monkeypatch.setattr(jregion, "process_region", keep)
    _t, n_jax = jbench.run_host_mode(theirs, jpreset("HIFI"), 2, repeats=1)
    jax_keys = [seen[np.load(ref).tobytes()] for _bam, ref, _c in theirs]
    _t, n_host, host_keys = bench.run_host_mode(
        mine, preset("HIFI"), 2, repeats=1)
    assert n_host == n_jax > 0
    assert host_keys == jax_keys
    pass_s, n_dev, stats, dev_keys = bench.run_device_mode(
        mine, preset("HIFI"), 2, repeats=1)
    assert len(pass_s) == 1 and n_dev == n_host
    assert dev_keys == host_keys
    assert stats["n_host_fallback"] == 0 and stats["n_chunks"] > 0


def _bench_args(jobs, mp: int) -> list[str]:
    return ["--regions", "4", "--ref-len", "15000", "--mp", str(mp),
            "--repeats", "1", "--base-repeats", "1", "--workers", "2",
            "--jobs-dir", os.path.dirname(jobs[0][0][0])]


def test_bench_json_line_has_the_scripts_keys(jobs):
    """main() end to end on the CPU, the host baseline in its subprocess:
    one JSON line with bench.py's keys, device records equal to the host's,
    and the kernel's chunk reported as not measured (no card)."""
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = bench.main(_bench_args(jobs, 0))
    assert rc == 0, err.getvalue()
    lines = out.getvalue().splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert BENCH_KEYS <= set(line)
    assert line["metric"] == "regions_per_sec_per_chip"
    assert line["backend"] == "cpu" and line["records_equal"]
    assert line["records"] == line["baseline_records"] > 0
    assert "# kernel B2 at bucket" in err.getvalue()
    assert "not measured (no card)" in err.getvalue()


def test_bench_mp_records_are_the_hosts(jobs):
    """--mp 2 (two worker processes): records_equal holds each region's
    device records, from the untimed first pass, to the host baseline's,
    not only their count."""
    with contextlib.redirect_stderr(io.StringIO()):
        res = bench.run(bench.parse_args(_bench_args(jobs, 2)))
    line = res["json"]
    assert line["records_equal"]
    assert len(res["keys"]) == 4
    assert bench.records_digest(res["keys"]) == \
        res["baseline"]["records_digest"]
    assert line["records"] == sum(map(len, res["keys"])) == \
        line["baseline_records"] > 0
    assert res["stats"]["cuda_initialized"] == 0


@pytest.mark.parametrize("case", jacc.CASES)
def test_make_case_is_the_scripts(case):
    for dtype in ("HIFI", "CLR"):
        mine = bench_accuracy.make_case(4000, case,
                                        bench_accuracy.ERR_MODELS[dtype])
        theirs = jacc.make_case(4000, case, jacc.ERR_MODELS[dtype])
        assert np.array_equal(mine.ref, theirs.ref)
        assert [(r.name, r.pos, r.flag, r.cigar.tobytes(), r.seq.tobytes())
                for r in mine.reads] == \
            [(r.name, r.pos, r.flag, r.cigar.tobytes(), r.seq.tobytes())
             for r in theirs.reads]
        assert [(s.svtype, s.pos, s.length, s.genotype)
                for s in mine.svs] == \
            [(s.svtype, s.pos, s.length, s.genotype) for s in theirs.svs]


@pytest.mark.parametrize("dtype,case", [("HIFI", "basic"),
                                        ("CLR", "dropout")])
def test_accuracy_rows_are_the_scripts(dtype, case, capsys, monkeypatch):
    """The (dtype, case) row at 2 regions, one process: each seed's (tp,
    fp, fn, GT correct, GT total) equal to the script's, and their sums."""
    mine = {}
    child_run = bench_accuracy._child_run

    def keep(args):
        out = child_run(args)
        mine[args[0]] = out[:5]
        return out

    monkeypatch.setattr(bench_accuracy, "_child_run", keep)
    rows = bench_accuracy.main(["--regions", "2", "--dtypes", dtype,
                                "--cases", case, "--procs", "1"])
    theirs = []
    for seed in (4000, 4097):
        # what bench_accuracy._child_init sets, without its cache directory
        jacc._state.update(cfg=jpreset(dtype), dtype=dtype,
                           post_refine=False)
        theirs.append(jacc._child_run((seed, case, jacc.ERR_MODELS[dtype])))
    assert mine == {seed: tuple(r[:5])
                    for seed, r in zip((4000, 4097), theirs)}
    tp, fp, fn, gt_c, gt_t = (sum(r[i] for r in theirs) for i in range(5))
    assert tp + fn > 0
    for row in rows:
        assert (row["tp"], row["fp"], row["fn"]) == (tp, fp, fn), row
        assert row["gt_concordance"] == round(gt_c / max(gt_t, 1), 4)
        assert row["launches"] == dict(B1=0, B4=0, B2=0, B3=0, B6=0)
    assert [json.loads(ln) for ln in capsys.readouterr().out.splitlines()
            ] == rows


@pytest.mark.parametrize("i,name", list(enumerate(
    ("INV", "HETINV", "DUP", "TRA"))))
def test_complex_rows_are_the_scripts(i, name):
    """One trial of each type (and its SV-free control), seeds as the
    script's main gives them."""
    fns = {"INV": "_inv_trial", "HETINV": "_het_inv_trial",
           "DUP": "_dup_trial", "TRA": "_tra_trial"}
    seed0 = 37_000 + 1_000 * i
    mine = bench_accuracy_complex._run_type(
        name, getattr(bench_accuracy_complex, fns[name]), 1, 1000, seed0)
    theirs = jcplx._run_type(name, getattr(jcplx, fns[name]), 1, 1000, seed0)
    assert mine == theirs
    assert mine["tp"] == 1


def test_auto_regions_and_records_are_the_scripts(tmp_path):
    """bench_auto at 2 x 200 kb (its defaults otherwise): the port's run,
    as its main calls it (device execution, the plain versions on the
    CPU), against bench_auto.py's builder and the JAX package's
    run_auto_mode: the same detected regions and the same records.  The
    JAX run takes host execution, whose VCF the JAX package's own tests
    hold to device execution's, so that no XLA compile on the CPU counts
    into this test's time; step 0, which detects the regions, is the same
    in both."""
    args = bench_auto.parse_args(["--chroms", "2", "--chrom-len", "200000",
                                  "--workers", "2"])
    os.makedirs(tmp_path / "port")
    mine = bench_auto.run(args, str(tmp_path / "port"))
    assert mine["parity"][0] > 0 and mine["parity"][1] == 0
    os.makedirs(tmp_path / "jax")
    bam, ref, _truth = jauto.build_genome(str(tmp_path / "jax"), 2, 200_000,
                                          25.0, 6, "HIFI")
    cfg = jpreset("HIFI")
    cfg = cfg.replace(execution=dataclasses.replace(cfg.execution,
                                                    mode="host"))
    final = jrun_auto_mode(bam, ref, str(tmp_path / "jax" / "out"), cfg,
                           num_workers=2)
    regions = jread_bed(str(tmp_path / "jax" / "out" /
                            "SV_Regions_HIFI.bed"))
    _, calls = jread_vcf(final)
    assert [(r.chrom, r.start, r.end) for r in mine["regions"]] == \
        [(r.chrom, r.start, r.end) for r in regions]
    assert len(regions) > 0
    assert [(r.chrom, r.pos, r.ref, r.alt, r.gt) for r in mine["calls"]] == \
        [(r.chrom, r.pos, r.ref, r.alt, r.gt) for r in calls]
    assert mine["match"].f1 > 0.9
    assert all(c["device_stats"]["n_chunks"] > 0
               for c in mine["chroms"].values())


def test_scaling_results_are_the_scripts(tmp_path, monkeypatch):
    """1 and 2 logical CPU shards: each region's result equals the JAX
    package's region step, unsharded at 1 and over a mesh of two CPU
    devices at 2, on bench_scaling.py's chunk; --out goes where it is
    told."""
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = tmp_path / "scaling.json"
    args = bench_scaling.parse_args(["--devices", "1", "2", "--per-device",
                                     "2", "--repeats", "1", "--out",
                                     str(out)])
    doc, outputs = bench_scaling.sweep(args)
    assert doc["records_equal"]
    cfg = jpreset("HIFI")
    key = tuple(doc["bucket"])
    _, Rp, Lp, Ds, Dd = key
    kw = dict(jrs.phase_consensus_kwargs(cfg.phasing), Drle=jdx.drle_of(key))
    tiles = []
    for job in _make_jobs(jbench._make_jobs, tmp_path / "jax", 8, 30.0,
                          15_000):
        reads, ref, chrom = jbench._load_job(job)
        tiles.append(jdx.build_tile(reads, ref, 0, chrom, cfg))
    tiles = [t for t in tiles if jdx._bucket_key(t, cfg) == key]
    for n in (1, 2):
        G = 2 * n
        chunk = [tiles[i % len(tiles)] for i in range(G)]
        buf = jrs.pack_delta_chunk(chunk, list(range(G)), G, Rp, Lp, Ds, Dd)
        if n == 1:
            want = jrs.phase_consensus_delta_flat(buf, G=G, R=Rp, L=Lp,
                                                  Ds=Ds, Dd=Dd, **kw)
        else:
            want = jrs.sharded_phase_consensus_delta_flat(
                buf, jmesh.make_mesh(2), G=G, R=Rp, L=Lp, Ds=Ds, Dd=Dd,
                **kw)
        assert np.array_equal(outputs[n][0], buf), n
        assert np.array_equal(outputs[n][1], np.asarray(want)), n
    assert bench_scaling.main(["--devices", "1", "--per-device", "1",
                               "--repeats", "1", "--out", str(out)]) == 0
    assert json.loads(out.read_text())["rows"][0]["records_equal"]
