"""The port's own copies of the host modules it shares with the JAX package.

focalsv_tpu_torch imports nothing of focalsv_tpu: it keeps a copy of every
host module and native source it needs.  A copy must stay the reference's
file with only the package name changed, so that a fix in one is seen to be
missing in the other.  One case per copied file; the files that differ on
purpose are listed with the reason and held by behaviour instead."""

import dataclasses
import re
from pathlib import Path

import numpy as np
import pytest

from focalsv_tpu import config as jconfig
from focalsv_tpu import native as jnative
from focalsv_tpu_torch import config as tconfig
from focalsv_tpu_torch import native as tnative

ROOT = Path(__file__).resolve().parent.parent
REF = ROOT / "focalsv_tpu"
PORT = ROOT / "focalsv_tpu_torch"

VERBATIM = [
    "utils/logging.py", "utils/coverage.py",
    "ops/encode.py", "ops/minimizer.py", "ops/chain.py",
    "native/bamparse.cpp", "native/bamscan.cpp", "native/chain.cpp",
    "io/__init__.py", "io/bed.py", "io/fasta.py", "io/sam.py",
    "io/vcf.py", "parallel/wire.py",
    "signatures/__init__.py", "signatures/sigs.py", "signatures/reads.py",
    "signatures/contig.py", "phasing/__init__.py", "phasing/phase.py",
    "calling/fp_filter.py", "calling/array_arbitrate.py",
    "refine/__init__.py", "refine/driver.py", "refine/coverage_filter.py",
    "refine/gt_correct.py", "refine/support.py",
    "scan/fast_scan.py", "scan/genotype.py",
    "regions/__init__.py", "regions/detect.py",
    "testing/__init__.py", "testing/simulate.py",
    "complexsv/__init__.py", "complexsv/auto.py", "complexsv/target.py",
    "complexsv/cli.py", "phasing/realign.py",
    "evaluation/__init__.py", "evaluation/cli.py", "evaluation/compare.py",
    "evaluation/figdata.py", "evaluation/figures.py", "evaluation/grid.py",
    "evaluation/somatic.py", "evaluation/vcf_filter.py",
    "tools/__init__.py", "tools/clean.py", "tools/callset_to_bed.py",
]

# differ on purpose; each is held by a behaviour case below
DIFFERENT = {
    "native/__init__.py": "builds its libraries into build/focalsv_tpu_torch/"
                          "native/, keyed by source and machine, never beside "
                          "the sources",
    "config.py": "the reference's file plus config_from_reference",
    "pipeline/mp_exec.py": "children hide the card instead of pinning jax; "
                           "a device beside the mesh; a failing is_ready "
                           "raises",
    "testing/dist_worker.py": "joins a torch.distributed group instead of "
                              "jax.distributed, with --backend and --device, "
                              "and leaves it before it returns",
    "io/bam.py": "fetch scans once from the first index chunk; "
                 "BamWriter.write_records writes a region BAM in one native "
                 "call (native/bamwrite.cpp)",
}

# functions of forked modules that stay the reference's own lines
VERBATIM_FUNCTIONS = [
    ("parallel/distributed.py", "shard_regions"),
    ("parallel/distributed.py", "host_vcf_path"),
    ("parallel/distributed.py", "merge_host_vcfs"),
    ("parallel/gather.py", "encode_records"),
    ("parallel/gather.py", "decode_records"),
    ("parallel/mesh.py", "pad_batch_to_devices"),
]


def _as_reference(text: str) -> str:
    return re.sub(r"\bfocalsv_tpu_torch\b", "focalsv_tpu", text)


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_reference(rel):
    assert _as_reference((PORT / rel).read_text()) == (REF / rel).read_text()


def _function_source(path: Path, name: str) -> str:
    import ast
    text = path.read_text()
    node = next(n for n in ast.parse(text).body
                if isinstance(n, ast.FunctionDef) and n.name == name)
    return ast.get_source_segment(text, node)


@pytest.mark.parametrize("rel,name", VERBATIM_FUNCTIONS)
def test_function_equals_reference(rel, name):
    assert _as_reference(_function_source(PORT / rel, name)) == \
        _function_source(REF / rel, name)


def test_dist_worker_keeps_the_reference_arguments():
    """The per-rank entry takes every option of the reference's, hands
    run_target_mode the same arguments and adds --backend and --device."""
    ref = (REF / "testing/dist_worker.py").read_text().splitlines()
    port = (PORT / "testing/dist_worker.py").read_text()
    options = [ln.strip() for ln in ref if "ap.add_argument(" in ln]
    assert len(options) == 9
    for ln in options:
        assert ln in port, ln
    for ln in ('ap.add_argument("--backend"', 'ap.add_argument("--device"',
               "process_index=args.pid,", "process_count=args.nprocs)",
               "distributed.shutdown()", 'print(f"FINAL:{path}", flush=True)'):
        assert ln in port, ln


def test_listed_files_exist_in_both_packages():
    for rel in list(VERBATIM) + list(DIFFERENT):
        assert (PORT / rel).is_file() and (REF / rel).is_file(), rel
    assert not set(VERBATIM) & set(DIFFERENT)


def test_config_copy_is_the_reference_plus_one_function():
    ref = (REF / "config.py").read_text()
    port = _as_reference((PORT / "config.py").read_text())
    assert port.startswith(ref)
    extra = port[len(ref):]
    assert extra.lstrip().startswith("def config_from_reference(")
    assert extra.count("\ndef ") == 1


@pytest.mark.parametrize("dtype", ["HIFI", "CLR", "ONT"])
def test_config_from_reference_round_trip(dtype):
    ref = jconfig.preset(dtype)
    ref = ref.replace(
        assembly=dataclasses.replace(ref.assembly, method="olc"),
        execution=dataclasses.replace(ref.execution, mode="device",
                                      dp_batching=True))
    got = tconfig.config_from_reference(dataclasses.asdict(ref))
    assert isinstance(got, tconfig.PipelineConfig)
    assert got.data_type is tconfig.DataType(dtype)
    for section in dataclasses.fields(ref):
        want = getattr(ref, section.name)
        have = getattr(got, section.name)
        if section.name == "data_type":
            assert have.value == want.value
            continue
        assert type(have).__module__ == "focalsv_tpu_torch.config"
        for f in dataclasses.fields(want):
            assert getattr(have, f.name) == getattr(want, f.name), (
                section.name, f.name)
    plain = tconfig.config_from_reference(dataclasses.asdict(
        jconfig.preset(dtype)))
    assert plain == tconfig.preset(dtype)


def test_config_from_reference_refuses_unknown_sections():
    d = dataclasses.asdict(jconfig.preset("HIFI"))
    d["not_a_section"] = {}
    with pytest.raises(ValueError, match="not_a_section"):
        tconfig.config_from_reference(d)


def test_mp_exec_fork_keeps_the_reference_protocol():
    """The executor's fork differs from the reference only where the device
    is named: the message kinds, the child's loop and the routing are the
    reference's lines."""
    import difflib
    ref = (REF / "pipeline/mp_exec.py").read_text().splitlines()
    port = _as_reference((PORT / "pipeline/mp_exec.py").read_text()
                         ).splitlines()
    removed = [ln for ln in difflib.ndiff(ref, port) if ln.startswith("- ")]
    assert len(removed) < 45, len(removed)
    for kind in ('"tile"', '"done_build"', '"finished"', '"error"', '"dev"',
                 '"run"', "_STOP"):
        assert sum(kind in ln for ln in port) == sum(kind in ln for ln in ref)


def test_native_builds_outside_the_sources():
    assert tnative.get_lib() is not None
    assert tnative.get_parse_lib() is not None
    build = ROOT / "build" / "focalsv_tpu_torch" / "native"
    for so in (tnative._SO, tnative._PARSE_SO, tnative._SCAN_SO):
        assert Path(so).parent == build
    assert not list((PORT / "native").glob("*.so"))


def _pair(seed, n=600):
    rng = np.random.default_rng(seed)
    t = rng.integers(0, 4, n).astype(np.uint8)
    q = np.delete(t, slice(200, 200 + int(rng.integers(1, 40))))
    flip = rng.random(len(q)) < 0.01
    q[flip] = (q[flip] + 1) % 4
    return q, t


@pytest.mark.parametrize("seed", range(3))
def test_native_affine_banded_align_equal(seed):
    q, t = _pair(seed)
    d_lo = (len(t) - len(q)) // 2 - 64
    s_j, d_j = jnative.affine_banded_align(q, t, d_lo, 128, 2, -4, -4, -2)
    s_t, d_t = tnative.affine_banded_align(q, t, d_lo, 128, 2, -4, -4, -2)
    assert s_t == s_j
    np.testing.assert_array_equal(d_t, d_j)


@pytest.mark.parametrize("seed", range(3))
def test_native_banded_edit_distance_equal(seed):
    q, t = _pair(10 + seed)
    band = abs(len(t) - len(q)) + 64
    assert (tnative.banded_edit_distance(q, t, band=band)
            == jnative.banded_edit_distance(q, t, band=band))


def test_native_build_tile_delta_equal():
    from focalsv_tpu.config import preset as jpreset
    from focalsv_tpu.pipeline import device_exec as jdx
    from focalsv_tpu.testing import simulate as jsim
    from focalsv_tpu_torch.pipeline import device_exec as tdx
    from focalsv_tpu_torch.testing import simulate as tsim
    kw = dict(seed=5, ref_len=6000, coverage=12, n_snps=8,
              read_len_mean=2500)
    rg_j, rg_t = jsim.simulate_region(**kw), tsim.simulate_region(**kw)
    cfg_j = jpreset("HIFI")
    cfg_t = tconfig.config_from_reference(dataclasses.asdict(cfg_j))
    tile_j = jdx.build_tile(rg_j.reads, rg_j.ref, 0, rg_j.chrom, cfg_j)
    tile_t = tdx.build_tile(rg_t.reads, rg_t.ref, 0, rg_t.chrom, cfg_t)
    assert tile_j.encoding == tile_t.encoding
    compared = 0
    for name, want in vars(tile_j).items():
        if isinstance(want, np.ndarray):
            np.testing.assert_array_equal(getattr(tile_t, name), want,
                                          err_msg=name)
            compared += 1
    assert compared >= 3


# -- io/bam.py: fetch scans once; the records and their order are the
# reference's ---------------------------------------------------------------

GOLDEN = ROOT / "tests" / "data" / "golden"


def _record_key(rec):
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            rec.cigar.tobytes(), rec.seq.tobytes(), rec.qual.tobytes(),
            sorted(rec.tags.items()))


def _same_fetch(path, queries):
    """The port's fetch against the reference's, record for record and in
    order, on each query; returns the records the queries found."""
    from focalsv_tpu.io import bam as jbam
    from focalsv_tpu_torch.io import bam as tbam
    jr, tr = jbam.BamReader(str(path)), tbam.BamReader(str(path))
    assert jr.bai is not None and tr.bai is not None
    found = 0
    for q in queries:
        want = [_record_key(r) for r in jr.fetch(*q)]
        got = [_record_key(r) for r in tr.fetch(*q)]
        assert got == want, q
        found += len(got)
    return found


@pytest.mark.parametrize("dtype", ["hifi", "clr", "ont"])
def test_fetch_equals_reference_on_golden_bams(dtype):
    d = GOLDEN / dtype
    beds = [ln.split("\t") for ln in (d / "regions.bed").read_text()
            .splitlines()]
    queries = [(c, int(a), int(b)) for c, a, b in beds]
    queries += [("chr21", 0, 150000), ("chr21", 0, 10), ("chr21", 149990,
                                                         150000),
                ("chr21", 15000, 50000), ("chr21",), ("chrX", 0, 1000)]
    assert _same_fetch(d / "reads.bam", queries) > 0


@pytest.fixture(scope="module")
def chromosome_bam(tmp_path_factory):
    """Simulated regions laid end to end on two references, as
    chip_smoke.py::write_chromosome lays them on one: chr21 holds four
    regions after 20 kb without reads, chr22 two."""
    import dataclasses

    from focalsv_tpu_torch.io import bam as tbam
    from focalsv_tpu_torch.testing import simulate as sim
    path = tmp_path_factory.mktemp("chrom") / "reads.bam"
    recs, lens = [], []
    for rid, sizes in enumerate(((15000, 30000, 15000, 20000),
                                 (15000, 20000))):
        off = 20000 if rid == 0 else 0
        for i, size in enumerate(sizes):
            rg = sim.simulate_region(seed=300 + 10 * rid + i, ref_len=size,
                                     coverage=8.0, n_snps=4)
            recs += [dataclasses.replace(r, ref_id=rid, pos=r.pos + off)
                     for r in rg.reads]
            off += size
        lens.append(off)
    recs.sort(key=lambda r: (r.ref_id, r.pos))
    w = tbam.BamWriter(str(path), ["chr21", "chr22"], lens)
    for r in recs:
        w.write(r)
    w.close()
    tbam.build_bai(str(path))
    return path


CHROM_QUERIES = {
    "before_first_read": [("chr21", 0, 20000), ("chr21", 0, 1)],
    "chromosome_end": [("chr21", 99000, 100000), ("chr21", 99999, 100000),
                       ("chr22", 34000, 35000)],
    "across_16kb_windows": [("chr21", 15000, 50000), ("chr21", 32767, 32769),
                            ("chr21", 40000, 90000)],
    "second_reference": [("chr22", 0, 35000), ("chr22", 14000, 16000),
                         ("chr22",)],
    "regions": [("chr21", 20100, 34900), ("chr21", 35100, 64900),
                ("chr21", 65100, 79900), ("chr21", 80100, 99900)],
    "whole_and_absent": [("chr21",), ("chr21", 0, 100000), ("chr3", 0, 10),
                         ("chr21", 50000, 50000)],
}


@pytest.mark.parametrize("name", sorted(CHROM_QUERIES))
def test_fetch_equals_reference_on_chromosome_bam(chromosome_bam, name):
    found = _same_fetch(chromosome_bam, CHROM_QUERIES[name])
    assert (found == 0) == (name == "before_first_read")


def test_fetch_reads_one_scan(monkeypatch):
    """A region query opens one stream, at the first index chunk."""
    from focalsv_tpu_torch.io import bam as tbam
    d = GOLDEN / "hifi"
    rd = tbam.BamReader(str(d / "reads.bam"))
    chunks = rd.bai.chunks_for(0, 34000, 48000)
    assert len(chunks) > 1
    opened = []
    real = rd.bgzf.stream_from
    monkeypatch.setattr(rd.bgzf, "stream_from",
                        lambda voff: opened.append(voff) or real(voff))
    assert list(rd.fetch("chr21", 34000, 48000))
    assert opened == [chunks[0][0]]
