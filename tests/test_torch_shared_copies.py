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
    "io/__init__.py", "io/bam.py", "io/bed.py", "io/fasta.py", "io/sam.py",
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
                           "one device, no mesh; a failing is_ready raises",
}


def _as_reference(text: str) -> str:
    return re.sub(r"\bfocalsv_tpu_torch\b", "focalsv_tpu", text)


@pytest.mark.parametrize("rel", VERBATIM)
def test_copy_equals_reference(rel):
    assert _as_reference((PORT / rel).read_text()) == (REF / rel).read_text()


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
