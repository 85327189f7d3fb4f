"""The port's one-call region BAM writer (io/bam.py::BamWriter.write_records,
native/bamwrite.cpp) against the reference's per-record writer: the same
records give the same file, byte for byte, whose BGZF blocks hold the same
stream cut at the same places."""

import dataclasses
import glob
import json
import os

import numpy as np
import pytest

from focalsv_tpu.io import bam as jbam
from focalsv_tpu_torch import native
from focalsv_tpu_torch.config import preset as tpreset
from focalsv_tpu_torch.io import bam as tbam
from focalsv_tpu_torch.pipeline.main import run_target_mode
from focalsv_tpu_torch.testing import simulate as sim
from focalsv_tpu_torch.utils.profiling import NO_TIMER, StageTimer

GOLDEN_HIFI = os.path.join(os.path.dirname(__file__), "data", "golden", "hifi")
CHROM, CHROM_LEN = "chr21", 3_200_000


def _hifi_region():
    """A simulated HiFi region (about 60 reads of 12 +- 2 kb, qualities 40),
    some reads phased (HP 1 or 2 with a PS) and some not."""
    r = sim.simulate_region(seed=11, ref_len=40_000, coverage=20.0)
    rng = np.random.default_rng(5)
    n = len(r.reads)
    hp = rng.integers(0, 3, n).astype(np.int8)
    ps = np.where(hp > 0, rng.integers(1_000, 39_000, n), -1)
    return r.reads, hp, ps


def _odd_reads():
    """Odd sequence lengths, N and pad codes, qualities shorter than the
    sequence (written as 0xFF), an empty CIGAR and a read on another
    reference."""
    rng = np.random.default_rng(7)
    reads = []
    for i, ln in enumerate((1, 3, 7, 1_001, 12_345, 0)):
        seq = rng.integers(0, 6, ln).astype(np.uint8)
        qual = rng.integers(0, 60, ln if i % 2 else ln // 2).astype(np.uint8)
        cigar = np.array([[tbam.CSOFT_CLIP, 1], [tbam.CMATCH, max(ln - 1, 0)],
                          [tbam.CDEL, 40], [tbam.CINS, 0]], np.int32) \
            if ln > 1 else np.zeros((0, 2), np.int32)
        reads.append(tbam.BamRecord(
            name=f"odd_{i}", flag=16 * (i % 2), ref_id=i % 2,
            pos=16_380 + 9_000 * i, mapq=i * 11, cigar=cigar, seq=seq,
            qual=qual, next_ref_id=0, next_pos=5, tlen=-3))
    hp = np.array([1, 0, 2, 2, 0, 1], np.int8)
    return reads, hp, np.array([100, -1, 200, 200, -1, 300])


def _tagged_reads():
    """Reads with tags of their own, int, float and str, one with HP already
    set: phased ones get HP and PS beside them, as the per-record path
    gives them."""
    reads, hp, ps = _hifi_region()
    reads = reads[:8]
    own = [{"NM": 5, "RG": "grp1"}, {"HP": 2, "XS": -7}, {"XF": 0.5},
           {}, {"HP": 1}, {"MI": "x" * 300}, {}, {"AS": 2**31 - 1}]
    return ([dataclasses.replace(r, tags=t) for r, t in zip(reads, own)],
            np.array([1, 1, 0, 2, 0, 2, 1, 0], np.int8),
            np.array([10, 11, -1, 13, -1, 15, 16, -1]))


CASES = {
    "hifi_phased": _hifi_region,
    "odd_lengths_n_short_qual": _odd_reads,
    "own_tags": _tagged_reads,
    "empty": lambda: ([], np.zeros(0, np.int8), np.zeros(0, np.int64)),
}


def _reference_bam(path, reads, hp, ps):
    """The reference's writer, a record at a time, as region_phased.bam's
    records were made: on reference 0, unpaired, HP and PS where hp > 0."""
    w = jbam.BamWriter(path, [CHROM], [CHROM_LEN])
    for i, rec in enumerate(reads):
        tags = dict(rec.tags)
        if hp[i] > 0:
            tags["HP"] = int(hp[i])
            tags["PS"] = int(ps[i])
        w.write(jbam.BamRecord(
            name=rec.name, flag=rec.flag, ref_id=0, pos=rec.pos,
            mapq=rec.mapq, cigar=rec.cigar, seq=rec.seq, qual=rec.qual,
            tags=tags))
    w.close()


def _port_bam(path, reads, hp, ps, timer=NO_TIMER):
    tbam.BamWriter(path, [CHROM], [CHROM_LEN]).write_records(
        reads, hp, ps, ref_id=0, timer=timer)


def _blocks(path):
    """The decompressed payload of every BGZF block, the EOF block's too."""
    bgzf = jbam.BgzfReader(path)
    out, off = [], 0
    while off < len(bgzf.raw):
        data, off = bgzf.block_at(off)
        out.append(data)
    return out


@pytest.fixture(scope="module")
def write_lib():
    lib = native.get_write_lib()
    assert lib is not None, "native/bamwrite.cpp did not build"
    return lib


@pytest.mark.parametrize("case", list(CASES))
def test_native_writer_gives_the_reference_payload(case, write_lib, tmp_path):
    reads, hp, ps = CASES[case]()
    _reference_bam(str(tmp_path / "ref.bam"), reads, hp, ps)
    t = StageTimer()
    _port_bam(str(tmp_path / "port.bam"), reads, hp, ps, timer=t)
    assert t.summary()["bam_write_native"]["calls"] == 1
    assert "bam_write_py" not in t.summary()
    want, got = _blocks(tmp_path / "ref.bam"), _blocks(tmp_path / "port.bam")
    assert [len(b) for b in got] == [len(b) for b in want]
    assert b"".join(got) == b"".join(want)
    assert got[-1] == b""     # the EOF block
    assert (tmp_path / "port.bam").read_bytes() == \
        (tmp_path / "ref.bam").read_bytes()


def test_records_after_write_continue_the_stream(write_lib, tmp_path):
    """write_records after records written one at a time: the bytes still
    in the writer's buffer start the native call's stream."""
    reads, hp, ps = _hifi_region()
    _reference_bam(str(tmp_path / "ref.bam"), reads, hp, ps)
    w = tbam.BamWriter(str(tmp_path / "port.bam"), [CHROM], [CHROM_LEN])
    k = 7   # three blocks written, the rest of the stream in the buffer
    for i, rec in enumerate(reads[:k]):
        tags = {"HP": int(hp[i]), "PS": int(ps[i])} if hp[i] > 0 else {}
        w.write(dataclasses.replace(rec, tags=tags))
    assert w.w.f.tell() > 0 and w.w.buf
    w.write_records(reads[k:], hp[k:], ps[k:], ref_id=0, timer=NO_TIMER)
    want, got = _blocks(tmp_path / "ref.bam"), _blocks(tmp_path / "port.bam")
    assert [len(b) for b in got] == [len(b) for b in want]
    assert b"".join(got) == b"".join(want)


def _fields(rec):
    return (rec.name, rec.flag, rec.ref_id, rec.pos, rec.mapq,
            rec.cigar.tolist(), rec.seq.tolist(), rec.qual.tolist(),
            rec.tags, rec.next_ref_id, rec.next_pos, rec.tlen)


def test_native_file_reads_back_and_indexes(write_lib, tmp_path):
    """Both packages' readers fetch the same records from the native file,
    after build_bai indexes it, as from the reference writer's file."""
    reads, hp, ps = _hifi_region()
    _reference_bam(str(tmp_path / "ref.bam"), reads, hp, ps)
    _port_bam(str(tmp_path / "port.bam"), reads, hp, ps)
    for name in ("ref.bam", "port.bam"):
        tbam.build_bai(str(tmp_path / name))
    want = [_fields(r) for r in
            jbam.BamReader(str(tmp_path / "ref.bam")).fetch(CHROM, 0, 40_000)]
    assert len(want) == len(reads)
    for reader in (jbam.BamReader, tbam.BamReader):
        r = reader(str(tmp_path / "port.bam"))
        assert r.bai is not None
        assert [_fields(x) for x in r.fetch(CHROM, 0, 40_000)] == want
        assert [_fields(x) for x in r.fetch(CHROM, 20_000, 21_000)] == \
            [_fields(x) for x in jbam.BamReader(
                str(tmp_path / "ref.bam")).fetch(CHROM, 20_000, 21_000)]


def test_without_the_library_the_file_is_the_reference_file(tmp_path,
                                                          monkeypatch):
    reads, hp, ps = _odd_reads()
    monkeypatch.setattr(native, "get_write_lib", lambda: None)
    _reference_bam(str(tmp_path / "ref.bam"), reads, hp, ps)
    t = StageTimer()
    _port_bam(str(tmp_path / "port.bam"), reads, hp, ps, timer=t)
    assert t.summary()["bam_write_py"]["calls"] == 1
    assert "bam_write_native" not in t.summary()
    assert (tmp_path / "port.bam").read_bytes() == \
        (tmp_path / "ref.bam").read_bytes()


def test_a_failed_write_raises_and_does_not_fall_back(write_lib, tmp_path):
    """A write the file descriptor refuses raises OSError: the per-record
    path does not append a second stream after what may be written."""
    reads, hp, ps = _hifi_region()
    path = str(tmp_path / "port.bam")
    w = tbam.BamWriter(path, [CHROM], [CHROM_LEN])
    w.w.f.close()
    w.w.f = open(path, "rb")      # write() on it fails with EBADF
    t = StageTimer()
    try:
        with pytest.raises(OSError):
            w.write_records(reads, hp, ps, ref_id=0, timer=t)
    finally:
        w.w.f.close()
    assert t.summary()["bam_write_native"]["calls"] == 1
    assert "bam_write_py" not in t.summary()
    assert os.path.getsize(path) == 0


def test_a_refused_record_falls_back_and_raises_as_before(write_lib,
                                                          tmp_path):
    """A value encode_record refuses (a name past 254 bytes) makes the native
    call write nothing; the per-record path then raises its own error."""
    reads, hp, ps = _odd_reads()
    reads[2] = dataclasses.replace(reads[2], name="n" * 300)
    t = StageTimer()
    with pytest.raises(Exception) as got:
        _port_bam(str(tmp_path / "port.bam"), reads, hp, ps, timer=t)
    with pytest.raises(type(got.value)):
        _reference_bam(str(tmp_path / "ref.bam"), reads, hp, ps)
    assert t.summary()["bam_write_native"]["calls"] == 1
    assert t.summary()["bam_write_py"]["calls"] == 1


def _golden_run(out_dir, monkeypatch, mode):
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")
    cfg = tpreset("HIFI")
    cfg = cfg.replace(execution=dataclasses.replace(cfg.execution, mode=mode))
    final = run_target_mode(
        os.path.join(GOLDEN_HIFI, "reads.bam"),
        os.path.join(GOLDEN_HIFI, "ref.fa"), out_dir, cfg,
        target_bed=os.path.join(GOLDEN_HIFI, "regions.bed"), num_workers=2)
    with open(os.path.join(out_dir, "chr21", "log", "stage_times.json")) as f:
        st = json.load(f)
    with open(final) as f:
        vcf = f.read()
    bams = sorted(glob.glob(os.path.join(out_dir, "chr21", "regions", "*",
                                         "region_phased.bam")))
    return st, vcf, bams


@pytest.mark.parametrize("mode", ["device", "host"])
def test_target_mode_writes_region_bams_in_one_call(mode, write_lib,
                                                    tmp_path, monkeypatch):
    """run_target_mode on the golden HiFi BED: one bam_write_native span a
    region BAM written, the same final VCF, and each region BAM's payload
    the per-record path's (the library made unavailable)."""
    st, vcf, bams = _golden_run(str(tmp_path / "native"), monkeypatch, mode)
    with open(os.path.join(GOLDEN_HIFI, "expected.vcf")) as f:
        assert vcf == f.read()
    assert bams
    assert st["bam_write_native"]["calls"] == len(bams)
    assert "bam_write_py" not in st
    monkeypatch.setattr(native, "get_write_lib", lambda: None)
    st_py, vcf_py, bams_py = _golden_run(str(tmp_path / "py"), monkeypatch,
                                         mode)
    assert vcf_py == vcf
    assert st_py["bam_write_py"]["calls"] == len(bams_py)
    assert [os.path.relpath(p, tmp_path / "py") for p in bams_py] == \
        [os.path.relpath(p, tmp_path / "native") for p in bams]
    for a, b in zip(bams, bams_py):
        assert b"".join(_blocks(a)) == b"".join(_blocks(b)), a
        assert [len(x) for x in _blocks(a)] == [len(x) for x in _blocks(b)]
