"""The port's multi-process path (focalsv_tpu_torch/parallel/distributed.py,
parallel/gather.py, testing/dist_worker.py and run_target_mode's
process_index/process_count) against the JAX package's on the same inputs,
made from a seed.  Tolerance 0: shards, encoded bytes and VCF lines are
compared for equality.  Real process groups run over gloo on the CPU; each
subprocess has a time limit of its own and is killed when it passes it."""

import os
import socket
import subprocess
import sys
import textwrap
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest
import torch

from focalsv_tpu.config import preset as jpreset
from focalsv_tpu.io.bed import Region as JRegion
from focalsv_tpu.parallel import distributed as jdist
from focalsv_tpu.parallel import gather as jgather
from focalsv_tpu.pipeline import main as jmain
from focalsv_tpu_torch.config import preset
from focalsv_tpu_torch.evaluation.compare import match_records, truth_from_sim
from focalsv_tpu_torch.io.bed import Region, write_bed
from focalsv_tpu_torch.io.fasta import write_fasta
from focalsv_tpu_torch.io.vcf import VcfRecord, read_vcf, write_vcf
from focalsv_tpu_torch.parallel import distributed as dist
from focalsv_tpu_torch.parallel import gather
from focalsv_tpu_torch.pipeline import main as pm
from focalsv_tpu_torch.testing import simulate as sim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RANK_TIMEOUT_S = 240


@pytest.fixture(autouse=True)
def _cpu_port(monkeypatch):
    torch.set_num_threads(1)
    monkeypatch.setenv("FOCALSV_TORCH_DEVICE", "cpu")


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(commands: list[list[str]], env: dict) -> list[str]:
    """Start one process per command, wait for all within the time limit,
    kill every one of them when one fails or the limit passes, and return
    their outputs."""
    procs = [subprocess.Popen(cmd, cwd=REPO, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for cmd in commands]
    outputs = [""] * len(procs)
    deadline = time.monotonic() + RANK_TIMEOUT_S
    try:
        pending = set(range(len(procs)))
        while pending:
            for i in sorted(pending):
                if procs[i].poll() is not None:
                    outputs[i] = procs[i].communicate()[0]
                    pending.discard(i)
                    assert procs[i].returncode == 0, \
                        f"rank {i} failed:\n{outputs[i][-4000:]}"
            assert time.monotonic() < deadline, "the ranks timed out"
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.communicate()
    return outputs


def _rank_env() -> dict:
    env = dict(os.environ, FOCALSV_TORCH_DEVICE="cpu", OMP_NUM_THREADS="1",
               PYTHONPATH=REPO)
    env.pop("XLA_FLAGS", None)
    return env


# -- sharding and the file merge ----------------------------------------------

def test_shard_regions_matches_jax():
    spans = [1000] * 8 + [9000] * 2
    regions = [Region("chr1", i * 1000, i * 1000 + s)
               for i, s in enumerate(spans)]
    jregions = [JRegion("chr1", r.start, r.end) for r in regions]
    shards = [dist.shard_regions(regions, i, 4) for i in range(4)]
    assert [r for s in shards for r in s] == regions   # once each, in order
    assert max(sum(r.span for r in s) for s in shards) < sum(spans)
    for i in range(4):
        want = jdist.shard_regions(jregions, i, 4)
        assert [(r.chrom, r.start, r.end) for r in shards[i]] == \
            [(r.chrom, r.start, r.end) for r in want]
    assert dist.shard_regions(regions, 0, 1) is regions
    assert dist.host_vcf_path("/x", 3) == jdist.host_vcf_path("/x", 3)


def test_merge_host_vcfs_matches_jax(tmp_path):
    recs = [[VcfRecord("chr2", 10, "a", "A", "AT", info={"SVTYPE": "INS"})],
            [VcfRecord("chr1", 5, "b", "AT", "A", info={"SVTYPE": "DEL"})]]
    finals = []
    for tag, d in (("port", dist), ("jax", jdist)):
        out = str(tmp_path / tag)
        os.makedirs(out)
        for i, r in enumerate(recs):
            write_vcf(d.host_vcf_path(out, i), r)
        finals.append(d.merge_host_vcfs(out, 2))
    _, merged = read_vcf(finals[0])
    assert [r.chrom for r in merged] == ["chr1", "chr2"]
    with open(finals[0]) as f, open(finals[1]) as g:
        assert f.read() == g.read()


def test_merge_barrier_raises_on_missing_host(tmp_path):
    """A straggler host must fail the merge loudly (named), never shrink the
    genome-wide VCF silently."""
    out = str(tmp_path)
    write_vcf(dist.host_vcf_path(out, 0),
              [VcfRecord("chr1", 100, "x", "AT", "A",
                         info={"SVTYPE": "DEL", "SVLEN": -1})])
    with pytest.raises(RuntimeError, match="host1.vcf"):
        dist.merge_host_vcfs(out, 2, timeout_s=1.0, poll_s=0.05)


def test_merge_barrier_waits_for_late_host(tmp_path):
    """The barrier must WAIT for a slow host, not race past it."""
    out = str(tmp_path)
    write_vcf(dist.host_vcf_path(out, 0),
              [VcfRecord("chr1", 100, "x", "AT", "A",
                         info={"SVTYPE": "DEL", "SVLEN": -1})])

    def late_writer():
        time.sleep(0.6)
        tmp = dist.host_vcf_path(out, 1) + ".tmp"
        write_vcf(tmp, [VcfRecord("chr1", 900, "y", "A", "AGG",
                                  info={"SVTYPE": "INS", "SVLEN": 2})])
        os.replace(tmp, dist.host_vcf_path(out, 1))

    t = threading.Thread(target=late_writer)
    t.start()
    final = dist.merge_host_vcfs(out, 2, timeout_s=30.0, poll_s=0.05)
    t.join(timeout=30)
    assert not t.is_alive()
    _, recs = read_vcf(final)
    assert {r.pos for r in recs} == {100, 900}


def test_single_process_needs_no_group():
    assert dist.initialize() == (0, 1)
    assert dist.initialize(num_processes=1) == (0, 1)
    assert dist.world_size() == 1
    dist.shutdown()                        # nothing to leave
    with pytest.raises(ValueError, match="coordinator"):
        dist.initialize(num_processes=2, process_id=0)


# -- the records' wire format ---------------------------------------------------

def _records():
    return [
        VcfRecord("chr21", 100, "a", "ATTTT", "A", "20", "PASS",
                  {"SVTYPE": "DEL", "SVLEN": -4, "TIG_REGION": "c:0-1"},
                  "0/1"),
        VcfRecord("chr2", 99, "b", "A", "A" + "ACGT" * 200, ".", "PASS",
                  {"SVTYPE": "INS", "SVLEN": 800}, "1/1"),
    ]


def test_gather_records_roundtrip_matches_jax():
    """Record encode/decode is lossless and gives the JAX package's bytes;
    single-process allgather is identity."""
    from focalsv_tpu.io.vcf import VcfRecord as JRecord
    recs = _records()
    flat, lens = gather.encode_records(recs)
    jflat, jlens = jgather.encode_records(
        [JRecord(r.chrom, r.pos, r.id, r.ref, r.alt, r.qual, r.filter,
                 dict(r.info), r.gt) for r in recs])
    np.testing.assert_array_equal(flat, jflat)
    np.testing.assert_array_equal(lens, jlens)
    assert flat.dtype == np.uint8 and lens.dtype == np.int64
    back = gather.decode_records(flat, lens)
    assert [r.to_line() for r in back] == [r.to_line() for r in recs]
    assert [r.to_line() for r in jgather.decode_records(flat, lens)] == \
        [r.to_line() for r in recs]
    assert gather.allgather_records(recs) == recs
    empty_flat, empty_lens = gather.encode_records([])
    assert empty_flat.size == 0 and empty_lens.size == 0
    assert gather.decode_records(empty_flat, empty_lens) == []


def test_gather_encoding_is_width_safe():
    """One 50 kb-ALT INS among 1k small records must NOT pad every record
    to the long line's width: the offset encoding keeps the payload at
    O(total record bytes), like the reference's `cat`."""
    long_alt = "A" + "ACGT" * 12_500           # 50 kb ALT sequence
    recs = [VcfRecord("chr1", 1000, "big", "A", long_alt, ".", "PASS",
                      {"SVTYPE": "INS", "SVLEN": 50_000}, "0/1")]
    for i in range(1000):
        recs.append(VcfRecord("chr1", 2000 + i * 40, f"s{i}", "ATT", "A",
                              ".", "PASS", {"SVTYPE": "DEL", "SVLEN": -2},
                              "0/1"))
    flat, lens = gather.encode_records(recs)
    total = int(lens.sum())
    assert flat.size == total                   # zero padding inside a host
    assert total < 200_000
    back = gather.decode_records(flat, lens)
    assert [r.to_line() for r in back] == [r.to_line() for r in recs]


GATHER_RANK = textwrap.dedent('''
    import sys
    import numpy as np
    from focalsv_tpu_torch.io.vcf import VcfRecord
    from focalsv_tpu_torch.parallel import distributed, gather

    rank, world, port = int(sys.argv[1]), int(sys.argv[2]), sys.argv[3]
    try:
        assert distributed.initialize(f"localhost:{port}", world, rank,
                                      backend="gloo") == (rank, world)
        assert distributed.world_size() == world

        def recs(r):
            # rank 1 has no record at all; the others unequal counts and
            # line lengths
            n = 0 if r == 1 else 3 + 2 * r
            return [VcfRecord("chr1", 100 * r + i, f"r{r}_{i}", "A",
                              "A" + "ACGT" * (5 + 40 * r + i), ".", "PASS",
                              {"SVTYPE": "INS", "SVLEN": 4 * (5 + 40 * r + i)},
                              "0/1") for i in range(n)]

        got = gather.allgather_records(recs(rank))
        want = [x for r in range(world) for x in recs(r)]
        assert [x.to_line() for x in got] == [x.to_line() for x in want]
        x = np.arange(6, dtype=np.int64).reshape(2, 3) + 10 * rank
        both = gather._process_allgather(x)
        assert both.shape == (world, 2, 3) and both.dtype == np.int64
        assert all((both[r] == x - 10 * rank + 10 * r).all()
                   for r in range(world))
        print(f"GATHERED {len(got)}", flush=True)
    finally:
        distributed.shutdown()
    assert distributed.world_size() == 1
''')


def test_allgather_records_over_gloo_with_an_empty_rank():
    """Three real ranks over gloo: unequal record counts and payload sizes,
    one rank with nothing; every rank gets all records in rank order."""
    port = _free_port()
    outs = _run_ranks([[sys.executable, "-c", GATHER_RANK, str(r), "3",
                        str(port)] for r in range(3)], _rank_env())
    assert all("GATHERED 10" in o for o in outs), outs


# -- run_target_mode across processes -------------------------------------------

def _simulate_inputs(tmp_path, seed, svs, ref_len, windows):
    region = sim.simulate_region(seed=seed, ref_len=ref_len, coverage=20,
                                 n_snps=ref_len // 1500, svs=svs,
                                 chrom="chr21")
    bam = str(tmp_path / "r.bam")
    sim.write_region_bam(region, bam)
    ref = str(tmp_path / "ref.fa")
    write_fasta(ref, [("chr21", region.ref)])
    bed = str(tmp_path / "t.bed")
    write_bed(bed, [Region("chr21", a, b) for a, b in windows])
    return region, bam, ref, bed


def _two_hosts(run, bam, ref, out, cfg, bed):
    """Both "hosts" at once, as threads of this process (no process group:
    the file-merge branch): host 0 blocks on the merge barrier until host
    1's shard VCF lands."""
    with ThreadPoolExecutor(max_workers=2) as ex:
        f0 = ex.submit(run, bam, ref, out, cfg, target_bed=bed,
                       process_index=0, process_count=2)
        f1 = ex.submit(run, bam, ref, out, cfg, target_bed=bed,
                       process_index=1, process_count=2)
        return f0.result(timeout=600), f1.result(timeout=600)


def test_two_host_sharded_run(tmp_path):
    rng = np.random.default_rng(17)
    svs = [sim.SimSV("DEL", 7_000, 200, "1/1"),
           sim.SimSV("INS", 22_000, 300, "1/1",
                     seq=rng.integers(0, 4, 300).astype(np.uint8))]
    region, bam, ref, bed = _simulate_inputs(
        tmp_path, 900, svs, 30_000, [(3_000, 12_000), (18_000, 27_000)])
    out = str(tmp_path / "out")
    final, p1 = _two_hosts(pm.run_target_mode, bam, ref, out, preset("HIFI"),
                           bed)
    assert os.path.basename(p1) == "host1.vcf"
    assert os.path.basename(final) == "FocalSV_Final_SV.vcf"
    _, calls = read_vcf(final)
    truth = truth_from_sim(region.svs, "chr21", region.ref)
    assert match_records(calls, truth).recall == 1.0, [
        (r.pos, r.info.get("SVTYPE"), r.info.get("SVLEN")) for r in calls]
    # each shard saw one region, in a work directory of its own
    _, h0 = read_vcf(os.path.join(out, "host0.vcf"))
    _, h1 = read_vcf(os.path.join(out, "host1.vcf"))
    assert len(h0) >= 1 and len(h1) >= 1
    assert os.path.isdir(os.path.join(out, "host0_work", "chr21"))
    assert os.path.isdir(os.path.join(out, "host1_work", "chr21"))


def test_boundary_straddling_duplicate_collapses(tmp_path):
    """An SV inside the OVERLAP of two hosts' shard-boundary regions is
    called by both hosts; the host-0 merge must collapse it to one record
    (cross-shard dedup at the gather point)."""
    svs = [sim.SimSV("DEL", 14_000, 220, "1/1")]
    # equal spans so the span-balanced sharder gives one region per host
    region, bam, ref, bed = _simulate_inputs(
        tmp_path, 901, svs, 28_000, [(4_000, 17_000), (11_000, 24_000)])
    out = str(tmp_path / "out")
    final, _ = _two_hosts(pm.run_target_mode, bam, ref, out, preset("HIFI"),
                          bed)
    _, h0 = read_vcf(os.path.join(out, "host0.vcf"))
    _, h1 = read_vcf(os.path.join(out, "host1.vcf"))
    assert any(r.svtype == "DEL" for r in h0)
    assert any(r.svtype == "DEL" for r in h1)
    _, calls = read_vcf(final)
    dels = [r for r in calls if r.svtype == "DEL"
            and abs(r.pos - 14_000) < 2_000]
    assert len(dels) == 1, [(r.pos, r.info) for r in calls]


def test_collective_gather_over_gloo_writes_the_jax_vcf(tmp_path):
    """Two real dist_worker processes over gloo on the CPU run the
    production run_target_mode with process_count=2: the collective branch
    executes (the log says so) and the final VCF equals, line for line,
    the one the JAX package's file-merge run writes on the same input, and
    the port's own file-merge run."""
    rng = np.random.default_rng(31)
    svs = [sim.SimSV("DEL", 7_000, 200, "1/1"),
           sim.SimSV("INS", 22_000, 300, "1/1",
                     seq=rng.integers(0, 4, 300).astype(np.uint8))]
    _, bam, ref, bed = _simulate_inputs(
        tmp_path, 910, svs, 30_000, [(3_000, 12_000), (18_000, 27_000)])
    out = str(tmp_path / "out_dist")
    port = _free_port()
    outputs = _run_ranks(
        [[sys.executable, "-m", "focalsv_tpu_torch.testing.dist_worker",
          "--pid", str(pid), "--nprocs", "2", "--port", str(port),
          "--bam", bam, "--ref", ref, "--bed", bed, "--out", out,
          "--device", "cpu", "--backend", "gloo"] for pid in range(2)],
        _rank_env())
    assert "final VCF (collective gather)" in outputs[0]
    assert "final VCF" not in outputs[1]
    assert f"FINAL:{out}/FocalSV_Final_SV.vcf" in outputs[0]
    assert f"FINAL:{out}/host1.vcf" in outputs[1]
    final = os.path.join(out, "FocalSV_Final_SV.vcf")
    _, dist_recs = read_vcf(final)
    assert any(r.svtype == "DEL" for r in dist_recs)
    assert any(r.svtype == "INS" for r in dist_recs)

    jfinal, _ = _two_hosts(jmain.run_target_mode, bam, ref,
                           str(tmp_path / "out_jax"), jpreset("HIFI"), bed)
    # (the collective branch also writes the ##contig lines, which the
    # file merge of both packages leaves out)
    with open(final) as f, open(jfinal) as g:
        got = [ln for ln in f.read().splitlines()
               if not ln.startswith("##contig")]
        assert got == g.read().splitlines()
    tfinal, _ = _two_hosts(pm.run_target_mode, bam, ref,
                           str(tmp_path / "out_emul"), preset("HIFI"), bed)
    _, emul_recs = read_vcf(tfinal)
    assert [r.to_line() for r in dist_recs] == \
        [r.to_line() for r in emul_recs]
