"""Chromosome- and genome-level orchestration.

Mirrors the reference contract (`focalsv/focalsv.py` + `main.py:104-155` +
`4_sv_calling.sh`): per-region crop/phase/assemble, then *chromosome-level*
variant calling over all regions' contigs -- FP filter against the
chromosome's read signatures, redundancy removal across regions, step-5
coverage/GT refinement -- and a final cross-chromosome merge (the
`grep '#' + cat chr*/... | vcf-sort` step, focalsv.py:66-70).

Output layout mirrors the reference's `out_dir/chrN/regions/Region_*` tree so
downstream tooling (the target-mode complex-SV caller reads these dirs) finds
the same artifacts.
"""

from __future__ import annotations

import json
import os
import time
from dataclasses import dataclass, field

import numpy as np

from focalsv_tpu_torch.calling.dedup import dedup_records
from focalsv_tpu_torch.calling.fp_filter import fp_filter_records
from focalsv_tpu_torch.config import DataType, PipelineConfig
from focalsv_tpu_torch.io import bam as bamio
from focalsv_tpu_torch.io.bed import Region, read_bed, split_by_chrom, write_bed
from focalsv_tpu_torch.io.fasta import FastaFile, write_fasta
from focalsv_tpu_torch.io.vcf import VcfRecord, merge_vcfs, write_vcf
from focalsv_tpu_torch.pipeline.region import RegionResult, process_region
from focalsv_tpu_torch.refine.driver import refine_records
from focalsv_tpu_torch.regions.detect import detect_regions
from focalsv_tpu_torch.scan.read_scan import calls_to_vcf, scan_chromosome
from focalsv_tpu_torch.utils.logging import get_logger
from focalsv_tpu_torch.utils.profiling import NO_TIMER, StageTimer

logger = get_logger("pipeline")


def _write_region_artifacts(rdir: str, rres: RegionResult, chrom: str,
                            chrom_len: int, timer=NO_TIMER) -> None:
    """Reference-layout region artifacts: region_phased.bam with HP/PS tags +
    region_phased.vcf with the phased het SNVs (longshot-style, consumed by
    target-mode complex SV tooling) and the per-phase-block haplotype FASTAs
    + assembled contigs (PS<ps>_hp{1,2}.fa / HP{1,2}.fa, output_fas.py +
    combine_fas.py layout)."""
    try:
        if rres.snv_records:
            write_vcf(os.path.join(rdir, "region_phased.vcf"),
                      rres.snv_records, contigs={chrom: chrom_len})
        if rres.usable_reads and rres.phase_hp is not None:
            w = bamio.BamWriter(os.path.join(rdir, "region_phased.bam"),
                                [chrom], [chrom_len])
            w.write_records(rres.usable_reads, rres.phase_hp, rres.phase_ps,
                            ref_id=0, timer=timer)
        for hp_idx, contigs in ((1, rres.contigs_hp1), (2, rres.contigs_hp2)):
            if contigs:
                write_fasta(os.path.join(rdir, f"HP{hp_idx}.fa"),
                            list(contigs.items()))
    except Exception:
        logger.exception("failed writing artifacts for %s", rdir)


_native_scan_cache: dict = {}
_native_scan_lock = __import__("threading").Lock()


def _native_chrom_scan(bam: bamio.BamReader, chrom: str,
                       cfg: PipelineConfig):
    """One native whole-BAM scan, cached for the CURRENT bam path only;
    returns the requested chromosome's ScanResult or None if the library is
    absent.  The NativeScan holds compact columnar arrays; per-chromosome
    Python objects materialize lazily one chromosome at a time, so peak
    memory stays O(genome arrays + one chromosome)."""
    key = bam.bgzf.path
    with _native_scan_lock:   # concurrent shards must not double-scan
        if key not in _native_scan_cache:
            _native_scan_cache.clear()  # one BAM's scan resident at a time
            try:
                from focalsv_tpu_torch.scan.fast_scan import scan_bam_native
                _native_scan_cache[key] = scan_bam_native(
                    key, bam.ref_names, cfg.read_scan)
            except Exception:
                logger.exception("native scan failed; falling back")
                _native_scan_cache[key] = None
        scans = _native_scan_cache[key]
        return scans.get(chrom) if scans else None


@dataclass
class ChromosomeResult:
    chrom: str
    records: list[VcfRecord] = field(default_factory=list)
    region_results: list[RegionResult] = field(default_factory=list)
    n_regions: int = 0
    seconds: float = 0.0


def _dp_batching_enabled(cfg: PipelineConfig, device) -> bool:
    """Cross-thread DP batching: explicit flag wins, else on for CUDA
    (on CPU the native host kernel beats a fake device round-trip)."""
    if cfg.execution.dp_batching is not None:
        return cfg.execution.dp_batching
    return device.type == "cuda"


def _write_device_stats(out_dir: str | None, stats: dict, batcher) -> None:
    """log/device_stats.json: the streamed_map stage stats (chunks, host
    fallbacks, h2d/d2h bytes, stage seconds) and the DP batcher's counts."""
    if batcher is not None:
        stats["dp_batches"] = batcher.n_batches
        stats["dp_jobs"] = batcher.n_jobs
        stats["dp_d2h_bytes"] = batcher.d2h_bytes
        stats["dp_dirs_bytes_on_device"] = batcher.dirs_bytes
    if out_dir:
        log_dir = os.path.join(out_dir, "log")
        os.makedirs(log_dir, exist_ok=True)
        with open(os.path.join(log_dir, "device_stats.json"), "w") as f:
            json.dump(stats, f, indent=2, sort_keys=True)


def _run_regions_device(bam, fasta, chrom, regions, cfg, out_dir, chrom_len,
                        num_workers, failures, timer, mesh=None,
                        process_count=1):
    """Device-batched region execution: tile -> bucketed device dispatch ->
    host finish (with gap DPs batched onto the device).  See
    pipeline/device_exec.py for the parity contract.  A device failure
    raises: there is no host rerun of the chromosome.

    A single process on the unnamed ``cuda`` device with more than one card
    present splits the chunks over a mesh of all of them
    (parallel/mesh.py::mesh_for; ``mesh``: the caller's own, e.g. logical
    shards of one card); the DP batcher stays on the first device."""
    import contextlib

    from concurrent.futures import ThreadPoolExecutor

    from focalsv_tpu_torch.device import resolve_device
    from focalsv_tpu_torch.pipeline import device_exec as dx

    def fetch_and_tile(region: Region):
        start = max(0, region.start)
        end = min(chrom_len, region.end)
        if end <= start:
            return None
        try:
            with timer.stage("region_fetch"):
                reads = list(bam.fetch(chrom, start, end))
                ref_codes = fasta.fetch(chrom, start, end)
            with timer.stage("region_tile"):
                return dx.build_tile(reads, ref_codes, start, chrom, cfg)
        except Exception:
            logger.exception("region %s tiling failed; skipping",
                             region.name())
            failures.append(region.name())
            return None

    def finish(i: int, tile, dev):
        try:
            with timer.stage("region_finish"):
                rres = dx.process_region_device(tile, dev, cfg,
                                                apply_fp_filter=False,
                                                timer=timer)
        except Exception:
            logger.exception("region %s failed; skipping",
                             regions[i].name())
            failures.append(regions[i].name())
            return None
        if out_dir:
            with timer.stage("region_write"):
                rdir = os.path.join(out_dir, "regions", regions[i].name())
                os.makedirs(rdir, exist_ok=True)
                _write_region_artifacts(rdir, rres, chrom, chrom_len, timer)
        return rres

    if mesh is not None:
        device = mesh.devices[0]
    else:
        device = resolve_device()
        if device.type == "cuda":
            import torch

            from focalsv_tpu_torch.parallel.mesh import mesh_for
            mesh = mesh_for(device, torch.cuda.device_count(), process_count)
    batch_ctx = contextlib.nullcontext()
    if _dp_batching_enabled(cfg, device):
        from focalsv_tpu_torch.parallel.batch_executor import dp_batching
        batch_ctx = dp_batching(device=device, timer=timer)
    # fully-pipelined streaming: tile builds, device dispatches, decodes and
    # per-region finishes all overlap (device_exec.streamed_map)
    tile_jobs = [(lambda r=r: fetch_and_tile(r)) for r in regions]
    stats: dict = {}
    with timer.stage("regions_streamed"), batch_ctx as batcher, \
            ThreadPoolExecutor(max_workers=max(num_workers, 1)) as ex:
        results = dx.streamed_map(ex, tile_jobs, cfg, finish, device=device,
                                  stats=stats, mesh=mesh, timer=timer)
    _write_device_stats(out_dir, stats, batcher)
    return results


def process_chromosome(
    bam: bamio.BamReader,
    fasta: FastaFile,
    chrom: str,
    regions: list[Region],
    cfg: PipelineConfig,
    out_dir: str | None = None,
    refine: bool = True,
    num_workers: int = 4,
    mesh=None,
    process_count: int = 1,
) -> ChromosomeResult:
    """All regions of one chromosome -> refined chromosome VCF records.

    Execution modes (cfg.execution.mode):
    - "device" (default): regions bucketized into fixed-shape pileup tiles;
      phasing + consensus run as one device batch per bucket chunk and
      the aligner's gap DPs batch cross-thread onto the device -- the GPU is
      the engine of the hot path.
    - "host": per-region numpy on a thread pool (the reference's
      joblib.Parallel analog; also the fallback inside device mode).

    ``mesh`` (device mode): the parallel/mesh.py mesh the region chunks are
    split over; by default parallel/mesh.py::mesh_for decides, from the
    device asked for, the cards present and ``process_count`` (the processes
    of the run).
    """
    timer = StageTimer()
    t0 = time.perf_counter()
    res = ChromosomeResult(chrom=chrom, n_regions=len(regions))
    chrom_len = fasta.lengths().get(chrom)
    if chrom_len is None:
        logger.warning("chromosome %s not in reference; skipping", chrom)
        return res
    candidates: list[VcfRecord] = []
    failures: list[str] = []  # list.append is atomic under the GIL

    def one(region: Region) -> RegionResult | None:
        start = max(0, region.start)
        end = min(chrom_len, region.end)
        if end <= start:
            return None
        try:
            reads = list(bam.fetch(chrom, start, end))
            ref_codes = fasta.fetch(chrom, start, end)
            rres = process_region(reads, ref_codes, start, chrom, cfg,
                                  apply_fp_filter=False)
        except Exception:
            # failure isolation: a dead region yields no VCF lines, the rest
            # of the chromosome continues (reference main.run_command
            # swallow-and-continue semantics, main.py:10-17)
            logger.exception("region %s failed; skipping", region.name())
            failures.append(region.name())
            return None
        if out_dir:
            rdir = os.path.join(out_dir, "regions", region.name())
            os.makedirs(rdir, exist_ok=True)
            _write_region_artifacts(rdir, rres, chrom, chrom_len, timer)
        return rres

    if cfg.execution.mode == "device":
        results = _run_regions_device(bam, fasta, chrom, regions, cfg,
                                      out_dir, chrom_len, num_workers,
                                      failures, timer, mesh=mesh,
                                      process_count=process_count)
    elif num_workers > 1 and len(regions) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with timer.stage("regions_host"), \
                ThreadPoolExecutor(max_workers=num_workers) as ex:
            results = list(ex.map(one, regions))
    else:
        with timer.stage("regions_host"):
            results = [one(r) for r in regions]
    # per-region isolation must not mask a systemic fault (e.g. the device
    # backend failing to initialize): every attempted region failing means
    # an empty VCF would silently look like "no SVs" -- fail loudly instead
    if failures and not any(r is not None for r in results):
        raise RuntimeError(
            f"{chrom}: all {len(failures)} regions failed "
            f"(first: {failures[0]}); see log for tracebacks")
    def _dump_stage_times():
        if out_dir:
            try:
                log_dir = os.path.join(out_dir, "log")
                os.makedirs(log_dir, exist_ok=True)
                timer.dump(os.path.join(log_dir, "stage_times.json"))
            except Exception:
                logger.exception("failed writing stage_times.json")

    for rres in results:
        if rres is None:
            continue
        res.region_results.append(rres)
        candidates.extend(rres.records)
    logger.info("%s: %d regions -> %d candidate SVs",
                chrom, len(regions), len(candidates))
    if not candidates:
        res.seconds = time.perf_counter() - t0
        _dump_stage_times()
        return res
    # chromosome-level read-signature scan (FP-filter + step-5 evidence +
    # draft VCF for CLR/ONT GT imputation); native C++ scanner when available
    from focalsv_tpu_torch.scan.read_scan import (cluster_signatures,
                                            normalize_scan_result)
    with timer.stage("read_scan"):
        chrom_ref = fasta.fetch(chrom)
        scan = _native_chrom_scan(bam, chrom, cfg)
        if scan is None:
            _, scan = scan_chromosome(bam.fetch(chrom, 0, chrom_len), chrom,
                                      cfg.read_scan, genotype=False)
        # canonicalize signature coordinates ONCE; the FP filter, the draft
        # calls, and the refinement stack all see normalized positions
        normalize_scan_result(scan, chrom_ref)
        calls = cluster_signatures(scan.del_sigs, chrom, "DEL",
                                   cfg.read_scan, scan, True)
        calls += cluster_signatures(scan.ins_sigs, chrom, "INS",
                                    cfg.read_scan, scan, True)
        calls.sort(key=lambda c: c.pos)
        draft = calls_to_vcf(calls, chrom_ref, 0)
    from focalsv_tpu_torch.signatures.sigs import Sigs
    with timer.stage("fp_filter_dedup"):
        sig_rows = []
        names: list[str] = []
        for svt, sigs in ((0, scan.del_sigs), (1, scan.ins_sigs)):
            for s in sigs:
                sig_rows.append(dict(svtype=svt, pos=s.pos, svlen=s.length,
                                     contig=0, rstart=0, rend=1, strand=0,
                                     source=0, mapq=60))
        read_sigs = Sigs.from_rows(sig_rows, names)
        kept, dropped = fp_filter_records(candidates, read_sigs,
                                          cfg.fp_filter)
        # cross-region dedup
        kept, removed = dedup_records(kept, cfg.dedup)
    # step-5 refinement
    if refine:
        with timer.stage("refine"):
            kept, cov_dropped = refine_records(kept, scan, draft, cfg)
    res.records = kept
    res.seconds = time.perf_counter() - t0
    _dump_stage_times()
    logger.info("%s: %d final SVs (%.1fs)", chrom, len(kept), res.seconds)
    return res


def run_target_mode(
    bam_path: str,
    ref_path: str,
    out_dir: str,
    cfg: PipelineConfig,
    target_bed: str | None = None,
    chrom: str | None = None,
    start: int | None = None,
    end: int | None = None,
    refine: bool = True,
    resume: bool = False,
    chrom_filter: str | None = None,
    num_workers: int = 4,
    process_index: int = 0,
    process_count: int = 1,
    mesh=None,
) -> str:
    """Target-mode entry (reference focalsv.py --target_bed | -S/-E).

    With process_count > 1, each host takes its span-balanced shard of the
    region list (parallel/distributed.py; the SLURM-per-chromosome analog),
    writes a per-host VCF, and host 0 merges.  Returns the final VCF path
    (per-host path on non-zero hosts).  ``mesh``: see process_chromosome.
    """
    os.makedirs(out_dir, exist_ok=True)
    bam = bamio.ensure_indexed(bam_path)
    fasta = FastaFile.load(ref_path)
    if target_bed:
        regions = read_bed(target_bed)
        if chrom_filter:
            # --chr_num N restricts the BED to one chromosome
            # (reference focalsv.py extract_bed :59)
            regions = [r for r in regions if r.chrom == chrom_filter]
    else:
        assert chrom is not None and start is not None and end is not None
        regions = [Region(chrom, int(start), int(end))]
    work_dir = out_dir
    if process_count > 1:
        from focalsv_tpu_torch.parallel import distributed as dist
        regions = dist.shard_regions(regions, process_index, process_count)
        # host-scoped work dir: chromosomes can straddle shard boundaries,
        # so per-chromosome outputs must not share paths across hosts
        work_dir = os.path.join(out_dir, f"host{process_index}_work")
        os.makedirs(work_dir, exist_ok=True)
    by_chrom = split_by_chrom(regions)
    chrom_vcfs = []
    for c, regs in sorted(by_chrom.items()):
        cdir = os.path.join(work_dir, c)
        os.makedirs(cdir, exist_ok=True)
        vcf_path = os.path.join(cdir, "FocalSV_Final_SV.vcf")
        if resume and os.path.exists(vcf_path):
            # file-based checkpointing: chromosome outputs persist, rerun
            # skips completed ones (the reference's implicit resume model,
            # SURVEY.md section 5 checkpoint/resume)
            logger.info("%s: resume -- %s exists, skipping", c, vcf_path)
            chrom_vcfs.append(vcf_path)
            continue
        cres = process_chromosome(bam, fasta, c, regs, cfg, out_dir=cdir,
                                  refine=refine, num_workers=num_workers,
                                  mesh=mesh, process_count=process_count)
        write_vcf(vcf_path, cres.records,
                  contigs={c: fasta.lengths()[c]} if c in fasta.seqs else None)
        chrom_vcfs.append(vcf_path)
    if process_count > 1:
        from focalsv_tpu_torch.parallel import distributed as dist
        host_vcf = dist.host_vcf_path(out_dir, process_index)
        tmp = host_vcf + ".tmp"
        merge_vcfs(chrom_vcfs, tmp, contigs=fasta.lengths())
        os.replace(tmp, host_vcf)   # atomic: the merge barrier keys on this
        final_path = os.path.join(out_dir, "FocalSV_Final_SV.vcf")
        if dist.world_size() == process_count:
            # true torch.distributed run: gather every host's records over
            # the process group (NCCL between cards, gloo between CPUs)
            # instead of the filesystem, then dedup ONCE at the gather
            # point -- SVs straddling a shard boundary collapse here
            # (parallel/gather.py).  A collective that fails raises.
            from focalsv_tpu_torch.io.vcf import read_vcf, sort_records
            from focalsv_tpu_torch.parallel.gather import allgather_records
            _, host_records = read_vcf(host_vcf)
            global_records = allgather_records(host_records)
            if process_index != 0:
                return host_vcf
            global_records, _ = dedup_records(sort_records(global_records),
                                              cfg.dedup)
            write_vcf(final_path, sort_records(global_records),
                      contigs=fasta.lengths())
            logger.info("final VCF (collective gather): %s", final_path)
            return final_path
        if process_index != 0:
            return host_vcf
        # no process group of this size (one job per host on a shared file
        # system): host-0 file merge with the same cross-shard dedup at the
        # merge point
        final = dist.merge_host_vcfs(out_dir, process_count,
                                     dedup_cfg=cfg.dedup)
        logger.info("final VCF: %s", final)
        return final
    final = os.path.join(out_dir, "FocalSV_Final_SV.vcf")
    merge_vcfs(chrom_vcfs, final, contigs=fasta.lengths())
    logger.info("final VCF: %s", final)
    return final


def run_auto_mode(
    bam_path: str,
    ref_path: str,
    out_dir: str,
    cfg: PipelineConfig,
    prior_vcf: str | None = None,
    chroms: list[str] | None = None,
    refine: bool = True,
    num_workers: int = 4,
) -> str:
    """Auto-mode entry: step-0 region detection, then target mode
    (reference 0_define_region.py :520-543 + focalsv.py chr loop).

    Step 0's parts (load, coverage, scan, prior, detect, bed) are timed
    into out_dir/log/stage_times.json; each chromosome's target mode
    writes its own under out_dir/<chrom>/log/."""
    timer = StageTimer()
    os.makedirs(out_dir, exist_ok=True)
    with timer.stage("load"):
        bam = bamio.ensure_indexed(bam_path)
        fasta = FastaFile.load(ref_path)
    if chroms is None:
        chroms = [c for c in bam.ref_names if c in fasta.seqs]
    if cfg.data_type != DataType.HIFI:
        # CLR/ONT: min_sig scales with estimated coverage
        # (0_define_region.py:480-502, min_sig = 0.17 x mean_cov)
        from focalsv_tpu_torch.utils.coverage import estimate_bam_cov
        with timer.stage("coverage"):
            mean_cov = estimate_bam_cov(bam, chroms)
        min_sig = max(1, int(cfg.detect.min_sig_cov_fraction * mean_cov))
        import dataclasses as _dc
        cfg = cfg.replace(detect=_dc.replace(cfg.detect, min_sig=min_sig))
        logger.info("auto mode: estimated coverage %.1fx -> min_sig %d",
                    mean_cov, min_sig)
    sig_del: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    sig_ins: dict[str, tuple[np.ndarray, np.ndarray]] = {}
    for c in chroms:
        with timer.stage("scan"):
            scan = _native_chrom_scan(bam, c, cfg)
            if scan is None:
                _, scan = scan_chromosome(bam.fetch(c), c, cfg.read_scan,
                                          genotype=False)
        sig_del[c] = (np.array([s.pos for s in scan.del_sigs], np.int64),
                      np.array([s.length for s in scan.del_sigs], np.int64))
        sig_ins[c] = (np.array([s.pos for s in scan.ins_sigs], np.int64),
                      np.array([s.length for s in scan.ins_sigs], np.int64))
    prior: dict[str, np.ndarray] = {c: np.zeros(0, np.int64) for c in chroms}
    if prior_vcf:
        from focalsv_tpu_torch.io.vcf import read_vcf
        with timer.stage("prior"):
            _, prior_records = read_vcf(prior_vcf)
        for r in prior_records:
            prior.setdefault(r.chrom, np.zeros(0, np.int64))
        by_c: dict[str, list[int]] = {}
        for r in prior_records:
            by_c.setdefault(r.chrom, []).append(r.pos)
        for c, poss in by_c.items():
            prior[c] = np.array(poss, np.int64)
    with timer.stage("detect"):
        regions = detect_regions(sig_del, sig_ins, prior, cfg.detect,
                                 chroms=chroms)
    # clamp to chromosome bounds
    lens = fasta.lengths()
    regions = [Region(r.chrom, max(0, r.start), min(lens[r.chrom], r.end))
               for r in regions if r.chrom in lens]
    bed_path = os.path.join(
        out_dir, f"SV_Regions_{cfg.data_type.value}.bed")
    with timer.stage("bed"):
        write_bed(bed_path, regions)
    logger.info("auto mode: %d SV-rich regions -> %s", len(regions), bed_path)
    log_dir = os.path.join(out_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    timer.dump(os.path.join(log_dir, "stage_times.json"))
    return run_target_mode(bam_path, ref_path, out_dir, cfg,
                           target_bed=bed_path, refine=refine,
                           num_workers=num_workers)
