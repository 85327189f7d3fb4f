"""Multi-host orchestration: torch.distributed init + per-host region sharding.

Replaces the reference's manual per-chromosome SLURM pattern (README.md:207-213:
one job per chromosome into a shared out_dir, then `cat | vcf-sort`): every
host joins one `torch.distributed` process group, takes its contiguous shard
of the region list (the `split_bed` analog), runs process_chromosome on
its shard, and the hosts' records meet either in a collective gather over
the group (parallel/gather.py) or, where no group was set up, in host 0's
merge of the per-host VCFs on a shared file system.
"""

from __future__ import annotations

import os

from focalsv_tpu_torch.io.bed import Region


def initialize(coordinator: str | None = None, num_processes: int | None = None,
               process_id: int | None = None,
               backend: str | None = None) -> tuple[int, int]:
    """Join the process group of ``num_processes`` processes whose TCP store
    is at ``coordinator`` ("host:port"), as rank ``process_id``.  Returns
    (rank, world size).  A no-op returning (0, 1) for a single process that
    names no coordinator.

    ``backend``: "nccl" by default when the process runs on a card (one
    card a rank) and "gloo" when it was asked for the CPU
    (device.resolve_device); two ranks that share one card name "gloo"."""
    import torch
    import torch.distributed as dist
    if num_processes is None or (num_processes <= 1 and coordinator is None):
        return 0, 1
    if coordinator is None:
        raise ValueError(f"{num_processes} processes need a coordinator")
    from focalsv_tpu_torch.device import resolve_device
    device = resolve_device()
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if backend == "nccl" and device.index is not None:
        torch.cuda.set_device(device)
    dist.init_process_group(backend, init_method=f"tcp://{coordinator}",
                            world_size=num_processes,
                            rank=process_id or 0)
    return dist.get_rank(), dist.get_world_size()


def world_size() -> int:
    """The size of the process group this process joined (1 without one)."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def shutdown() -> None:
    """Leave the process group, if this process joined one."""
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()


def shard_regions(regions: list[Region], process_index: int,
                  process_count: int) -> list[Region]:
    """Contiguous per-host shard of the genome-sorted region list, balanced
    by total region span (not count), so hosts finish together."""
    if process_count <= 1:
        return regions
    spans = [max(r.span, 1) for r in regions]
    total = sum(spans)
    target = total / process_count
    shards: list[list[Region]] = [[] for _ in range(process_count)]
    acc = 0.0
    for r, s in zip(regions, spans):
        idx = min(int(acc / target), process_count - 1)
        shards[idx].append(r)
        acc += s
    return shards[process_index]


def host_vcf_path(out_dir: str, process_index: int) -> str:
    return os.path.join(out_dir, f"host{process_index}.vcf")


def merge_host_vcfs(out_dir: str, process_count: int,
                    final_path: str | None = None,
                    timeout_s: float | None = None,
                    poll_s: float = 0.5,
                    dedup_cfg=None) -> str:
    """Host-0 merge of every host's shard VCF (the cat|vcf-sort analog).

    This is the MERGE BARRIER: host 0 waits (bounded) for every peer's
    atomically-renamed host*.vcf before merging.  A missing host after the
    timeout raises with the missing hosts named -- a straggler's calls must
    never be silently dropped from the genome-wide VCF (reference analog:
    the per-chromosome SLURM jobs all write before the manual cat|vcf-sort,
    README.md:207-213).

    ``timeout_s`` defaults to env FOCALSV_MERGE_TIMEOUT_S (1800 if unset) so
    long WGS runs with >30 min inter-host skew can raise it without code
    changes.  With ``dedup_cfg`` the merged records get one cross-shard
    redundancy pass, collapsing duplicate calls of SVs that straddle a host
    shard boundary.
    """
    import time

    from focalsv_tpu_torch.io.vcf import merge_vcfs
    if timeout_s is None:
        timeout_s = float(os.environ.get("FOCALSV_MERGE_TIMEOUT_S", "1800"))
    paths = [host_vcf_path(out_dir, i) for i in range(process_count)]
    deadline = time.monotonic() + timeout_s
    while True:
        missing = [p for p in paths if not os.path.exists(p)]
        if not missing:
            break
        if time.monotonic() >= deadline:
            raise RuntimeError(
                f"merge barrier timed out after {timeout_s:.0f}s: "
                f"{len(missing)}/{process_count} host VCFs missing "
                f"({', '.join(os.path.basename(m) for m in missing)}); "
                "refusing to emit a partial genome-wide VCF")
        time.sleep(poll_s)
    final_path = final_path or os.path.join(out_dir, "FocalSV_Final_SV.vcf")
    merge_vcfs(paths, final_path)
    if dedup_cfg is not None:
        from focalsv_tpu_torch.calling.dedup import dedup_records
        from focalsv_tpu_torch.io.vcf import read_vcf, sort_records, write_vcf
        header, recs = read_vcf(final_path)
        kept, removed = dedup_records(sort_records(recs), dedup_cfg)
        if removed:
            write_vcf(final_path, sort_records(kept))
    return final_path
