"""Collective SV-record gather: all_gather instead of file merge.

The reference's multi-node story is "one SLURM job per chromosome into a
shared out_dir, then `cat | vcf-sort`" (README.md:207-213, focalsv.py:66-70)
-- the filesystem as the all-gather fabric.  Here the gather point rides the
process group's interconnect: each host serializes its shard's VCF records
into one flat byte payload plus a per-record length vector, both are
all_gathered across processes (`torch.distributed`: NCCL between cards,
gloo between CPUs), and host 0 decodes, cross-shard-dedups once, and writes
the genome-wide VCF.

Wire format: OFFSET-ENCODED, not fixed-width.  A padded (N, W_max) matrix
would let one long-ALT INS record (a 50 kb insertion carries its full
sequence) set the pad width for every record on every host -- an
O(N * max_len) blow-up over DCN.  Concatenated bytes + lengths keep the
payload at O(total record bytes) like the reference's `cat`
(focalsv.py:66-70); the only padding is to the largest single HOST's
totals, so wire bytes stay within process_count * max_host_bytes.
"""

from __future__ import annotations

import numpy as np

from focalsv_tpu_torch.io.vcf import VcfRecord, parse_line
from focalsv_tpu_torch.utils.logging import get_logger

logger = get_logger("gather")


def encode_records(records: list[VcfRecord]) -> tuple[np.ndarray, np.ndarray]:
    """Records -> (flat uint8 of concatenated VCF body lines, lengths)."""
    lines = [r.to_line().encode() for r in records]
    lens = np.array([len(b) for b in lines], np.int64)
    flat = (np.frombuffer(b"".join(lines), np.uint8).copy()
            if lines else np.zeros(0, np.uint8))
    return flat, lens


def decode_records(flat: np.ndarray, lens: np.ndarray) -> list[VcfRecord]:
    """(flat bytes, lengths) -> records."""
    out: list[VcfRecord] = []
    off = 0
    for n in lens:
        n = int(n)
        line = bytes(flat[off : off + n]).decode(errors="replace").strip()
        off += n
        if not line:
            continue
        rec = parse_line(line)
        if rec is not None:
            out.append(rec)
    return out


def _process_allgather(x: np.ndarray) -> np.ndarray:
    """Every process's ``x`` (same shape and dtype on all of them), stacked
    by rank: (world size, *x.shape).  Under NCCL the tensors live on the
    process's card, under gloo on the CPU."""
    import torch
    import torch.distributed as dist
    t = torch.from_numpy(np.ascontiguousarray(x))
    if dist.get_backend() == "nccl":
        t = t.to(torch.device("cuda", torch.cuda.current_device()))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).cpu().numpy()


def allgather_records(records: list[VcfRecord]) -> list[VcfRecord]:
    """All hosts' records, gathered over the process group.

    Every process of the group must call this (it is a collective).
    Returns the concatenated global record list on every host, ordered by
    rank.  Single-process: returns ``records`` unchanged.
    """
    from focalsv_tpu_torch.parallel.distributed import world_size
    if world_size() <= 1:
        return list(records)

    flat, lens = encode_records(records)
    # round 1: agree on the global (max record count, max payload bytes)
    dims = np.array([lens.size, flat.size], np.int64)
    all_dims = _process_allgather(dims)
    n_max = int(all_dims[:, 0].max())
    b_max = int(all_dims[:, 1].max())
    # round 2: lengths and flat payload, padded to the largest host only
    lens_p = np.zeros(max(n_max, 1), np.int64)
    lens_p[: lens.size] = lens
    flat_p = np.zeros(max(b_max, 1), np.uint8)
    flat_p[: flat.size] = flat
    g_lens = _process_allgather(lens_p)
    g_flat = _process_allgather(flat_p)
    logger.info("gathered %d records of %d processes: %d bytes on the wire "
                "in three collectives", int(all_dims[:, 0].sum()),
                g_lens.shape[0],
                all_dims.nbytes + g_lens.nbytes + g_flat.nbytes)
    out: list[VcfRecord] = []
    for p in range(g_lens.shape[0]):
        n_p = int(all_dims[p, 0])
        out.extend(decode_records(g_flat[p], g_lens[p, :n_p]))
    return out
