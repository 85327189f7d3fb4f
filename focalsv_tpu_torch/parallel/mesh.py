"""Device mesh + region-data-parallel dispatch.

FocalSV's only parallelism is embarrassing data-parallelism over genomic
regions (joblib within a node + one SLURM job per chromosome + `cat|vcf-sort`
as the all-gather; SURVEY.md section 2.3).  The reference shards fixed-shape
region tiles over a one-axis `jax.sharding.Mesh` and runs every per-region
step under `shard_map`.  That mesh lives in one process, and so does this
one: a `Mesh` is an ordered tuple of `torch.device`s, one per shard.  The
batch is split into equal shards, shard k runs on device k on a stream of
its own (copy in from pinned memory, step, copy out), and the results come
back in shard order.  A device may appear more than once: then its shards
are logical ones that share the card (the CPU tests run that way, and so
does a machine with one card).

Cross-process collectives are not here: see parallel/distributed.py and
parallel/gather.py.
"""

from __future__ import annotations

import numpy as np
import torch

from focalsv_tpu_torch.device import resolve_device
from focalsv_tpu_torch.ops import align as alignops

DATA_AXIS = "regions"


class Mesh:
    """The shards' devices, in shard order.  Hashable and comparable by its
    devices; the shards' CUDA streams are made on first use and kept."""

    def __init__(self, devices):
        self.devices = tuple(
            torch.device("cuda", torch.cuda.current_device())
            if torch.device(d) == torch.device("cuda") else torch.device(d)
            for d in devices)
        if not self.devices:
            raise ValueError("a mesh needs at least one device")
        kinds = {d.type for d in self.devices}
        if len(kinds) != 1 or not kinds <= {"cuda", "cpu"}:
            raise ValueError(f"a mesh is all cuda or all cpu, got "
                             f"{[str(d) for d in self.devices]}")
        self._streams: dict[int, torch.cuda.Stream] = {}

    @property
    def size(self) -> int:
        return len(self.devices)

    def stream(self, k: int):
        """Shard k's stream (None on the CPU)."""
        dev = self.devices[k]
        if dev.type != "cuda":
            return None
        if k not in self._streams:
            self._streams[k] = torch.cuda.Stream(device=dev)
        return self._streams[k]

    def __eq__(self, other):
        return isinstance(other, Mesh) and self.devices == other.devices

    def __hash__(self):
        return hash(self.devices)

    def __repr__(self):
        return f"Mesh({[str(d) for d in self.devices]})"


def make_mesh(n_devices: int | None = None, devices=None) -> Mesh:
    """A mesh of the first ``n_devices`` cards (all of them by default), one
    shard a card; asking for more cards than there are raises.  ``devices``
    names the shards' devices outright, and may repeat one.  When the port
    was asked for the CPU (device.resolve_device) the shards are
    ``n_devices`` logical ones on it."""
    if devices is not None:
        if n_devices is not None and n_devices != len(devices):
            raise ValueError(f"{n_devices} devices asked for, "
                             f"{len(devices)} named")
        return Mesh(devices)
    if resolve_device().type == "cpu":
        return Mesh([torch.device("cpu")] * (n_devices or 1))
    have = torch.cuda.device_count()
    n = have if n_devices is None else n_devices
    if not 1 <= n <= have:
        raise RuntimeError(f"a mesh of {n} cards was asked for and "
                           f"{have} are present")
    return Mesh([torch.device("cuda", i) for i in range(n)])


def mesh_for(device: torch.device, device_count: int,
             process_count: int = 1) -> Mesh | None:
    """The mesh a device-mode run splits its region chunks over, or None.

    Every card, when the run asked for the unnamed ``cuda`` device, is one
    process and sees more than one card.  A named ``cuda:N``, a rank of a
    group of several processes, a single card or the CPU get no mesh: the
    run stays on its own device (ranks that share a host would otherwise
    each take every card)."""
    if device.type != "cuda" or device.index is not None:
        return None
    if process_count > 1 or device_count < 2:
        return None
    return Mesh([torch.device("cuda", i) for i in range(device_count)])


def pad_batch_to_devices(arrays: list[np.ndarray], n_devices: int):
    """Pad the leading (batch) axis to a multiple of the mesh size."""
    b = arrays[0].shape[0]
    pad = (-b) % n_devices
    if pad == 0:
        return arrays, b
    out = []
    for a in arrays:
        widths = [(0, pad)] + [(0, 0)] * (a.ndim - 1)
        out.append(np.pad(a, widths))
    return out, b


class PendingResult:
    """A (G, ...) result on its way to the host.

    On CUDA the result is copied into pinned host memory by asynchronous
    copies queued right behind the step, one per shard, and each of
    ``events`` marks the arrival of one; ``is_ready`` polls them and
    reading the array waits for them.  A CPU result has no event and is
    ready as soon as it exists.  ``started``, a timing event recorded
    before the copy in, with timing events in ``events``, gives the span
    on the stream from the copy in to the end of the copy out, the host's
    issue gaps included (``device_s``)."""

    def __init__(self, host: torch.Tensor, events=(), started=None):
        self.host = host
        self.events = tuple(events)
        self.started = started

    def is_ready(self) -> bool:
        return all(e.query() for e in self.events)

    def wait(self) -> torch.Tensor:
        for e in self.events:
            e.synchronize()
        return self.host

    def device_s(self) -> float:
        """Seconds on the stream from ``started`` to the last event, once
        the result has arrived; 0.0 without a timing event."""
        if self.started is None:
            return 0.0
        self.wait()
        return self.started.elapsed_time(self.events[-1]) / 1e3

    def __array__(self, dtype=None, copy=None):
        out = self.wait().numpy()
        return out if dtype is None else out.astype(dtype)


def host_array(x) -> np.ndarray:
    """A host array of a numpy array or a CPU tensor (no copy)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def split_batch(arrays, n: int) -> list[tuple]:
    """Equal shards of host arrays along their leading axis, in order."""
    arrays = [host_array(a) for a in arrays]
    B = arrays[0].shape[0]
    if B % n:
        raise ValueError(f"a batch of {B} does not split over {n} shards "
                         "(pad_batch_to_devices)")
    g = B // n
    return [tuple(np.ascontiguousarray(a[k * g : (k + 1) * g])
                  for a in arrays) for k in range(n)]


def for_each_shard(mesh: Mesh, parts: list[tuple], body) -> list:
    """``body(k, *tensors)`` for every shard k with its host arrays on the
    shard's device.  On CUDA the copy from pinned memory and everything
    ``body`` queues run on the shard's own stream, so shards overlap;
    whatever ``body`` returns is paired with an event recorded behind it
    (None on the CPU).  Tensors made under a shard's stream belong to that
    stream: read them elsewhere only after the event, and tell the
    allocator (``record_stream``) before dropping them."""
    if len(parts) != mesh.size:
        raise ValueError(f"{len(parts)} shards for a mesh of {mesh.size}")
    out = []
    for k, (dev, arrays) in enumerate(zip(mesh.devices, parts)):
        srcs = [torch.from_numpy(a) for a in arrays]
        if dev.type != "cuda":
            out.append((body(k, *srcs), None))
            continue
        with torch.cuda.stream(mesh.stream(k)):
            args = [s.pin_memory().to(dev, non_blocking=True) for s in srcs]
            res = body(k, *args)
            event = torch.cuda.Event()
            event.record()
        out.append((res, event))
    return out


def map_to_host(mesh: Mesh, parts: list[tuple], fn) -> tuple[list, list]:
    """``fn(*tensors)`` -> tensor or tuple of tensors with a leading batch
    axis, for every shard; the outputs land in host tensors (pinned on
    CUDA) holding all shards in order.  Returns (host tensors, events):
    the copies are asynchronous, and the host tensors hold the results
    once every event has passed."""
    hosts: list[torch.Tensor] = []
    cuda = mesh.devices[0].type == "cuda"

    def body(k, *args):
        outs = fn(*args)
        if isinstance(outs, torch.Tensor):
            outs = (outs,)
        if not hosts:
            hosts.extend(torch.empty((o.shape[0] * mesh.size, *o.shape[1:]),
                                     dtype=o.dtype, pin_memory=cuda)
                         for o in outs)
        for h, o in zip(hosts, outs):
            g = o.shape[0]
            h[k * g : (k + 1) * g].copy_(o, non_blocking=cuda)

    events = [e for _, e in for_each_shard(mesh, parts, body)
              if e is not None]
    return hosts, events


def gather_shards(mesh: Mesh, shard_results: list) -> list:
    """Concatenate the shards' output tuples on the first shard's device in
    shard order: the caller's stream waits for each shard's event, copies
    peer to peer where a shard sits on another card, and the shards'
    tensors are marked as used by it."""
    device = mesh.devices[0]
    if device.type != "cuda":
        return [None if outs[0] is None else torch.cat(outs)
                for outs in zip(*(res for res, _ in shard_results))]
    current = torch.cuda.current_stream(device)
    for _, event in shard_results:
        current.wait_event(event)
    gathered = []
    with torch.cuda.device(device):
        for outs in zip(*(res for res, _ in shard_results)):
            if outs[0] is None:
                gathered.append(None)
                continue
            gathered.append(torch.cat([o.to(device, non_blocking=True)
                                       for o in outs]))
            for o in outs:
                # freed by the caller while this stream may still read it
                o.record_stream(current)
    return gathered


def sharded_banded_align(
    q, q_len, t, t_len, d_lo, *, mesh: Mesh, band: int = 256,
    match: int = 2, mismatch: int = -4, gap_open: int = -4,
    gap_extend: int = -2, store_dirs: bool = True,
):
    """`banded_align` sharded over the mesh: host arrays in, each shard's
    DP on its device (kernel B1 on a card, the plain version on the CPU),
    scores (B,) and dirs (B, Lq, band) back on the mesh's first device in
    batch order (dirs None without ``store_dirs``).

    The DP is purely data-parallel: no shard needs another's cells."""
    kw = dict(band=band, match=match, mismatch=mismatch, gap_open=gap_open,
              gap_extend=gap_extend, store_dirs=store_dirs)
    parts = split_batch((q, q_len, t, t_len, d_lo), mesh.size)
    shards = for_each_shard(
        mesh, parts, lambda k, *a: alignops.banded_align(*a, **kw))
    scores, dirs = gather_shards(mesh, shards)
    return scores, dirs


def sharded_sv_candidate_step(q, q_len, t, t_len, d_lo, *, mesh: Mesh):
    """One full device step of the region batch: banded alignment of each
    region's query (contig/read) against its reference window, a reduction
    on the shard's device to fixed-width SV-candidate summaries (score, D
    cells, I cells), and a gather so that every shard holds the whole
    candidate table (the cross-region dedup input).  This is the step the
    multi-device dry run exercises end to end.

    Returns (scores (B,), cand (B, 3)) on the mesh's first device and
    global_cand, a list with each shard's copy of the (B, 3) table on its
    device."""
    def local(k, q, q_len, t, t_len, d_lo):
        scores, dirs = alignops.banded_align(q, q_len, t, t_len, d_lo,
                                             band=128, store_dirs=True)
        # per region, the count of D- and of I-sourced cells
        hdir = dirs & alignops.DIR_H_MASK
        n_del = (hdir == 1).sum(dim=(1, 2), dtype=torch.int32)
        n_ins = (hdir == 2).sum(dim=(1, 2), dtype=torch.int32)
        return scores, torch.stack([scores, n_del, n_ins], dim=1)

    parts = split_batch((q, q_len, t, t_len, d_lo), mesh.size)
    shards = for_each_shard(mesh, parts, local)
    scores, cand = gather_shards(mesh, shards)
    if cand.is_cuda:
        torch.cuda.current_stream(cand.device).synchronize()
    global_cand = [cand if dev == cand.device else cand.to(dev)
                   for dev in mesh.devices]
    return scores, cand, global_cand
