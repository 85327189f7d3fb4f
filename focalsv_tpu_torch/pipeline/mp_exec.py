"""Multi-process region executor: GIL-free host pipeline + one device owner.

The streamed single-process executor (device_exec.streamed_map) is limited
by the GIL: tile building and the ragged per-region finish are Python, so
with N threads on a 2-core host the Python fraction serializes.  Here the
host work runs in worker PROCESSES while the parent process owns the (one
and only) CUDA context:

    child k:  load region -> build tile -> send wire arrays ----+
              ... later: receive per-region result -> finish    |
    parent:   bucketize tile stubs  <---------------------------+
              pack chunk -> device dispatch (async)
              result ready -> slice per region -> route to owner child

Children are spawned, hide the card (CUDA_VISIBLE_DEVICES="") and pin the
port to the CPU (FOCALSV_TORCH_DEVICE=cpu) before they import it, so they
never initialise CUDA; everything they run is numpy + the native C++
kernels.  They do not reach the parent's DP batcher either: a banded-DP job
of a child (OLC assembly, the aligner) runs the host DP, as in the JAX
package.  Each child reports ``torch.cuda.is_initialized()`` with its pass
statistics (``cuda_initialized``, summed over the children: 0 is the only
healthy value).  The parent does only cheap packing and dispatch, so it
stays off the critical path.

Reference contrast: the reference gets multi-core host parallelism from
joblib/multiprocessing per stage (1_crop_bam.py:119, run_assembly.py:43)
with the filesystem as the fabric; here the fabric is queues carrying the
same compact wire buffers the device uses, and the device is shared.

Bit-parity contract: identical outputs to streamed_map (same build_tile,
same kernels, same finish_tile) -- enforced by tests/test_torch_mp_exec.py.
"""

from __future__ import annotations

import multiprocessing as mp
import os
import queue as queue_mod
import traceback

import numpy as np

from focalsv_tpu_torch.utils.logging import get_logger

logger = get_logger("mp_exec")

_STOP = "stop"


class _TileStub:
    """Parent-side stand-in for a RegionTile: just the wire attributes."""

    __slots__ = ("encoding", "ref_codes", "row_starts", "row_lens", "subs",
                 "dels", "nib", "q_starts", "region_len")

    def __init__(self, d: dict):
        for k in self.__slots__:
            setattr(self, k, d.get(k))


def _tile_wire_payload(tile) -> dict:
    """The pickled subset of a RegionTile the parent needs to pack it."""
    if tile.encoding == "delta":
        return dict(encoding="delta", ref_codes=tile.ref_codes,
                    row_starts=tile.row_starts, row_lens=tile.row_lens,
                    subs=tile.subs, dels=tile.dels,
                    region_len=tile.region_len)
    return dict(encoding="dense", nib=tile.nib, q_starts=tile.q_starts,
                region_len=tile.region_len)


def _child_main(cid: int, n_children: int, cfg_bytes: bytes, req_q, cmd_q):
    """Worker process: builds tiles, ships wire payloads, finishes regions.

    Hides the card and pins the port to the CPU before any focalsv import
    -- the CUDA context must only exist in the parent."""
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    os.environ["FOCALSV_TORCH_DEVICE"] = "cpu"
    import pickle

    import torch

    from focalsv_tpu_torch.pipeline import device_exec as dx

    torch.set_num_threads(1)     # one core a child: the children are the pool

    cfg = pickle.loads(cfg_bytes)

    def run_pass(jobs, collect):
        import time as _t
        stats = {"tile_build_s": 0.0, "finish_s": 0.0, "n_host_fallback": 0}
        tiles = {}
        outs = {}

        def finish(idx, tile, dev):
            t0 = _t.perf_counter()
            r = dx.process_region_device(tile, dev, cfg)
            stats["finish_s"] += _t.perf_counter() - t0
            outs[idx] = (len(r.records),
                         r if collect == "records" else None)

        def drain(block: bool):
            try:
                msg = cmd_q.get(block, 0.25 if block else None)
            except queue_mod.Empty:
                return False
            if msg[0] == "dev":
                _, idx, rbuf = msg
                tile = tiles.pop(idx)
                dev = _decode_region(rbuf, tile, cfg)
                if dev is None:          # RLE run-budget overflow
                    stats["n_host_fallback"] += 1
                finish(idx, tile, dev)
                return True
            raise RuntimeError(f"unexpected child command {msg[0]}")

        for idx, job in jobs:
            t0 = _t.perf_counter()
            tile = _build_tile_job(job, cfg, dx)
            stats["tile_build_s"] += _t.perf_counter() - t0
            key = dx._bucket_key(tile, cfg) if tile is not None else None
            if tile is None:
                outs[idx] = (0, None)
            elif key is None:
                stats["n_host_fallback"] += 1
                finish(idx, tile, None)
            else:
                tiles[idx] = tile
                pl = _tile_wire_payload(tile)
                if isinstance(job[1], str):
                    # the parent re-loads the reference from disk instead
                    # of paying pickle+unpickle of the largest wire section
                    pl["ref_codes"] = None
                req_q.put(("tile", cid, idx, key, pl))
            while drain(block=False):
                pass
        req_q.put(("done_build", cid))
        while tiles:
            drain(block=True)
        stats["cuda_initialized"] = int(torch.cuda.is_initialized())
        req_q.put(("finished", cid, outs, stats))

    while True:
        try:
            msg = cmd_q.get()
            if msg[0] == _STOP:
                return
            if msg[0] == "run":
                run_pass(msg[1], msg[2])
        except Exception:
            req_q.put(("error", cid, traceback.format_exc()))
            return


def _build_tile_job(job, cfg, dx):
    """(bam_path, ref_path_or_array, chrom) -> RegionTile."""
    bam_path, ref, chrom = job
    from focalsv_tpu_torch.io.bam import BamReader
    reads = list(BamReader(bam_path))
    if isinstance(ref, str):
        ref = np.load(ref)
    return dx.build_tile(reads, ref, 0, chrom, cfg)


def _decode_region(payload: tuple, tile, cfg):
    """One region's (bucket key, flat buffer) -> finish_tile's dev tuple
    (decode_chunk semantics, single region).  None on RLE overflow."""
    from focalsv_tpu_torch.pipeline.device_exec import drle_of
    from focalsv_tpu_torch.parallel.wire import unflatten_result, \
        unflatten_result_rle
    key, rbuf = payload
    Rp, Lp = key[1], key[2]
    R = len(tile.usable)
    L = tile.region_len
    S = cfg.phasing.max_sites
    Drle = drle_of(key)
    if Drle:
        dec = unflatten_result_rle(rbuf, Rp, S, Drle, tile.ref_codes)
        if dec is None:
            return None       # run-budget overflow: host fallback
    else:
        dec = unflatten_result(rbuf, Rp, Lp, S)
    (site_pos, n_sites, hp, sym, cov, sa0, sa1, site_h,
     conn, read_block) = dec
    n = n_sites
    return (site_pos[:n], n, hp[:R], sym[:, :L], cov[:, :L],
            sa0[:n], sa1[:n], site_h[:n], conn[:n], read_block[:R])


class MpRegionExecutor:
    """Parent-side coordinator.  Persistent across passes (children stay
    warm); the device dispatch path is identical to streamed_map's: one
    ``device``, or a ``mesh`` of several (parallel/mesh.py) over which the
    parent splits each chunk.  Children hide every card either way."""

    def __init__(self, cfg, n_children: int = 2, device=None, mesh=None):
        import pickle

        from focalsv_tpu_torch.pipeline.device_exec import _device_of
        self.cfg = cfg
        self.mesh = mesh
        self.device, self.n_devices = _device_of(device, mesh)
        ctx = mp.get_context("spawn")
        self.req_q = ctx.Queue()
        self.cmd_qs = [ctx.Queue() for _ in range(n_children)]
        cb = pickle.dumps(cfg)
        self.procs = [
            ctx.Process(target=_child_main,
                        args=(i, n_children, cb, self.req_q, self.cmd_qs[i]),
                        daemon=True)
            for i in range(n_children)]
        for p in self.procs:
            p.start()
        self.n_children = n_children

    def run(self, jobs: list, collect: str = "count",
            stats: dict | None = None) -> list:
        """Process every job; returns per-job (n_records, result|None).

        ``jobs[i]`` = (bam_path, ref_path, chrom); results ordered by job
        index.  ``collect="records"`` ships full RegionResults back."""
        from focalsv_tpu_torch.pipeline import device_exec as dx
        cfg, device, mesh = self.cfg, self.device, self.mesh
        n_devices = self.n_devices
        st = stats if stats is not None else {}
        for k in ("device_s", "h2d_bytes", "d2h_bytes", "tile_build_s",
                  "finish_s"):
            st.setdefault(k, 0.0)
        st.setdefault("n_chunks", 0)
        st.setdefault("n_host_fallback", 0)
        st.setdefault("cuda_initialized", 0)

        # interleaved assignment balances the size mix across children
        for cid in range(self.n_children):
            share = [(i, jobs[i]) for i in range(cid, len(jobs),
                                                 self.n_children)]
            self.cmd_qs[cid].put(("run", share, collect))

        owner = {}                       # job idx -> child id
        buckets: dict[tuple, list] = {}  # key -> [(idx, stub)]
        pending: list = []               # (chunk_idxs, key, G, res)
        done_build = 0
        finished: dict[int, tuple] = {}
        child_stats: list[dict] = []

        def flush(key, force: bool):
            # tails pad to the full batch shape, as in streamed_map
            G = dx._batch_size(key, cfg, n_devices)
            items = buckets.get(key, [])
            while items and (len(items) >= G or force):
                take, items = items[:G], items[G:]
                idxs = [i for i, _ in take]
                stubs = [s for _, s in take]
                buf = dx.pack_chunk(stubs, list(range(len(stubs))), key, G)
                res = dx.dispatch_packed(buf, key, G, cfg, device, mesh)
                st["n_chunks"] += 1
                st["h2d_bytes"] += buf.size
                pending.append((idxs, key, G, res))
            buckets[key] = items

        def route(idxs, key, G, res):
            bufs = np.asarray(res)
            st["device_s"] += res.device_s()
            st["d2h_bytes"] += len(idxs) * dx._d2h_bytes_per_region(key, cfg)
            for g, idx in enumerate(idxs):
                self.cmd_qs[owner[idx]].put(
                    ("dev", idx, (key, bufs[g].copy())))

        def drain_ready():
            while pending:
                idxs, key, G, res = pending[0]
                if not res.is_ready():    # a device failure raises here
                    return
                pending.pop(0)
                route(idxs, key, G, res)

        idle_checks = 0
        while len(finished) < self.n_children:
            try:
                msg = self.req_q.get(timeout=0.002)
            except queue_mod.Empty:
                drain_ready()
                idle_checks += 1
                if idle_checks % 500 == 0:   # ~1 s of idling
                    for cid, proc in enumerate(self.procs):
                        if cid not in finished and not proc.is_alive():
                            raise RuntimeError(
                                f"mp child {cid} died (exitcode "
                                f"{proc.exitcode}) without reporting -- "
                                "native crash or OOM kill")
                continue
            idle_checks = 0
            kind = msg[0]
            if kind == "tile":
                _, cid, idx, key, payload = msg
                owner[idx] = cid
                if payload.get("ref_codes") is None \
                        and payload["encoding"] == "delta":
                    payload["ref_codes"] = np.load(jobs[idx][1])
                buckets.setdefault(key, []).append((idx, _TileStub(payload)))
                flush(key, force=False)
                drain_ready()
            elif kind == "done_build":
                done_build += 1
                if done_build == self.n_children:
                    for key in sorted(buckets):
                        flush(key, force=True)
            elif kind == "finished":
                _, cid, outs, cstats = msg
                finished[cid] = outs
                child_stats.append(cstats)
            elif kind == "error":
                raise RuntimeError(f"mp child {msg[1]} failed:\n{msg[2]}")
            # blocking-drain any completed dispatches in order
            while pending and done_build == self.n_children:
                idxs, key, G, res = pending.pop(0)
                route(idxs, key, G, res)
        for cs in child_stats:
            for k, v in cs.items():
                st[k] = st.get(k, 0) + v
        merged: dict[int, tuple] = {}
        for outs in finished.values():
            merged.update(outs)
        return [merged.get(i, (0, None)) for i in range(len(jobs))]

    def close(self):
        for q in self.cmd_qs:
            try:
                q.put((_STOP,))
            except Exception:
                pass
        for p in self.procs:
            p.join(timeout=5)
            if p.is_alive():
                p.terminate()
                p.join(timeout=5)
            if p.is_alive():
                p.kill()
                p.join()
        # end the queues' feeder threads and drop their pipes, so nothing of
        # the executor is left to the interpreter's exit
        for q in [self.req_q, *self.cmd_qs]:
            q.close()
            q.cancel_join_thread()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
