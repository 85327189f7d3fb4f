"""The control and the planted faults that the reference has to catch.

Each is a context manager that breaks the program underneath a run, and
puts it back on leaving:

- ``control``: the configuration's guarantee that every read a region
  holds is used, broken as a later change would be tempted to break it to
  cut the host's work: each region is phased and assembled from every
  fourth of its reads (7.5x of the 30x made).  The chromosome's read scan
  still sees every read.
- ``state_unchanged``: the region step returns its output buffer as it was
  allocated (zeros): no phasing, no consensus.
- ``half_batch``: half of the regions of the streamed map are left out.
- ``answer_altered``: the final calls are moved 1 kb where the
  chromosome's calls are produced.

The exchange between chips is not a fault a cell of one chip can have.
"""

from __future__ import annotations

import contextlib

CONTROL_KEEP = 4


@contextlib.contextmanager
def _patched(obj, name, value):
    old = getattr(obj, name)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def control(keep: int = CONTROL_KEEP):
    from focalsv_tpu_torch.io import bam
    real = bam.BamReader.fetch

    def fetch(self, *args, **kwargs):
        for i, rec in enumerate(real(self, *args, **kwargs)):
            if i % keep == 0:
                yield rec
    return _patched(bam.BamReader, "fetch", fetch)


def state_unchanged():
    import torch

    from focalsv_tpu_torch.parallel import region_step as rs
    real = rs.phase_consensus_delta_flat

    def step(src, **kw):
        return torch.zeros_like(real(src, **kw))
    return _patched(rs, "phase_consensus_delta_flat", step)


def half_batch():
    from focalsv_tpu_torch.pipeline import device_exec as dx
    real = dx.streamed_map

    def streamed_map(pool, tile_jobs, *args, **kwargs):
        jobs = [j if i % 2 == 0 else (lambda: None)
                for i, j in enumerate(tile_jobs)]
        return real(pool, jobs, *args, **kwargs)
    return _patched(dx, "streamed_map", streamed_map)


def answer_altered():
    import dataclasses

    from focalsv_tpu_torch.pipeline import main
    real = main.refine_records

    def refine_records(*args, **kwargs):
        kept, dropped = real(*args, **kwargs)
        moved = [dataclasses.replace(r, pos=r.pos + 1000) for r in kept]
        return moved, dropped
    return _patched(main, "refine_records", refine_records)


ALL = dict(control=control, state_unchanged=state_unchanged,
           half_batch=half_batch, answer_altered=answer_altered)
