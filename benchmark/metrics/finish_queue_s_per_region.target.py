"""The finishes' wait for a pool thread (``finish_queue`` of
device_exec.streamed_map: from a region's finish submitted to its start),
seconds, from the chromosomes' stage_times.json of the passes run without
the tracer, a region.  None where the program records no such wait."""


def read(run):
    ps = run.host_passes
    s = run.stage_sum(("finish_queue",), top_level=False, passes=ps)
    n = run.regions_in(ps)
    return s / n if n and s > 0 else None
