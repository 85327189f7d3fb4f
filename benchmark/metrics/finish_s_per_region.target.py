"""The host finish of streamed_map (device_stats.json finish_s,
thread-seconds) of the passes run without the tracer, a region."""


def read(run):
    ps = run.host_passes
    n = run.regions_in(ps)
    return run.log_sum("device_stats.json", "finish_s", ps) / n if n else None
