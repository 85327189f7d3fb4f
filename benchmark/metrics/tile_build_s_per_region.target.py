"""The fetch and tile build of streamed_map (device_stats.json
tile_build_s, thread-seconds) of the passes run without the tracer, a
region."""


def read(run):
    ps = run.host_passes
    n = run.regions_in(ps)
    return (run.log_sum("device_stats.json", "tile_build_s", ps) / n
            if n else None)
