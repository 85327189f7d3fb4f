"""The fetch of each region (span ``region_fetch`` of
pipeline/main.py::fetch_and_tile: bam.fetch with its BGZF decoding, and
fasta.fetch), thread-seconds, from the chromosomes' stage_times.json of
the passes run without the tracer, a region.  None where the program
records no such span."""


def read(run):
    ps = run.host_passes
    s = run.stage_sum(("region_fetch",), top_level=False, passes=ps)
    n = run.regions_in(ps)
    return s / n if n and s > 0 else None
