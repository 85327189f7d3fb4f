"""The region outputs (span ``region_write`` of pipeline/main.py's finish:
_write_region_artifacts with its makedirs, region_phased.bam a record at a
time, then BGZF), thread-seconds, from the chromosomes' stage_times.json
of the passes run without the tracer, a region.  None where the program
records no such span."""


def read(run):
    ps = run.host_passes
    s = run.stage_sum(("region_write",), top_level=False, passes=ps)
    n = run.regions_in(ps)
    return s / n if n and s > 0 else None
