"""Chromosome calling (pipeline/main.py::process_chromosome: read_scan,
fp_filter_dedup, refine) from the stage_times.json of each pass run
without the tracer, a region."""


def read(run):
    ps = run.host_passes
    s = run.stage_sum(("read_scan", "fp_filter_dedup", "refine"),
                      top_level=False, passes=ps)
    n = run.regions_in(ps)
    return s / n if n else None
