"""CPU seconds of the process, all threads and children (getrusage), over
the timed passes run without the tracer, a region."""


def read(run):
    ps = run.host_passes
    n = run.regions_in(ps)
    return sum(p.cpu_s for p in ps) / n if n else None
