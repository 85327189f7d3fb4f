"""Each chunk's span on the device's stream, a region: device_stats.json
``device_s``, from a CUDA event recorded before the chunk's copy in to
one after its copy out (device_exec.dispatch_packed).  It holds the
card's work and the gaps while the host issues the copy and the step's
launches, so host contention moves it too; the card's own time is
``device_idle_pct.target``'s.  Summed over the passes run without the
tracer, in ms over their regions.  None without a card, or where the
program records no such time."""


def read(run):
    ps = run.host_passes
    s = run.log_sum("device_stats.json", "device_s", ps)
    n = run.regions_in(ps)
    return 1000.0 * s / n if n and s > 0 else None
