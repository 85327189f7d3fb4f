"""Share of the traced passes' time with no kernel or copy on the card
(torch.profiler, CPU and CUDA activities)."""


def read(run):
    window = sum(p.tracer.window_s for p in run.traced_passes)
    busy = sum(p.tracer.busy_s for p in run.traced_passes)
    if window <= 0 or busy <= 0:
        return None
    return 100.0 * (1.0 - busy / window)
