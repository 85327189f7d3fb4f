"""Kernel B2 (region_step_kernel, delta source) against its least time
(focalbench/work.py, from the regions' own sizes): the traced passes'
least seconds over B2's device seconds in their trace, in %."""

from focalbench.work import region_step_least_s


def read(run):
    b2 = sum(v for k, v in run.device_ops.items()
             if "region_step_kernel" in k and "Rows" not in k)
    if b2 <= 0:
        return None
    least, _ = region_step_least_s(run.inputs.counts)
    return 100.0 * least * len(run.traced_passes) / b2
