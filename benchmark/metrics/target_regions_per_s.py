"""BED regions of the completed run_target_mode passes over the sum of
their wall seconds."""


def read(run):
    return run.regions / run.wall_s if run.wall_s > 0 else None
