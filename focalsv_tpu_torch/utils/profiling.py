"""First-class tracing/profiling (the reference has none; SURVEY.md section 5
calls for device profiler traces + per-stage timing as first-class)."""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict

import torch


class StageTimer:
    """Accumulating per-stage wall-clock timers with JSON summary."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def summary(self) -> dict:
        return {
            name: dict(seconds=round(self.totals[name], 4),
                       calls=self.counts[name])
            for name in sorted(self.totals, key=lambda n: -self.totals[n])
        }

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host and, with a card, the CUDA device:
    log_dir/trace.json, a Chrome trace (viewable in Perfetto)."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


GLOBAL_TIMER = StageTimer()
