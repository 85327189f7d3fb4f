"""First-class tracing/profiling (the reference has none; SURVEY.md section 5
calls for device profiler traces + per-stage timing as first-class)."""

from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import defaultdict

import torch
from torch.autograd import profiler as _autograd_profiler


def profiler_active() -> bool:
    """True while a torch.profiler session runs in this process, whichever
    thread started it (``torch.autograd._profiler_enabled`` answers for
    the calling thread only)."""
    return _autograd_profiler._is_profiler_enabled


class StageTimer:
    """Spans, safe to share between threads, with a JSON summary:
    ``{name: {seconds, calls[, cpu_s]}}``.

    - ``stage(name)``: a span of the calling thread, its wall seconds and
      its own CPU seconds (``time.thread_time``); while a torch.profiler
      session runs, also a ``record_function(name)`` range, so the span
      shows in the profiler's trace on its clock and thread.
    - ``add(name, seconds)``: an interval that one thread starts and
      another ends (a queue wait): seconds and calls, no CPU seconds.

    Spans are meant per region, chunk, job or batch, never per read,
    record or block."""

    def __init__(self):
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.cpu: dict[str, float] = defaultdict(float)
        self._lock = threading.Lock()

    @contextlib.contextmanager
    def stage(self, name: str):
        with (torch.profiler.record_function(name) if profiler_active()
              else contextlib.nullcontext()):
            t0 = time.perf_counter()
            c0 = time.thread_time()
            try:
                yield
            finally:
                dt = time.perf_counter() - t0
                dc = time.thread_time() - c0
                with self._lock:
                    self.totals[name] += dt
                    self.counts[name] += 1
                    self.cpu[name] += dc

    def add(self, name: str, seconds: float) -> None:
        with self._lock:
            self.totals[name] += seconds
            self.counts[name] += 1

    def seconds(self, name: str) -> float:
        with self._lock:
            return self.totals.get(name, 0.0)

    def summary(self) -> dict:
        with self._lock:
            out = {}
            for name in sorted(self.totals, key=lambda n: -self.totals[n]):
                out[name] = dict(seconds=round(self.totals[name], 4),
                                 calls=self.counts[name])
                if name in self.cpu:
                    out[name]["cpu_s"] = round(self.cpu[name], 4)
        return out

    def dump(self, path: str):
        with open(path, "w") as f:
            json.dump(self.summary(), f, indent=2)


@contextlib.contextmanager
def device_trace(log_dir: str):
    """torch.profiler trace of the host's threads and, with a card, the
    CUDA device: log_dir/trace.json, a Chrome trace (viewable in Perfetto)
    holding StageTimer's spans beside the kernels and copies.  Every
    thread is recorded (``profile_all_threads``): a plain profile records
    only the thread that starts it, not the pool's."""
    from torch.profiler import ProfilerActivity, _ExperimentalConfig, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities, experimental_config=
                 _ExperimentalConfig(profile_all_threads=True)) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class _NoTimer:
    """StageTimer's ``stage`` and ``add``, recording nothing."""

    def stage(self, name: str):
        return contextlib.nullcontext()

    def add(self, name: str, seconds: float) -> None:
        pass


# the default of code whose caller may keep no spans
NO_TIMER = _NoTimer()
