"""What a traced pass shows: the card's busy time from ``torch.profiler``
(CPU and CUDA activities), device time by kernel and copy name, and the
longest idle gaps of the card labelled by what the host was doing.

The host's side comes from a sampler thread that reads every thread's
Python stack every ``PERIOD`` seconds and keeps, for each thread that is
working (its innermost frame is not a wait in the standard library), the
innermost frame of the program, as ``module:function``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import os
import sys
import threading
import time

PERIOD = 0.02
_WAITS = ("threading", "queue", "concurrent.futures", "selectors",
          "multiprocessing")
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


class Sampler:
    """Samples every thread's stack until stopped: (perf_counter time,
    [label of each working thread])."""

    def __init__(self, package: str):
        self.package = package
        self.samples: list[tuple[float, list[str]]] = []
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)

    def __enter__(self):
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._stop.set()
        self._thread.join()

    def _run(self):
        me = threading.get_ident()
        while not self._stop.wait(PERIOD):
            labels = []
            for tid, frame in sys._current_frames().items():
                if tid == me:
                    continue
                top = frame.f_globals.get("__name__", "")
                if top.startswith(_WAITS):
                    continue
                f = frame
                while f is not None:
                    mod = f.f_globals.get("__name__", "")
                    if mod.startswith(self.package):
                        labels.append(f"{mod[len(self.package) + 1:]}:"
                                      f"{f.f_code.co_name}")
                        break
                    f = f.f_back
            self.samples.append((time.perf_counter(), labels))

    def label(self, t0: float, t1: float) -> str:
        c = collections.Counter()
        for t, labels in self.samples:
            if t0 <= t < t1:
                c.update(labels)
        return c.most_common(1)[0][0] if c else "host"


def device_intervals(trace_path: str, mark: str):
    """The device operations of a chrome trace, as (name, start, end) in
    seconds from the start of the ``mark`` span the pass ran in, and that
    span's length."""
    with open(trace_path) as f:
        ev = json.load(f).get("traceEvents", [])
    spans = [e for e in ev if e.get("name") == mark and e.get("ph") == "X"]
    if not spans:
        return [], None
    t0 = float(spans[0]["ts"])
    ops = [(e["name"], (float(e["ts"]) - t0) / 1e6,
            (float(e["ts"]) + float(e.get("dur", 0)) - t0) / 1e6)
           for e in ev if e.get("ph") == "X"
           and e.get("cat", "").lower() in DEVICE_CATS]
    return sorted(ops, key=lambda o: o[1]), float(spans[0]["dur"]) / 1e6


def busy_and_gaps(ops, window: float):
    """Seconds with an operation on the device (the union of the
    operations' intervals inside the window) and the idle gaps between
    them, (start, end)."""
    busy, gaps, cur = 0.0, [], 0.0
    for _, a, b in ops:
        a, b = max(a, 0.0), min(b, window)
        if b <= a:
            continue
        if a > cur:
            gaps.append((cur, a))
            busy += b - a
            cur = b
        elif b > cur:
            busy += b - cur
            cur = b
    if window > cur:
        gaps.append((cur, window))
    return busy, gaps


class PassTracer:
    """One pass under ``torch.profiler`` and the sampler: ``start`` and
    ``stop`` lie outside the pass's timing, ``mark`` around it.  After
    ``stop``, ``busy_s``, ``window_s``, ``ops`` ({name: device seconds}) and
    ``gaps`` ([(label, seconds)]) hold what the pass showed."""

    MARK = "focalbench.pass"

    def __init__(self, work_dir: str, package: str):
        self.path = os.path.join(work_dir, "trace.json")
        self.package = package
        self.busy_s = 0.0
        self.window_s = 0.0
        self.ops: dict[str, float] = {}
        self.gaps: list[tuple[str, float]] = []

    def start(self):
        from torch.profiler import ProfilerActivity, profile
        self.sampler = Sampler(self.package).__enter__()
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.start()

    @contextlib.contextmanager
    def mark(self):
        from torch.profiler import record_function
        self.t_host = time.perf_counter()
        with record_function(self.MARK):
            yield

    def stop(self):
        self.prof.stop()
        self.sampler.__exit__(None, None, None)
        self.prof.export_chrome_trace(self.path)
        ops, window = device_intervals(self.path, self.MARK)
        os.remove(self.path)
        if window is None:
            return
        self.window_s = window
        self.busy_s, gaps = busy_and_gaps(ops, window)
        for name, a, b in ops:
            self.ops[name] = self.ops.get(name, 0.0) + (b - a)
        self.gaps = [(self.sampler.label(self.t_host + a, self.t_host + b),
                      b - a) for a, b in gaps]


def warm_profiler() -> None:
    """The profiler's first start initialises CUPTI, some seconds: paid
    once in set-up, not in the first traced pass."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]):
        torch.zeros(1, device="cuda").add_(1)
        torch.cuda.synchronize()
