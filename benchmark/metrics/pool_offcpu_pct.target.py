"""Share of the pool's job time spent off a CPU: 100 x (1 - CPU seconds
over wall seconds) of the spans ``tile_job`` and ``finish_job`` of
device_exec.streamed_map (each span's CPU seconds are its thread's own,
``time.thread_time``), from the chromosomes' stage_times.json of the
passes run without the tracer.  A job off a CPU waits for the interpreter
lock, the DP batcher or I/O.  None where the spans carry no CPU seconds."""

import os

JOBS = ("tile_job", "finish_job")


def read(run):
    ps = run.host_passes
    wall = run.stage_sum(JOBS, top_level=False, passes=ps)
    cpu = sum(float(v.get(s, {}).get("cpu_s", 0.0))
              for p in ps for path, v in p.logs.items()
              if os.path.basename(path) == "stage_times.json"
              and path != os.path.join("log", "stage_times.json")
              for s in JOBS)
    return 100.0 * (1.0 - cpu / wall) if wall > 0 and cpu > 0 else None
