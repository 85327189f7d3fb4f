"""One run of one cell of ``BENCHMARK.json``.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Set-up (``setup_s``, from the process's start): the cell's inputs are made
from the seed under ``$TMPDIR``, the program is loaded (its kernels build
into ``build/`` inside the checkout, once), and one untimed warm pass runs
on the inputs.  The window: passes of the cell's entry back to back, each
the user's whole call (``run_target_mode`` with the BED, or
``run_auto_mode``) with the configuration's ``PipelineConfig`` and
workers, a fresh output directory and a path of its own to the BAM (a
symbolic link, so every pass pays the whole-BAM scan).  Passes start while
the window is open and run to their end; a rate is their work over the sum
of their wall seconds.  Between passes, outside that sum, the pass's logs
and calls are read and its directory deleted.  After the window the plain
reference (``oracle.py``) checks every pass's calls and written regions
and one pass's region outputs, drawn from the seed, and the last line of
standard output is the result.  With ``--trace 1`` every other pass runs
under the tracer (``trace.py``): the device's metrics come from those
passes, the host's from the others.

Everything that belongs to one configuration, traffic mix or metric is in
a file of its own: ``configs/<config>.json``, ``traffic/<traffic>.json``,
``metrics/<metric>.py`` (a ``read(run)`` that returns a number or None).
"""

from __future__ import annotations

import argparse
import gc
import importlib.util
import json
import os
import resource
import shutil
import sys
import tempfile
import time
from dataclasses import dataclass, field

import numpy as np

from focalbench import inputs as inputs_mod
from focalbench import oracle

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(HERE)
PACKAGE = "focalsv_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "focalsv_tpu")
MISSING = 1e9            # a number the reference could not read
REGIONS_READ = 16        # regions of the kept pass the reference reads


@dataclass
class Pass:
    wall_s: float
    cpu_s: float                     # user and system
    logs: dict                       # relative path -> parsed JSON
    calls: list                      # the final VCF's records
    bed: str | None = None           # auto mode: step 0's BED, its text
    tracer: object = None            # traced passes: their PassTracer
    written: int = 0                 # regions with every output file
    sys_s: float = 0.0               # system CPU seconds, of cpu_s


@dataclass
class Run:
    """What the metric readers read."""
    workload: dict
    config: dict
    traffic: dict
    inputs: object
    passes: list[Pass] = field(default_factory=list)
    setup_s: float = 0.0
    traced: bool = False
    seed: int = 0
    kept_index: int = 0
    device_ops: dict = field(default_factory=dict)   # traced: name -> s
    breakdown: dict | None = None

    @property
    def wall_s(self) -> float:
        return sum(p.wall_s for p in self.passes)

    @property
    def host_passes(self) -> list[Pass]:
        """The passes that ran without the tracer: what the host-side
        per-layer metrics read, so that they leave out its cost."""
        return [p for p in self.passes if p.tracer is None]

    @property
    def traced_passes(self) -> list[Pass]:
        return [p for p in self.passes if p.tracer is not None]

    def log_sum(self, name: str, key: str, passes: list[Pass]) -> float:
        """``key`` summed over every ``log/<name>`` file of ``passes``."""
        return sum(float(v.get(key, 0.0)) for p in passes
                   for path, v in p.logs.items()
                   if os.path.basename(path) == name)

    def stage_sum(self, stages, top_level: bool, passes: list[Pass]) -> float:
        """Seconds of the named stages in the stage_times.json files of
        ``passes``: the run's own (``top_level``) or the chromosomes'."""
        total = 0.0
        for p in passes:
            for path, v in p.logs.items():
                if os.path.basename(path) != "stage_times.json":
                    continue
                if (path == os.path.join("log", "stage_times.json")
                        ) != top_level:
                    continue
                total += sum(float(v.get(s, {}).get("seconds", 0.0))
                             for s in stages)
        return total

    def regions_of(self, p: Pass) -> int:
        """Regions of one pass: the BED's, or step 0's."""
        if self.inputs.plan.bed:
            return self.inputs.n_regions
        return len(p.bed.splitlines())

    def regions_in(self, passes: list[Pass]) -> int:
        return sum(self.regions_of(p) for p in passes)

    @property
    def regions(self) -> int:
        """Regions of the completed passes."""
        return self.regions_in(self.passes)

    @property
    def megabases(self) -> float:
        return self.inputs.megabases * len(self.passes)


def process_start() -> float:
    """This process's start on the ``time.time`` clock."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    with open("/proc/stat") as f:
        btime = next(int(l.split()[1]) for l in f if l.startswith("btime"))
    return btime + start_ticks / os.sysconf("SC_CLK_TCK")


def load_cell(name: str) -> tuple[dict, dict, dict, dict]:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cell = next((w for w in bench["workloads"] if w["name"] == name), None)
    if cell is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    return (bench, cell) + cell_files(cell, bench)


def cell_files(cell: dict, bench: dict) -> tuple[dict, dict]:
    """A cell's configuration and traffic: the file ``BENCHMARK.json``
    names for its configuration (``configs/<config>.json`` for one it does
    not list yet), and ``traffic/<traffic>.json``."""
    path = next((c["file"] for c in bench["configs"]
                 if c["name"] == cell["config"]),
                os.path.join("benchmark", "configs", cell["config"] + ".json"))
    with open(os.path.join(ROOT, path)) as f:
        config = json.load(f)
    with open(os.path.join(HERE, "traffic", cell["traffic"] + ".json")) as f:
        traffic = json.load(f)
    # a size the configuration states (n_regions, chrom_len) the traffic
    # has to keep
    clash = {k for k in set(config) & set(traffic) if config[k] != traffic[k]}
    if clash:
        raise SystemExit(f"{cell['traffic']} departs from {cell['config']} "
                         f"in {sorted(clash)}")
    return config, traffic


def metrics_for(bench: dict, cell: str, traced: bool) -> list[dict]:
    group = bench["per_layer"] if traced else bench["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def reader(name: str):
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "focalbench_metric_" + name.replace(".", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def pipeline_config(config: dict):
    """The configuration's PipelineConfig: the data type's preset with the
    overrides of the configuration file, group by group."""
    import dataclasses

    from focalsv_tpu_torch.config import preset
    cfg = preset(config["data_type"])
    for group, values in config.get("overrides", {}).items():
        cfg = cfg.replace(**{group: dataclasses.replace(getattr(cfg, group),
                                                        **values)})
    return cfg


def read_logs(out: str) -> dict:
    logs = {}
    for dirpath, _, files in os.walk(out):
        if os.path.basename(dirpath) != "log":
            continue
        for n in files:
            if n.endswith(".json"):
                with open(os.path.join(dirpath, n)) as f:
                    logs[os.path.relpath(os.path.join(dirpath, n), out)] = \
                        json.load(f)
    return logs


def cpu_seconds() -> tuple[float, float]:
    """User and system CPU seconds of the process and its children."""
    s = resource.getrusage(resource.RUSAGE_SELF)
    c = resource.getrusage(resource.RUSAGE_CHILDREN)
    return s.ru_utime + c.ru_utime, s.ru_stime + c.ru_stime


class Runner:
    """Runs passes of the cell's entry on the run's inputs."""

    def __init__(self, config: dict, inp, work: str, on_card: bool = True):
        from focalsv_tpu_torch.pipeline import main as pipeline_main
        self.entry = config["entry"]
        self.call = {"run_target_mode": pipeline_main.run_target_mode,
                     "run_auto_mode": pipeline_main.run_auto_mode}[self.entry]
        self.cfg = pipeline_config(config)
        self.workers = int(config["num_workers"])
        self.inputs = inp
        self.work = work
        self.n = 0
        self.on_card = on_card

    def prepare(self) -> tuple[str, str]:
        """A fresh directory with the pass's own path to the BAM."""
        d = os.path.join(self.work, f"pass{self.n}")
        self.n += 1
        os.makedirs(d)
        bam = os.path.join(d, "reads.bam")
        os.symlink(self.inputs.bam, bam)
        os.symlink(self.inputs.bam + ".bai", bam + ".bai")
        return d, bam

    def invoke(self, bam: str, out: str):
        kw = dict(num_workers=self.workers)
        if self.entry == "run_target_mode":
            kw["target_bed"] = self.inputs.bed
        return self.call(bam, self.inputs.ref, out, self.cfg, **kw)

    def run(self, tracer=None) -> tuple[Pass, str]:
        import contextlib

        import torch
        d, bam = self.prepare()
        out = os.path.join(d, "out")
        if tracer is not None:
            tracer.start()
        u0, s0 = cpu_seconds()
        t0 = time.perf_counter()
        with tracer.mark() if tracer else contextlib.nullcontext():
            final = self.invoke(bam, out)
            if self.on_card:
                torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        u1, s1 = cpu_seconds()
        if tracer is not None:
            tracer.stop()
        calls = oracle.read_vcf(final)
        bed = None
        if self.entry == "run_auto_mode":
            bed_path = os.path.join(
                out, f"SV_Regions_{self.cfg.data_type.value}.bed")
            with open(bed_path) as f:
                bed = f.read()
        written = oracle.regions_written(regions_roots(out))
        return Pass(wall, u1 - u0 + s1 - s0, read_logs(out), calls, bed,
                    tracer, written, s1 - s0), d


def regions_roots(out: str) -> dict:
    return {c: os.path.join(out, c, "regions") for c in os.listdir(out)
            if os.path.isdir(os.path.join(out, c, "regions"))}


def judge(run: Run, kept: str | None, limits: dict) -> dict:
    """Every number the reference reads, each with its limit (None for
    one that is reported and not compared): the worst over the passes'
    calls and written regions, and the kept pass's regions."""
    truth = oracle.truth_svs(run.inputs.truth)
    worst: dict[str, float] = {}
    for p in run.passes:
        nums = oracle.check_calls(p.calls, truth)
        if p.bed is not None:
            nums.update(oracle.check_bed(p.bed, truth))
        # every region of the pass has each file of upstream's layout
        nums["regions_missing"] = run.regions_of(p) - p.written
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0), v)
    if kept is not None:
        out = os.path.join(kept, "out")
        reg = oracle.check_regions(run.inputs.truth, regions_roots(out),
                                   sample=REGIONS_READ, seed=run.seed)
        reg.pop("regions_checked")
        worst.update(reg)
    else:
        worst["regions_missing"] = MISSING
    names = list(limits) + [k for k in worst if k not in limits]
    return {k: (worst.get(k, MISSING), limits.get(k)) for k in names}


def main(argv: list[str], t_start: float) -> int:
    ap = argparse.ArgumentParser(prog="benchmark/run.py")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    bench, cell, config, traffic = load_cell(args.workload)
    import torch
    found = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if found < cell["chips"]:
        print(f"[bench] needs {cell['chips']} CUDA device(s); found {found}",
              file=sys.stderr)
        return 2
    cores = len(os.sched_getaffinity(0))
    print(f"[bench] workload {cell['name']} seed {args.seed} seconds "
          f"{args.seconds} trace {args.trace}; cores {cores}; "
          f"{torch.cuda.get_device_name(0)}", file=sys.stderr, flush=True)
    rc, _, _ = run_cell(args, bench, cell, config, traffic, t_start, cores,
                     on_card=True)
    return rc


def run_cell(args, bench, cell, config, traffic, t_start, cores,
             on_card: bool = True) -> tuple[int, dict | None, "Run"]:
    """Set-up, window, reference and result of one run; ``on_card``
    False runs it on the CPU (the program's plain versions), for the
    tests."""
    work = tempfile.mkdtemp(prefix="focalbench-")
    try:
        return _run(args, bench, cell, config, traffic, work, t_start,
                    cores, on_card)
    finally:
        shutil.rmtree(work, ignore_errors=True)


def _run(args, bench, cell, config, traffic, work, t_start, cores,
         on_card) -> tuple[int, dict | None, "Run"]:
    import torch
    t_in = time.perf_counter()
    inp = inputs_mod.make(traffic, args.seed, os.path.join(work, "inputs"))
    t_in = time.perf_counter() - t_in
    runner = Runner(config, inp, work, on_card)
    run = Run(cell, config, traffic, inp, traced=bool(args.trace),
              seed=args.seed)
    t_warm = time.perf_counter()
    _, d = runner.run()
    shutil.rmtree(d)
    gc.collect()
    t_warm = time.perf_counter() - t_warm
    if on_card:
        if args.trace:
            from focalbench.trace import warm_profiler
            warm_profiler()
        torch.cuda.reset_peak_memory_stats()
    run.setup_s = time.time() - t_start
    print(f"[bench] setup {run.setup_s:.3f} s (inputs {t_in:.3f}, warm pass "
          f"{t_warm:.3f}); bam {inp.bam_bytes} bytes", file=sys.stderr,
          flush=True)
    # the pass whose region outputs the reference reads: drawn from the
    # seed among the first three (the last completed where fewer ran)
    keep = int(np.random.default_rng([args.seed & (2**63 - 1), 7])
               .integers(0, 3))
    kept, failed = None, 0
    from focalbench.trace import PassTracer
    t_window = time.perf_counter()
    while time.perf_counter() - t_window < args.seconds:
        # a traced run traces every other pass: the device's metrics and
        # the idle gaps come from those, the host's from the others
        tracer = (PassTracer(work, PACKAGE)
                  if args.trace and len(run.passes) % 2 == 0 else None)
        try:
            p, d = runner.run(tracer)
        except Exception as exc:        # a pass that fails is a fault
            import traceback
            traceback.print_exc()
            print(f"[bench] pass {len(run.passes)} failed: {exc!r}",
                  file=sys.stderr, flush=True)
            failed += 1
            break
        run.passes.append(p)
        print(f"[bench] pass {len(run.passes) - 1}: {p.wall_s:.3f} s wall, "
              f"{p.cpu_s:.3f} s cpu ({p.sys_s:.3f} system)"
              f"{', traced' if tracer else ''}",
              file=sys.stderr, flush=True)
        k = len(run.passes) - 1
        if k <= keep:
            if kept is not None:
                shutil.rmtree(kept)
            kept = os.path.join(work, "kept")
            os.rename(d, kept)
            run.kept_index = k
        else:
            shutil.rmtree(d)
        gc.collect()
    device = dict(platform="gpu", kind=torch.cuda.get_device_name(0),
                  count=cell["chips"],
                  memory_peak_bytes=max(torch.cuda.max_memory_allocated(i)
                                        for i in range(cell["chips"]))
                  ) if on_card else dict(platform="cpu", kind="cpu", count=0,
                                         memory_peak_bytes=0)
    loaded = sorted({m.split(".")[0] for m in sys.modules}
                    & set(FORBIDDEN))
    if loaded:
        print(f"[bench] modules that must not load did: {loaded}",
              file=sys.stderr, flush=True)
        return 3, None, run
    if run.traced and run.passes:
        _trace_fields(run, device)
    metrics = {}
    for m in metrics_for(bench, cell["name"], run.traced):
        v = reader(m["name"])(run) if run.passes else None
        if v is not None:
            metrics[m["name"]] = dict(value=float(v), unit=m["unit"])
    t_ref = time.perf_counter()
    checks = judge(run, kept, config["limits"])
    t_ref = time.perf_counter() - t_ref
    correct = (bool(run.passes) and failed == 0
               and all(v <= lim for v, lim in checks.values()
                       if lim is not None))
    per_pass = (inp.n_regions if inp.plan.bed else
                (len(run.passes[0].bed.splitlines()) if run.passes else 0))
    result = dict(correct=correct,
                  attempted=per_pass * (len(run.passes) + failed),
                  failed=per_pass * failed + max(
                      0, int(min(checks.get("regions_missing",
                                            (0, 0))[0], per_pass))),
                  metrics=metrics, device=device)
    if run.breakdown:
        result["breakdown"] = run.breakdown
    result["checks"] = {k: dict(value=v, limit=lim)
                        for k, (v, lim) in checks.items() if lim is not None}
    print(f"[bench] passes {len(run.passes)}, {run.wall_s:.3f} s in passes; "
          f"cores {cores}; reference {t_ref:.3f} s", file=sys.stderr)
    # the numbers the control does not separate are reported, not compared
    for k, (v, lim) in checks.items():
        if lim is None:
            print(f"[reported] {k} {v}", file=sys.stderr)
    for k, (v, lim) in checks.items():
        if lim is not None:
            print(f"[check] {k} {v} limit {lim}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0, result, run


def _trace_fields(run: Run, device: dict) -> None:
    traced = run.traced_passes
    device["busy_s"] = sum(p.tracer.busy_s for p in traced)
    device["window_s"] = sum(p.tracer.window_s for p in traced)
    ops: dict[str, float] = {}
    gaps: list[tuple[str, float]] = []
    for p in traced:
        for k, v in p.tracer.ops.items():
            ops[k] = ops.get(k, 0.0) + v
        gaps += p.tracer.gaps
    run.device_ops = ops
    run.breakdown = dict(
        device_ops=[[k[:64], v] for k, v in
                    sorted(ops.items(), key=lambda kv: -kv[1])[:10]],
        idle_gaps=[[k, v] for k, v in
                   sorted(gaps, key=lambda kv: -kv[1])[:10]])
