"""The readings that the limits of ``correct`` are set from.

    python3 benchmark/readings.py --workload <cell> --seeds 101 102 ... \
        [--control-seeds 201 202 203] [--faults state_unchanged ...] \
        [--fault-seeds 301 302 303] [--out FILE]

For each seed: the cell's inputs, one whole pass of its entry exactly as a
run makes one, and the reference's numbers.  The sound seeds give each
number's lower reading (the largest); the control seeds run the same pass
with the control of ``focalbench/faults.py`` and give its upper reading
(the smallest); each fault named runs on the fault seeds, and its
smallest reading of each number shows which numbers catch it.  All in
one process, so the program's set-up is paid once.  Needs the card, as a
run does.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import shutil
import sys
import tempfile

sys.path[:0] = [os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                os.path.dirname(os.path.abspath(__file__))]

from focalbench import faults, harness, inputs  # noqa: E402


def one(cell, config, traffic, seed: int, mode: str,
        on_card: bool) -> dict:
    work = tempfile.mkdtemp(prefix="focalbench-readings-")
    try:
        inp = inputs.make(traffic, seed, os.path.join(work, "inputs"))
        runner = harness.Runner(config, inp, work, on_card)
        run = harness.Run(cell, config, traffic, inp, seed=seed)
        try:
            with (faults.ALL[mode]() if mode != "sound"
                  else contextlib.nullcontext()):
                p, d = runner.run()
        except Exception as exc:    # a run counts a failed pass as a fault
            return dict(seed=seed, mode=mode, crashed=repr(exc)[:300],
                        numbers={})
        run.passes.append(p)
        checks = harness.judge(run, d, config["limits"])
        return dict(seed=seed, mode=mode, pass_s=p.wall_s,
                    numbers={k: v for k, (v, _) in checks.items()})
    finally:
        shutil.rmtree(work, ignore_errors=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--faults", nargs="*", default=[],
                    choices=sorted(set(faults.ALL) - {"control"}))
    ap.add_argument("--fault-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    _, cell, config, traffic = harness.load_cell(args.workload)
    import torch
    on_card = torch.cuda.is_available()
    if not on_card:
        print("[readings] no CUDA device", file=sys.stderr)
        return 2
    plan = ([("sound", s) for s in args.seeds]
            + [("control", s) for s in args.control_seeds]
            + [(f, s) for f in args.faults for s in args.fault_seeds])
    rows = []
    for mode, seed in plan:
        rows.append(one(cell, config, traffic, seed, mode, on_card))
        print(json.dumps(rows[-1]), flush=True)
    summary = {}
    for mode in dict.fromkeys(m for m, _ in plan):
        got = [r["numbers"] for r in rows
               if r["mode"] == mode and "crashed" not in r]
        if got:
            pick = max if mode == "sound" else min
            summary[mode] = {k: pick(g[k] for g in got) for k in got[0]}
    print(json.dumps(dict(workload=args.workload, summary=summary)),
          flush=True)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(dict(rows=rows, summary=summary), f, indent=1)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
