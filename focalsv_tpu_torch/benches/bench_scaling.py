"""Weak-scaling sweep of the sharded region step over a mesh.

The port's counterpart of the repository's bench_scaling.py.  The
production scale-out design is one mesh of shards (parallel/mesh.py):
region chunks split over the shards, each shard runs the region step
(kernel B2 on a card) on its part, and per-region results gather back to
the host.  A fixed per-shard region batch is dispatched at 1/2/4/8 shards
and the per-region cost is tracked.  On the card the shards are the cards
present, one a shard; past the cards present, shards share them as logical
shards (two shards on one card take turns on it).  With
FOCALSV_TORCH_DEVICE=cpu the shards are logical shards of the CPU.

Each dispatch is timed on the host clock from the packed chunk to its
results on the host (copies in and out included, as the pipeline's
dispatch_packed issues them), the median of --repeats.  Every region's
result must equal the result of the same region at one shard, byte for
byte; a difference fails the run.

Interpreting the numbers: N shards share min(N, units) physical units
(cards, or CPU cores for logical CPU shards), so raw wall grows with N once
N > units.  The efficiency column therefore normalizes by occupied units:

    cost_per_region(N) = wall(N) * min(N, units) / regions(N)
    efficiency(N)      = cost_per_region(1) / cost_per_region(N)

A sharded program with no cross-shard serialization and no growing gather
cost keeps cost_per_region flat (100%).  The end-to-end entry point over
several cards is `python -m focalsv_tpu_torch.benches.bench --mesh NxM`.

Writes one JSON document (default build/bench_scaling.json under the
repository, which git ignores) and prints it.
"""

import argparse
import json
import os
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def shard_mesh(n: int, device):
    """n shards: on the card, the cards present in turn (a card a shard
    while they last); on the CPU, n logical shards."""
    import torch

    from focalsv_tpu_torch.parallel import mesh as pmesh
    if device.type != "cuda":
        return pmesh.make_mesh(n)
    have = torch.cuda.device_count()
    return pmesh.make_mesh(devices=[torch.device("cuda", i % have)
                                    for i in range(n)])


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m focalsv_tpu_torch.benches.bench_scaling")
    ap.add_argument("--out", default=os.path.join(ROOT, "build",
                                                  "bench_scaling.json"))
    ap.add_argument("--devices", type=int, nargs="*", default=[1, 2, 4, 8])
    ap.add_argument("--per-device", type=int, default=8,
                    help="regions per shard (weak scaling)")
    ap.add_argument("--ref-len", type=int, default=15_000)
    ap.add_argument("--coverage", type=float, default=30.0)
    ap.add_argument("--repeats", type=int, default=5)
    return ap.parse_args(argv)


def sweep(args) -> tuple[dict, dict]:
    """The sweep: (the JSON document, {n: (the packed chunk dispatched at n
    shards, each region's result bytes there, a (G, bytes) uint8 array)})."""
    import numpy as np
    import torch

    from focalsv_tpu_torch.benches import bench
    from focalsv_tpu_torch.config import preset
    from focalsv_tpu_torch.device import resolve_device
    from focalsv_tpu_torch.pipeline import device_exec as dx

    device = resolve_device()
    if device.type == "cuda":
        units = torch.cuda.device_count()
        print(f"# card: {bench.card_name()} ({units} visible)",
              file=sys.stderr)
    else:
        units = os.cpu_count() or 1
    cfg = preset("HIFI")

    # one bucket's worth of real simulated tiles (identical shape)
    tmp = os.path.join(tempfile.gettempdir(),
                       f"focalsv_torch_scaling_l{args.ref_len}"
                       f"_c{int(args.coverage)}")
    os.makedirs(tmp, exist_ok=True)
    jobs = bench._make_jobs(tmp, 8, args.coverage, args.ref_len)
    tiles = []
    for j in jobs:
        reads, ref, chrom = bench._load_job(j)
        tiles.append(dx.build_tile(reads, ref, 0, chrom, cfg))
    keys = [dx._bucket_key(t, cfg) for t in tiles]
    key = max(set(keys), key=keys.count)
    tiles = [t for t, k in zip(tiles, keys) if k == key]
    _, Rp, Lp, Ds, Dd = key
    d2h_per_region = dx._d2h_bytes_per_region(key, cfg)

    rows = []
    outputs = {}
    t1_cost = None
    one_shard = {}                   # tile index -> its result at n = 1
    for n in args.devices:
        G = n * args.per_device
        chunk = [tiles[i % len(tiles)] for i in range(G)]
        buf = dx.pack_chunk(chunk, list(range(G)), key, G)
        mesh = shard_mesh(n, device)

        def dispatch():
            return np.asarray(dx.dispatch_packed(buf, key, G, cfg,
                                                 mesh.devices[0], mesh))

        out = dispatch()                 # loads the kernel, warms pools
        outputs[n] = (buf, out)
        for g in range(G):
            one_shard.setdefault(g % len(tiles), out[g])
        same = all(np.array_equal(out[g], one_shard[g % len(tiles)])
                   for g in range(G))
        walls = []
        for _ in range(args.repeats):
            t0 = time.perf_counter()
            dispatch()
            walls.append(time.perf_counter() - t0)
        wall = sorted(walls)[len(walls) // 2]
        cost = wall * min(n, units) / G
        if t1_cost is None:
            t1_cost = cost
        rows.append({
            "n_devices": n,
            "shards": [str(d) for d in mesh.devices],
            "regions_per_dispatch": G,
            "wall_ms_median": round(wall * 1e3, 3),
            "wall_ms_min": round(min(walls) * 1e3, 3),
            "wall_ms": [round(w * 1e3, 3) for w in walls],
            "core_ms_per_region": round(cost * 1e3, 4),
            "efficiency_pct": round(100 * t1_cost / cost, 1),
            "h2d_bytes": int(buf.size),
            "d2h_bytes": int(G * d2h_per_region),
            "records_equal": same,
        })
        print(f"# n={n}: wall {wall*1e3:.3f} ms, "
              f"{rows[-1]['core_ms_per_region']} unit-ms/region, "
              f"eff {rows[-1]['efficiency_pct']}%, results equal to one "
              f"shard's: {same}", file=sys.stderr)

    # n=1 runs unsharded: the smallest sharded N is the baseline for the
    # scaling of the sharded program itself
    multi = [r for r in rows if r["n_devices"] > 1]
    if multi:
        ref = multi[0]["core_ms_per_region"]
        for r in multi:
            r["efficiency_vs_smallest_sharded_pct"] = round(
                100 * ref / r["core_ms_per_region"], 1)
    doc = {
        "metric": "weak_scaling_sharded_region_step",
        "backend": ("cuda-mesh" if device.type == "cuda"
                    else "cpu-logical-mesh"),
        "units": units,
        "bucket": list(key),
        "per_device_regions": args.per_device,
        "normalization": "cost_per_region = wall * min(N, units) / regions;"
                         " efficiency = cost(1)/cost(N); units are the"
                         " cards present (the CPU's cores for logical CPU"
                         " shards), so shards past them share a unit.",
        "real_pod_entry": "python -m focalsv_tpu_torch.benches.bench "
                          "--mesh NxM",
        "records_equal": all(r["records_equal"] for r in rows),
        "rows": rows,
    }
    return doc, outputs


def main(argv=None) -> int:
    args = parse_args(argv)
    doc, _ = sweep(args)
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(doc, f, indent=1)
    print(json.dumps(doc))
    return 0 if doc["records_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
