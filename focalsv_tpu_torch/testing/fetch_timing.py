"""Times io/bam.py::BamReader.fetch against the scan it replaced.

    python -m focalsv_tpu_torch.testing.fetch_timing [--work DIR]

Before, fetch restarted a scan at every merged index chunk of the query and
dropped the records it had already yielded (the JAX package's fetch still
does); now it scans once from the first chunk.  ``fetch_per_chunk`` restates
the old loop on the same reader, so both run on one machine in one process.
The script writes chip_smoke.py's phase-6 chromosome (32 simulated HiFi
regions of 15-100 kb at 30x laid end to end, seeds 1000 + i) unless ``--work``
already holds it, then prints, best of three, the seconds of the 32 region
queries and of the whole-chromosome query (the read scan of
pipeline/main.py when the native scanner is missing) by both loops, and
whether they return the same records in the same order.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import time

import numpy as np

from focalsv_tpu_torch.io import bam as bamio

SIZE_MIX = (15_000, 30_000, 50_000, 100_000)


def fetch_per_chunk(reader: bamio.BamReader, chrom: str, start: int,
                    end: int):
    """The fetch loop before the repair: one scan from each merged index
    chunk, each to the first record past the region, with the records seen
    dropped."""
    rid = reader._rid[chrom]
    seen = set()
    for voff, _ in reader.bai.chunks_for(rid, start, end):
        for rec in reader._records_from_stream(reader.bgzf.stream_from(voff)):
            if rec.ref_id != rid:
                if rec.ref_id > rid:
                    break
                continue
            if rec.pos >= end:
                break
            if rec.reference_end <= start:
                continue
            key = (rec.name, rec.flag, rec.pos)
            if key in seen:
                continue
            seen.add(key)
            yield rec


def write_chromosome(work: str, n_regions: int = 32) -> tuple[str, list]:
    """The chromosome BAM of chip_smoke.py's phase 6 and its region queries
    (each region less 100 columns at either end, as its BED has them)."""
    from focalsv_tpu_torch.testing import simulate as sim
    bam_path = os.path.join(work, "reads.bam")
    lens = [SIZE_MIX[i % len(SIZE_MIX)] for i in range(n_regions)]
    offs = np.cumsum([0] + lens)
    if not os.path.exists(bam_path + ".bai"):
        recs = []
        for i, n in enumerate(lens):
            rg = sim.simulate_region(seed=1000 + i, ref_len=n, coverage=30.0,
                                     n_snps=max(10, n // 1200))
            recs += [dataclasses.replace(r, pos=r.pos + int(offs[i]))
                     for r in rg.reads]
        recs.sort(key=lambda r: r.pos)
        w = bamio.BamWriter(bam_path, ["chr21"], [int(offs[-1])])
        for r in recs:
            w.write(r)
        w.close()
        bamio.build_bai(bam_path)
    queries = [("chr21", int(offs[i]) + 100, int(offs[i + 1]) - 100)
               for i in range(n_regions)]
    return bam_path, queries


def time_fetches(bam_path: str, queries: list, reps: int = 3) -> dict:
    """Best-of-reps seconds of the queries by fetch and by fetch_per_chunk,
    each on a fresh reader, and whether their records agree in order."""
    def run(fn):
        best, recs = None, None
        for _ in range(reps):
            reader = bamio.BamReader(bam_path)
            t0 = time.perf_counter()
            recs = [[(r.name, r.flag, r.pos) for r in fn(reader, *q)]
                    for q in queries]
            t = time.perf_counter() - t0
            best = t if best is None else min(best, t)
        return best, recs

    one_s, one = run(lambda rd, *q: rd.fetch(*q))
    per_s, per = run(lambda rd, *q: fetch_per_chunk(rd, *q))
    return dict(one_scan_s=one_s, per_chunk_s=per_s, records=sum(map(len, one)),
                same=one == per)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--work", default=os.path.join("build", "fetch_timing"))
    args = ap.parse_args()
    os.makedirs(args.work, exist_ok=True)
    bam_path, queries = write_chromosome(args.work)
    reader = bamio.BamReader(bam_path)
    chunks = [len(reader.bai.chunks_for(0, s, e)) for _, s, e in queries]
    print(f"[fetch] {bam_path}: {os.path.getsize(bam_path)} bytes, "
          f"{len(queries)} regions, {sum(chunks)} merged index chunks "
          f"({min(chunks)}-{max(chunks)} a region)", flush=True)
    res = time_fetches(bam_path, queries)
    print(f"[fetch] 32 regions: one scan {res['one_scan_s']:.3f} s, a scan "
          f"a chunk {res['per_chunk_s']:.3f} s, {res['records']} records, "
          f"same records in order: {res['same']}", flush=True)
    whole = [("chr21", 0, reader.ref_lens[0])]
    res_w = time_fetches(bam_path, whole)
    print(f"[fetch] whole chromosome: one scan {res_w['one_scan_s']:.3f} s, "
          f"a scan a chunk {res_w['per_chunk_s']:.3f} s, "
          f"{res_w['records']} records, same: {res_w['same']}", flush=True)
    return 0 if res["same"] and res_w["same"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
