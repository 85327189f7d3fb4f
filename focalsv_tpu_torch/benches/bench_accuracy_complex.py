"""Complex-SV accuracy benchmark: INV / DUP / TRA recall + precision.

The port's counterpart of the repository's bench_accuracy_complex.py, on
the same trials.  The statistical analog of the reference's HCC1395
somatic TRA/INV/DUP evaluation (SURVEY.md section 6; evaluation/Table5
SURVIVOR protocol):
randomized trials per SV type, each running the REAL stack -- reads sampled
from a rearranged donor haplotype, aligned with the framework's
seed-chain-extend aligner (split/supplementary alignments, the geometry
source), then called by the auto-mode complex caller
(`complexsv/auto.py::call_complex_auto`, reference
TRA_INV_DUP_call/Auto/define_region.py).

A call matches truth when both breakpoints land within `--tol` bp (the
SURVIVOR merge distance analog, default 1000).  Calls on SV-free control
trials count as false positives for precision.

The aligner is the port's align_engine.Aligner: a gap fill or extension
whose DP exceeds the native host kernel's cap (ops/align.py::
NATIVE_DP_MAX_CELLS) runs kernel B1 (the banded DP) and B4 (its
traceback) on the card.  At this bench's read length (12 kb) every DP fits
under the cap, so a run at the defaults launches neither; the launch
counts are printed so that a run shows which route its DPs took.
FOCALSV_TORCH_DEVICE=cpu runs the plain versions on the CPU.

Usage: python -m focalsv_tpu_torch.benches.bench_accuracy_complex
       [--trials 12] [--tol 1000]
Prints one JSON line per SV type plus a combined line, and commented lines
with the card and the launches of B1 and B4.
"""

import argparse
import json
import sys


def _sample_reads(donor, rng, n, rl, sub_rate=0.002):
    """Read sampling with a HiFi-level substitution error model."""
    import numpy as np
    out = []
    for _ in range(n):
        s = int(rng.integers(0, max(1, len(donor) - rl)))
        seq = donor[s : s + rl].copy()
        errs = np.flatnonzero(rng.random(len(seq)) < sub_rate)
        seq[errs] = (seq[errs] + rng.integers(1, 4, errs.size)) % 4
        out.append(seq)
    return out


def _align_reads(read_seqs, ref, chrom="chr21"):
    from focalsv_tpu_torch.align_engine import Aligner
    al = Aligner(ref, t_name=chrom)
    records = []
    for i, seq in enumerate(read_seqs):
        alns = al.align(seq, f"read{i}")
        for a in alns:
            records.append(al.to_bam_record(a, seq, alns))
    return records


def _inv_trial(rng, sv: bool):
    """One INV region: returns (truth (start, end) | None, calls)."""
    import numpy as np
    from focalsv_tpu_torch.complexsv import auto as cauto
    from focalsv_tpu_torch.ops import encode as enc

    ref = rng.integers(0, 4, 50_000).astype(np.uint8)
    truth = None
    donor = ref
    if sv:
        size = int(rng.integers(3_000, 12_000))
        a = int(rng.integers(12_000, 50_000 - size - 12_000))
        b = a + size
        donor = np.concatenate([ref[:a], enc.revcomp(ref[a:b]), ref[b:]])
        truth = (a, b)
    reads = _sample_reads(donor, rng, 45, 12_000)
    records = _align_reads(reads, ref)
    res = cauto.call_complex_auto({"chr21": records}, "HIFI")
    calls = cauto.filter_tra_inv(res.invs.get("chr21", []), min_sup=2,
                                 min_mapq=5, min_size=1000)
    return truth, [(c.start, c.end) for c in calls]


def _het_inv_trial(rng, sv: bool):
    """Heterozygous INV: half the reads come from the inverted haplotype,
    half from the reference haplotype (halved signal + clean-strand noise
    floor -- the stressor the hom trial cannot probe)."""
    import numpy as np
    from focalsv_tpu_torch.complexsv import auto as cauto
    from focalsv_tpu_torch.ops import encode as enc

    ref = rng.integers(0, 4, 50_000).astype(np.uint8)
    truth = None
    donor = ref
    if sv:
        size = int(rng.integers(3_000, 12_000))
        a = int(rng.integers(12_000, 50_000 - size - 12_000))
        b = a + size
        donor = np.concatenate([ref[:a], enc.revcomp(ref[a:b]), ref[b:]])
        truth = (a, b)
    reads = _sample_reads(donor, rng, 23, 12_000) + \
        _sample_reads(ref, rng, 22, 12_000)
    records = _align_reads(reads, ref)
    res = cauto.call_complex_auto({"chr21": records}, "HIFI")
    calls = cauto.filter_tra_inv(res.invs.get("chr21", []), min_sup=2,
                                 min_mapq=5, min_size=1000)
    return truth, [(c.start, c.end) for c in calls]


def _dup_trial(rng, sv: bool):
    """One tandem-DUP region (dup longer than read length -> split route)."""
    import numpy as np
    from focalsv_tpu_torch.complexsv import auto as cauto

    ref = rng.integers(0, 4, 70_000).astype(np.uint8)
    truth = None
    donor = ref
    if sv:
        size = int(rng.integers(14_000, 24_000))
        a = int(rng.integers(14_000, 70_000 - size - 14_000))
        b = a + size
        donor = np.concatenate([ref[:b], ref[a:b], ref[b:]])
        truth = (a, b)
    reads = _sample_reads(donor, rng, 65, 12_000)
    records = _align_reads(reads, ref)
    res = cauto.call_complex_auto({"chr21": records}, "HIFI")
    calls = [d for d in res.dups.get("chr21", []) if d.support >= 2]
    return truth, [(c.start, c.end) for c in calls]


def _tra_trial(rng, sv: bool):
    """One cross-chromosome junction: donor = chrA[:a] ++ chrB[b:].

    Each read is aligned against both chromosome references independently
    (the per-chromosome decomposition a whole-genome aligner performs); the
    per-read hits combine into primary + supplementary records.
    """
    import numpy as np
    from focalsv_tpu_torch.align_engine import Aligner
    from focalsv_tpu_torch.complexsv import auto as cauto

    ref1 = rng.integers(0, 4, 30_000).astype(np.uint8)
    ref2 = rng.integers(0, 4, 30_000).astype(np.uint8)
    truth = None
    if sv:
        a = int(rng.integers(10_000, 20_000))
        b = int(rng.integers(10_000, 20_000))
        donor = np.concatenate([ref1[:a], ref2[b:]])
        truth = (a, b)
        reads = _sample_reads(donor, rng, 35, 12_000)
    else:
        reads = _sample_reads(ref1, rng, 18, 12_000) + \
                _sample_reads(ref2, rng, 18, 12_000)
    al1 = Aligner(ref1, t_name="chr1")
    al2 = Aligner(ref2, t_name="chr2")
    recs = {"chr1": [], "chr2": []}
    for i, seq in enumerate(reads):
        hits = []
        for cid, al in ((0, al1), (1, al2)):
            for aln in al.align(seq, f"read{i}"):
                hits.append((cid, al, aln))
        if not hits:
            continue
        # highest score is the primary; the rest become supplementary
        hits.sort(key=lambda h: -h[2].score)
        alns = [h[2] for h in hits]
        for j, (cid, al, aln) in enumerate(hits):
            aln.is_supplementary = j > 0
            rec = al.to_bam_record(aln, seq, alns)
            rec.ref_id = cid
            recs["chr1" if cid == 0 else "chr2"].append(rec)
    res = cauto.call_complex_auto(recs, "HIFI")
    calls = []
    for chrom, pos, alt, sup, mq in res.tras:
        if sup < 2:
            continue
        # alt string: N[chr2:pos2[ etc.
        mate = alt.split(":")[-1].rstrip("[]")
        calls.append((pos, int(mate)))
    return truth, calls


def _run_type(name, trial_fn, n_trials, tol, seed0, trials=None):
    """The type's row over n_trials trials and their SV-free controls.
    ``trials``: a list that gets each trial's (type, seed, truth, calls)."""
    import numpy as np
    tp = fn = fp = 0
    for t in range(n_trials):
        rng = np.random.default_rng(seed0 + t)
        truth, calls = trial_fn(rng, sv=True)
        if trials is not None:
            trials.append((name, seed0 + t, truth, calls))
        hit = any(abs(c[0] - truth[0]) <= tol and abs(c[1] - truth[1]) <= tol
                  for c in calls)
        tp += int(hit)
        fn += int(not hit)
        fp += sum(1 for c in calls
                  if not (abs(c[0] - truth[0]) <= tol
                          and abs(c[1] - truth[1]) <= tol))
    for t in range(max(n_trials // 2, 1)):   # SV-free controls
        rng = np.random.default_rng(seed0 + 10_000 + t)
        _, calls = trial_fn(rng, sv=False)
        if trials is not None:
            trials.append((name, seed0 + 10_000 + t, None, calls))
        fp += len(calls)
    recall = tp / max(tp + fn, 1)
    precision = tp / max(tp + fp, 1)
    f1 = (2 * precision * recall / (precision + recall)
          if precision + recall else 0.0)
    return dict(metric=f"complexsv_{name}_f1", value=round(f1, 3), unit="F1",
                recall=round(recall, 3), precision=round(precision, 3),
                tp=tp, fn=fn, fp=fp)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m focalsv_tpu_torch.benches.bench_accuracy_complex")
    ap.add_argument("--trials", type=int, default=12)
    ap.add_argument("--tol", type=int, default=1000)
    ap.add_argument("--types", default="INV,HETINV,DUP,TRA")
    return ap.parse_args(argv)


def main(argv=None, trials=None) -> list[dict]:
    """Prints and returns the rows: one a type, then the combined line.
    ``trials``: a list that gets every trial's (type, seed, truth, calls)."""
    from focalsv_tpu_torch.device import resolve_device
    from focalsv_tpu_torch.ops import align_cuda
    args = parse_args(argv)
    if resolve_device().type == "cuda":
        from focalsv_tpu_torch.benches.bench import card_name
        print(f"# card: {card_name()}", file=sys.stderr, flush=True)
    b1, b4 = align_cuda.launches, align_cuda.traceback_launches
    fns = {"INV": _inv_trial, "HETINV": _het_inv_trial, "DUP": _dup_trial,
           "TRA": _tra_trial}
    rows = []
    for i, name in enumerate(args.types.split(",")):
        row = _run_type(name, fns[name], args.trials, args.tol,
                        seed0=37_000 + 1_000 * i, trials=trials)
        rows.append(row)
        print(json.dumps(row))
        sys.stdout.flush()
    mean_f1 = round(sum(r["value"] for r in rows) / len(rows), 3)
    rows.append({"metric": "complexsv_mean_f1", "value": mean_f1,
                 "unit": "F1", "vs_baseline": None})
    print(json.dumps(rows[-1]))
    print(f"# launches: B1 {align_cuda.launches - b1}, B4 "
          f"{align_cuda.traceback_launches - b4}", file=sys.stderr)
    return rows


if __name__ == "__main__":
    main()
