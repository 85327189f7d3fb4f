"""Accuracy benchmark: recall / precision / F1 / GT concordance per dtype,
over BASIC and ADVERSARIAL region classes.

The port's counterpart of the repository's bench_accuracy.py: the same
cases (ERR_MODELS, CASES and make_case give the same reads, reference and
truth for the same seed) through focalsv_tpu_torch.  The statistical analog
of the reference's HG002 1,000-region Truvari evaluation (BASELINE.md
accuracy table; protocol evaluation/Table2-4/truvari_eval_wgs.sh:20-24 --
refdist 500, pctsize 0.5, pctsim 0.5, sizemin 50): N randomized SV-rich
regions per (dtype, case), the full per-region stack (phase -> assemble ->
call -> refine), Truvari-protocol matching in-process
(evaluation/compare.py).

Case classes (the stressors a benign uniform sim cannot probe):
- basic:   1-3 SVs, log-uniform 50-2000 bp, random type/genotype
- repeat:  the SV is a whole-unit indel INSIDE a tandem-repeat array
           (breakpoint ambiguity: every unit boundary is a valid placement)
- segdup:  the SV sits inside one copy of a duplicated 4 kb block
           (mapping ambiguity: seeds hit both copies)
- nested:  2-3 SVs within a few hundred bp of each other
- large:   one 5-50 kb SV (wide-band DP + split-alignment regime)
- dropout: a 70% coverage hole over one flank of a het SV

Each region runs the per-region host path (pipeline/region.py::
process_region), whose DPs past the native host kernel's cap go to the
card: kernel B1 and B4 (the banded DP and its traceback, mostly under
--assembly olc) and, with --pairhmm, kernel B6 (the pair-HMM forward
pass).  The work is spread over --procs spawned processes (2 by default);
on a machine with one card each of them may open its own CUDA context on
it.  FOCALSV_TORCH_DEVICE=cpu runs the plain versions on the CPU.

Usage: python -m focalsv_tpu_torch.benches.bench_accuracy [--regions 20]
       [--dtypes HIFI,CLR,ONT]
       [--cases basic,repeat,segdup,nested,large,dropout,alnnoise]
Prints one JSON line per (dtype, case) plus a per-dtype rollup, each with
the kernels' launches its regions made; a commented line names the card.
"""

import argparse
import json
import sys

from focalsv_tpu_torch.config import preset

ERR_MODELS = {
    "HIFI": dict(sub_rate=0.002, coverage=22),
    "CLR": dict(sub_rate=0.06, ins_rate=0.03, del_rate=0.03, coverage=28),
    "ONT": dict(sub_rate=0.04, ins_rate=0.02, del_rate=0.02, coverage=28),
}

CASES = ("basic", "repeat", "segdup", "nested", "large", "dropout",
         "alnnoise")

_state = {}


def _rand_sv(rng, pos, length, svtype=None, gt=None):
    import numpy as np

    from focalsv_tpu_torch.testing import simulate as sim
    svtype = svtype or ("DEL" if rng.random() < 0.5 else "INS")
    gt = gt or ("0/1" if rng.random() < 0.5 else "1/1")
    seq = (rng.integers(0, 4, length).astype(np.uint8)
           if svtype == "INS" else None)
    return sim.SimSV(svtype, int(pos), int(length), gt, seq=seq)


def make_case(seed: int, case: str, err: dict, ref_len: int = 30_000,
              max_svlen: int = 2000):
    """Returns a SimulatedRegion with truth SVs for one case class."""
    import numpy as np

    from focalsv_tpu_torch.testing import simulate as sim

    # distinct substream from simulate_region's default_rng(seed): with the
    # SAME seed, a large INS sequence drawn here replays the same PCG64
    # bitstream that later generates the region reference -- the "novel"
    # insertion came out ~identical to the reference prefix, silently
    # turning every large-INS case into a distant duplication
    rng = np.random.default_rng([seed, 0xA11])
    kw = dict(err)

    if case == "basic":
        n_sv = int(rng.integers(1, 4))
        svs, lo = [], 6_000
        span = (ref_len - 12_000) // n_sv
        for i in range(n_sv):
            pos = int(rng.integers(lo + i * span, lo + i * span + span - 3_000))
            length = int(np.exp(rng.uniform(np.log(50), np.log(max_svlen))))
            svs.append(_rand_sv(rng, pos, length))
        return sim.simulate_region(seed=seed, ref_len=ref_len, n_snps=25,
                                   svs=svs, **kw)

    if case == "repeat":
        unit_len = int(rng.integers(5, 60))
        copies = max(20, 3_000 // unit_len)
        unit = sim.random_seq(rng, unit_len)
        arr = np.tile(unit, copies)
        center = ref_len // 2
        ref = sim.random_seq(rng, ref_len)
        ref[center : center + len(arr)] = arr[: ref_len - center]
        # whole-unit indel inside the array: maximally breakpoint-ambiguous
        k_units = max(1, int(np.ceil(60 / unit_len))) + int(rng.integers(0, 4))
        length = k_units * unit_len
        pos = center + unit_len * int(rng.integers(3, max(copies - k_units - 3, 4)))
        svtype = "DEL" if rng.random() < 0.5 else "INS"
        seq = np.tile(unit, k_units) if svtype == "INS" else None
        svs = [sim.SimSV(svtype, pos, length,
                         "0/1" if rng.random() < 0.5 else "1/1", seq=seq)]
        return sim.simulate_region(seed=seed, ref=ref, n_snps=25, svs=svs, **kw)

    if case == "segdup":
        ref, spots = sim.segdup_ref(rng, ref_len, block=4_000, n_copies=2)
        s0, e0 = spots[0]
        pos = int(rng.integers(s0 + 500, e0 - 1_500))
        length = int(np.exp(rng.uniform(np.log(60), np.log(800))))
        svs = [_rand_sv(rng, pos, length)]
        return sim.simulate_region(seed=seed, ref=ref, n_snps=25, svs=svs, **kw)

    if case == "nested":
        n_sv = int(rng.integers(2, 4))
        base = int(rng.integers(10_000, ref_len - 12_000))
        svs, pos = [], base
        for _ in range(n_sv):
            length = int(np.exp(rng.uniform(np.log(50), np.log(600))))
            svs.append(_rand_sv(rng, pos, length))
            adv = (length if svs[-1].svtype == "DEL" else 0)
            pos += adv + int(rng.integers(120, 700))
        return sim.simulate_region(seed=seed, ref_len=ref_len, n_snps=25,
                                   svs=svs, **kw)

    if case == "large":
        length = int(np.exp(rng.uniform(np.log(5_000), np.log(50_000))))
        big_len = max(ref_len, 4 * length + 24_000)
        pos = big_len // 2 - length // 2
        svs = [_rand_sv(rng, pos, length)]
        return sim.simulate_region(seed=seed, ref_len=big_len, n_snps=60,
                                   svs=svs, **kw)

    if case == "alnnoise":
        # basic SV mix + systematic ALIGNMENT noise (indel-placement
        # jitter + soft-clip growth, read sequences untouched): the
        # regime the pair-HMM realignment and FP filter exist for --
        # truth CIGARs otherwise make pileup projection exact
        n_sv = int(rng.integers(1, 4))
        svs, lo = [], 6_000
        span = (ref_len - 12_000) // n_sv
        for i in range(n_sv):
            pos = int(rng.integers(lo + i * span, lo + i * span + span - 3_000))
            length = int(np.exp(rng.uniform(np.log(50), np.log(max_svlen))))
            svs.append(_rand_sv(rng, pos, length))
        region = sim.simulate_region(seed=seed, ref_len=ref_len, n_snps=25,
                                     svs=svs, **kw)
        sim.jitter_alignments(region, rng)
        return region

    if case == "dropout":
        pos = ref_len // 2
        length = int(np.exp(rng.uniform(np.log(80), np.log(max_svlen))))
        svs = [_rand_sv(rng, pos, length, gt="0/1")]
        region = sim.simulate_region(seed=seed, ref_len=ref_len, n_snps=25,
                                     svs=svs, **kw)
        # 70% hole over the left flank (phasing evidence thins out)
        sim.drop_coverage(region, pos - 6_000, pos - 1_000, keep_frac=0.3,
                          rng=rng)
        return region

    raise ValueError(case)


def _child_init(dtype: str, pairhmm: bool = False,
                assembly: str = "guided", post_refine: bool = False):
    import dataclasses

    cfg = preset(dtype)
    if pairhmm:
        cfg = cfg.replace(phasing=dataclasses.replace(cfg.phasing,
                                                      use_pairhmm=True))
    if assembly != cfg.assembly.method:
        cfg = cfg.replace(assembly=dataclasses.replace(cfg.assembly,
                                                       method=assembly))
    _state["cfg"] = cfg
    _state["dtype"] = dtype
    _state["post_refine"] = post_refine


def run_region(region, cfg, mode: str = "host", device=None):
    """One simulated region through the port: the per-region host path
    ("host", pipeline/region.py::process_region), or the production device
    path ("device": tile -> the region step on ``device`` -> host finish,
    as the accuracy gate runs it).  Returns the RegionResult."""
    if mode == "device":
        from focalsv_tpu_torch.pipeline import device_exec as dx
        tile = dx.build_tile(region.reads, region.ref, 0, region.chrom, cfg)
        dev_outs = dx.run_device_step([tile], cfg, device=device)
        return dx.process_region_device(tile, dev_outs.get(0), cfg)
    from focalsv_tpu_torch.pipeline.region import process_region
    return process_region(region.reads, region.ref, 0, region.chrom, cfg)


def score_seeds(dtype: str, case: str, seeds, mode: str = "host", cfg=None,
                device=None) -> tuple[int, int, int]:
    """(tp, fp, fn) summed over the regions of ``seeds`` of one class, as
    the accuracy gate counts them (cfg: the dtype's preset by default)."""
    cfg = cfg or preset(dtype)
    tp = fp = fn = 0
    for seed in seeds:
        region = make_case(seed, case, ERR_MODELS[dtype])
        b = score(run_region(region, cfg, mode, device).records, region,
                  dtype)
        tp, fp, fn = tp + b.tp, fp + b.fp, fn + b.fn
    return tp, fp, fn


def score(records, region, dtype: str):
    """Truvari-protocol match of a region's records against its truth."""
    from focalsv_tpu_torch.evaluation.compare import (match_records,
                                                      truth_from_sim)
    truth = truth_from_sim(region.svs, region.chrom, region.ref)
    return match_records(records, truth, check_seq=(dtype == "HIFI"))


def launch_counts() -> dict:
    """The kernels' launch counts in this process: B1 and B4 (the banded
    DP and its traceback), B2 and B3 (the region step), B6 (the pair-HMM)."""
    from focalsv_tpu_torch.ops import align_cuda, pairhmm_cuda, region_cuda
    return {"B1": align_cuda.launches, "B4": align_cuda.traceback_launches,
            "B2": region_cuda.launches, "B3": region_cuda.rows_launches,
            "B6": pairhmm_cuda.launches}


def _child_run(args):
    seed, case, err = args
    before = launch_counts()
    region = make_case(seed, case, err)
    records = run_region(region, _state["cfg"]).records
    if _state.get("post_refine"):
        records = _apply_refine(records, region)
    b = score(records, region, _state["dtype"])
    after = launch_counts()
    return (b.tp, b.fp, b.fn, b.gt_correct, b.gt_total,
            {k: after[k] - before[k] for k in after})


def _apply_refine(records, region):
    """The chromosome-level step-5 refine stack (signature support ->
    coverage bands -> dtype GT correction / imputation / ONT final
    process), applied with this region as the chromosome -- the same
    refine_records call process_chromosome makes (pipeline/main.py).

    The per-region sweep otherwise excludes exactly the stage the
    reference uses to rescue noisy-dtype assembly FPs
    (5_post_processing/GT_impute.py, ONT_var_process.py:34-45)."""
    from focalsv_tpu_torch.refine.driver import refine_records
    from focalsv_tpu_torch.scan.read_scan import (calls_to_vcf,
                                                  cluster_signatures,
                                                  normalize_scan_result,
                                                  scan_records)
    cfg = _state["cfg"]
    scan = scan_records(iter(region.reads), cfg.read_scan)
    normalize_scan_result(scan, region.ref)
    calls = cluster_signatures(scan.del_sigs, region.chrom, "DEL",
                               cfg.read_scan, scan, True)
    calls += cluster_signatures(scan.ins_sigs, region.chrom, "INS",
                                cfg.read_scan, scan, True)
    calls.sort(key=lambda c: c.pos)
    draft = calls_to_vcf(calls, region.ref, 0)
    refined, _dropped = refine_records(records, scan, draft, cfg)
    return refined


def parse_args(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m focalsv_tpu_torch.benches.bench_accuracy")
    ap.add_argument("--regions", type=int, default=20,
                    help="regions per (dtype, case)")
    ap.add_argument("--dtypes", default="HIFI,CLR,ONT")
    ap.add_argument("--cases", default=",".join(CASES))
    ap.add_argument("--procs", type=int, default=2)
    ap.add_argument("--pairhmm", action="store_true",
                    help="enable pair-HMM het-site realignment")
    ap.add_argument("--assembly", choices=["guided", "olc"],
                    default="guided", help="local assembly mode")
    ap.add_argument("--post-refine", action="store_true",
                    help="apply the chromosome-level step-5 refine stack "
                         "(coverage bands + GT impute/correct + ONT final "
                         "process) before scoring")
    return ap.parse_args(argv)


def _sum_launches(rows) -> dict:
    return {k: sum(r[5][k] for r in rows) for k in rows[0][5]}


def main(argv=None) -> list[dict]:
    """Prints and returns the rows: one a (dtype, case), then each dtype's
    rollup (case "ALL")."""
    import multiprocessing as mp

    from focalsv_tpu_torch.device import resolve_device
    args = parse_args(argv)
    device = resolve_device()
    if device.type == "cuda":
        from focalsv_tpu_torch.benches.bench import card_name
        print(f"# card: {card_name()}", file=sys.stderr, flush=True)
    ctx = mp.get_context("spawn")
    out = []
    for dtype in args.dtypes.split(","):
        err = dict(ERR_MODELS[dtype])
        roll = [0, 0, 0, 0, 0]
        roll_launches = {}
        for case in args.cases.split(","):
            jobs = [(4000 + 97 * i, case, err) for i in range(args.regions)]
            if args.procs > 1:
                with ctx.Pool(args.procs, initializer=_child_init,
                              initargs=(dtype, args.pairhmm,
                                        args.assembly,
                                        args.post_refine)) as pool:
                    rows = pool.map(_child_run, jobs)
            else:
                _child_init(dtype, args.pairhmm, args.assembly,
                            args.post_refine)
                rows = [_child_run(j) for j in jobs]
            tp, fp, fn, gt_c, gt_t = (sum(r[i] for r in rows) for i in range(5))
            for i, v in enumerate((tp, fp, fn, gt_c, gt_t)):
                roll[i] += v
            launches = _sum_launches(rows)
            for k, v in launches.items():
                roll_launches[k] = roll_launches.get(k, 0) + v
            recall = tp / max(tp + fn, 1)
            precision = tp / max(tp + fp, 1)
            f1 = 2 * precision * recall / max(precision + recall, 1e-9)
            out.append({
                "dtype": dtype, "case": case, "regions": args.regions,
                "tp": tp, "fp": fp, "fn": fn,
                "recall": round(recall, 4), "precision": round(precision, 4),
                "f1": round(f1, 4),
                "gt_concordance": round(gt_c / max(gt_t, 1), 4),
                "launches": launches,
            })
            print(json.dumps(out[-1]))
            sys.stdout.flush()
        tp, fp, fn, gt_c, gt_t = roll
        recall = tp / max(tp + fn, 1)
        precision = tp / max(tp + fp, 1)
        f1 = 2 * precision * recall / max(precision + recall, 1e-9)
        out.append({
            "dtype": dtype, "case": "ALL", "tp": tp, "fp": fp, "fn": fn,
            "recall": round(recall, 4), "precision": round(precision, 4),
            "f1": round(f1, 4),
            "gt_concordance": round(gt_c / max(gt_t, 1), 4),
            "launches": roll_launches,
        })
        print(json.dumps(out[-1]))
        sys.stdout.flush()
    return out


if __name__ == "__main__":
    main()
