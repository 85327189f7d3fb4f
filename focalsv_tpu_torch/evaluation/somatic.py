"""SURVIVOR-analog somatic merge: tumor/normal VCF pair -> somatic SVs.

In-process port of the reference's Table-5 protocol
(`evaluation/Table5/get_somatic.sh`): both VCFs are PASS-filtered, BND/TRA
records are separated, the remaining INV/DUP records are split into size
bands, each band is merged across the two samples with a band-scaled
breakpoint tolerance (SURVIVOR merge <dist> 1 1 0 0 <min_size>), and calls
supported ONLY by the tumor sample (SUPP_VEC=01) are emitted as somatic.

Size bands and tolerances mirror get_somatic.sh exactly:
[50,100]@50, [101,500]@101, [501,1000]@501, [1001,30000]@1001,
[30001,inf]@10000; BND/TRA merge at 1000 with no size gate.
"""

from __future__ import annotations

from dataclasses import dataclass

from focalsv_tpu_torch.io.vcf import VcfRecord, read_vcf, write_vcf

SIZE_BANDS = [(50, 100, 50), (101, 500, 101), (501, 1000, 501),
              (1001, 30_000, 1001), (30_001, None, 10_000)]
BND_DIST = 1000


def _is_bnd(r: VcfRecord) -> bool:
    return r.svtype in ("BND", "TRA")


def _end_of(r: VcfRecord) -> int:
    v = r.info.get("END")
    if v is not None:
        return int(v)
    if r.svtype in ("DEL", "INV", "DUP"):
        return r.pos + r.svlen
    return r.pos


@dataclass
class MergedSV:
    rec: VcfRecord
    supp_vec: str        # e.g. "01" = sample 2 (tumor) only


def survivor_merge(
    sample_records: list[list[VcfRecord]],
    max_dist: int,
    type_match: bool = True,
) -> list[MergedSV]:
    """Cross-sample merge: records agree when SVTYPE matches (if type_match)
    and BOTH breakpoints lie within max_dist (SURVIVOR's agreement rule).
    Returns one representative per cluster with its support bitvector."""
    items = []
    for si, recs in enumerate(sample_records):
        for r in recs:
            items.append((r.chrom, r.svtype if type_match else "",
                          r.pos, _end_of(r), si, r))
    items.sort(key=lambda x: (x[0], x[1], x[2]))
    n = len(sample_records)
    out: list[MergedSV] = []
    used = [False] * len(items)
    for i, (c, t, p, e, si, r) in enumerate(items):
        if used[i]:
            continue
        members = [(si, r)]
        used[i] = True
        for j in range(i + 1, len(items)):
            c2, t2, p2, e2, s2, r2 = items[j]
            if c2 != c or t2 != t or p2 - p > max_dist:
                break
            if used[j] or abs(e2 - e) > max_dist:
                continue
            members.append((s2, r2))
            used[j] = True
        vec = ["0"] * n
        for s2, _ in members:
            vec[s2] = "1"
        rep = members[0][1]
        rep = VcfRecord(rep.chrom, rep.pos, rep.id, rep.ref, rep.alt,
                        rep.qual, rep.filter,
                        dict(rep.info, SUPP_VEC="".join(vec),
                             SUPP=str(len(members))),
                        rep.gt)
        out.append(MergedSV(rec=rep, supp_vec="".join(vec)))
    return out


def somatic_call(
    normal_records: list[VcfRecord],
    tumor_records: list[VcfRecord],
    pass_only: bool = True,
) -> list[VcfRecord]:
    """Tumor-only (SUPP_VEC=01) SVs per the Table-5 protocol."""
    def prep(recs):
        if pass_only:
            # exact reference semantics: awk '$7 == "PASS"' keeps PASS only
            # ('.'-filtered records are dropped, get_somatic.sh)
            recs = [r for r in recs if r.filter == "PASS"]
        return recs

    normal = prep(normal_records)
    tumor = prep(tumor_records)
    somatic: list[VcfRecord] = []
    # BND/TRA band (no size gate, dist 1000)
    merged = survivor_merge([[r for r in normal if _is_bnd(r)],
                             [r for r in tumor if _is_bnd(r)]], BND_DIST)
    somatic.extend(m.rec for m in merged if m.supp_vec == "01")
    # INV/DUP size bands (get_somatic.sh drops INS/DEL/BND from this path)
    def band_recs(recs, lo, hi):
        out = []
        for r in recs:
            if _is_bnd(r) or r.svtype in ("INS", "DEL"):
                continue
            # symbolic-ALT INV/DUP records often carry only INFO/END (no
            # SVLEN); SURVIVOR sizes those as END-POS -- falling back to
            # allele-length difference (~4 for '<INV>') would drop them
            # below every band
            if "SVLEN" in r.info:
                size = r.svlen
            else:
                size = max(0, _end_of(r) - r.pos)
            if size >= lo and (hi is None or size <= hi):
                out.append(r)
        return out

    for lo, hi, dist in SIZE_BANDS:
        merged = survivor_merge([band_recs(normal, lo, hi),
                                 band_recs(tumor, lo, hi)], dist)
        somatic.extend(m.rec for m in merged if m.supp_vec == "01")
    somatic.sort(key=lambda r: (r.chrom, r.pos))
    return somatic


def main(argv=None) -> int:
    import argparse
    import sys

    p = argparse.ArgumentParser(
        prog="focalsv-tpu-somatic",
        description="SURVIVOR-protocol somatic SV merge (tumor vs normal)")
    p.add_argument("--normal_vcf", "-n", required=True)
    p.add_argument("--tumor_vcf", "-t", required=True)
    p.add_argument("--out_vcf", "-o", required=True)
    p.add_argument("--all", action="store_true",
                   help="keep non-PASS records too")
    args = p.parse_args(argv)
    _, normal = read_vcf(args.normal_vcf)
    _, tumor = read_vcf(args.tumor_vcf)
    somatic = somatic_call(normal, tumor, pass_only=not args.all)
    write_vcf(args.out_vcf, somatic)
    print(f"{args.out_vcf}: {len(somatic)} somatic SVs", file=sys.stderr)
    print(args.out_vcf)
    return 0


if __name__ == "__main__":
    import sys
    sys.exit(main())
