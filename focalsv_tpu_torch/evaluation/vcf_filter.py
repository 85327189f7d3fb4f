"""Pre-evaluation VCF filtering: INS/DEL split + XY drop.

Port of the reference's `focalsv/6_evaluation/vcf_filter.py` (the step the
published Truvari numbers depend on — `6_evaluation/truvari_eval.sh:30`):

- default chromosome set = autosomes chr1..chr22 (`vcf_filter.py:4-7`);
- three outputs named `<prefix>_DEL_INS_noXY.vcf`, `<prefix>_INS_noXY.vcf`,
  `<prefix>_DEL_noXY.vcf` (`vcf_filter.py:11-13`);
- normal mode keeps records whose INFO contains `SVTYPE=DEL` / `SVTYPE=INS`
  (`vcf_filter.py:67-73`); `--dipcall` mode instead classifies by allele
  length: len(REF)-len(ALT) > 49 → DEL, < -49 → INS (`vcf_filter.py:58-65`,
  also enforcing the ≥50 bp size floor for callers that emit raw alleles);
- the `SVLEN=>` → `SVLEN=` NanoVar normalization (`vcf_filter.py:53`).

The reference writes records in input order and vcf-sorts afterwards
(`truvari_eval.sh:32-42`); here the outputs are written already sorted
(io/vcf.py::write_vcf sorts), collapsing the two steps.
"""

from __future__ import annotations

import os

from focalsv_tpu_torch.io.vcf import VcfRecord, read_vcf, write_vcf

AUTOSOMES = tuple(f"chr{n}" for n in range(1, 23))


def _is_type(rec: VcfRecord, svtype: str, dipcall: bool) -> bool:
    if dipcall:
        diff = len(rec.ref) - len(rec.alt)
        return diff > 49 if svtype == "DEL" else diff < -49
    return str(rec.info.get("SVTYPE", "")) == svtype


def filter_vcf(
    vcf: str,
    out_dir: str,
    chrs: tuple[str, ...] | list[str] | None = None,
    dipcall: bool = False,
) -> dict[str, str]:
    """Split `vcf` into DEL/INS/both files restricted to `chrs`.

    Returns {"both": path, "INS": path, "DEL": path}.
    """
    if chrs is None:
        chrs = AUTOSOMES
    chrs = set(chrs)
    prefix = os.path.basename(vcf)
    if prefix.endswith(".vcf"):
        prefix = prefix[:-4]
    paths = {
        "both": os.path.join(out_dir, prefix + "_DEL_INS_noXY.vcf"),
        "INS": os.path.join(out_dir, prefix + "_INS_noXY.vcf"),
        "DEL": os.path.join(out_dir, prefix + "_DEL_noXY.vcf"),
    }
    _, records = read_vcf(vcf)
    for rec in records:
        # NanoVar emits SVLEN=>N (vcf_filter.py:53)
        v = rec.info.get("SVLEN")
        if isinstance(v, str) and v.startswith(">"):
            rec.info["SVLEN"] = v[1:]
    dels = [r for r in records
            if r.chrom in chrs and _is_type(r, "DEL", dipcall)]
    inss = [r for r in records
            if r.chrom in chrs and _is_type(r, "INS", dipcall)]
    os.makedirs(out_dir, exist_ok=True)
    write_vcf(paths["DEL"], dels)
    write_vcf(paths["INS"], inss)
    write_vcf(paths["both"], dels + inss)
    return paths
