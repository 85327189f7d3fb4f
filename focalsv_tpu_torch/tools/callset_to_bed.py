"""High-confidence callset -> SV-rich-region BED converter.

Port of the reference's data-prep tool `focalsv/target_sv/excel_to_bed.py`
(:1-30): rows of (chrom1, pos1, chrom2, pos2, svsize, svtype) become typed
target windows with a +-50 kb flank -- autosomes only, DUPs capped below
5 Mb, INVs contribute one window per breakend, TRAs keep both chromosomes.

Input: CSV/TSV with the reference xlsx's column order (first column is an
index, like pandas' to_excel output), or an .xlsx when openpyxl is
available (not in this image -- export the sheet to CSV first).

Usage: python -m focalsv_tpu_torch.tools.callset_to_bed callset.csv out.bed
"""

from __future__ import annotations

import sys

AUTOSOMES = {f"chr{i}" for i in range(1, 23)}
FLANK = 50_000
MAX_DUP = 5_000_000


def _read_rows(path: str) -> list[list[str]]:
    if path.endswith(".xlsx"):
        try:
            import openpyxl
        except ImportError as e:
            raise SystemExit(
                "openpyxl is not installed; export the sheet to CSV and "
                "re-run") from e
        wb = openpyxl.load_workbook(path, read_only=True)
        ws = wb.active
        return [[str(c) for c in row] for row in ws.iter_rows(
            values_only=True)][1:]
    out = []
    with open(path) as f:
        for ln, line in enumerate(f):
            sep = "\t" if "\t" in line else ","
            parts = [p.strip() for p in line.rstrip("\n").split(sep)]
            if len(parts) < 7 or not any(parts):
                if any(parts):
                    print(f"{path}:{ln + 1}: skipping short row "
                          f"({len(parts)} cols, need 7)", file=sys.stderr)
                continue    # blank or malformed row
            if ln == 0 and not parts[2].replace(".", "").isdigit():
                continue    # header
            out.append(parts)
    return out


def convert(rows: list[list[str]]) -> list[tuple]:
    """Reference excel_to_bed semantics -> typed BED tuples."""
    beds: list[tuple] = []
    for i, parts in enumerate(rows):
        # column 0 is the exported index (iloc[i, 1:7] in the reference)
        chrom1, pos1, chrom2, pos2, svsize, svtype = parts[1:7]
        try:
            pos1, pos2 = int(float(pos1)), int(float(pos2))
        except ValueError:
            print(f"row {i + 1}: non-numeric position "
                  f"({pos1!r}, {pos2!r}); skipped", file=sys.stderr)
            continue
        svtype = svtype.upper()
        if chrom1 not in AUTOSOMES or chrom2 not in AUTOSOMES:
            continue
        if svtype == "DUP":
            try:
                if int(float(svsize)) >= MAX_DUP:
                    continue
            except ValueError:
                print(f"row {i + 1}: non-numeric DUP size {svsize!r}; "
                      f"skipped", file=sys.stderr)
                continue
            lo, hi = min(pos1, pos2), max(pos1, pos2)
            beds.append((chrom1, max(0, lo - FLANK), hi + FLANK, "DUP"))
        elif svtype == "INV":
            lo, hi = min(pos1, pos2), max(pos1, pos2)
            # one window per breakend (the reference's 5-field INV rows)
            beds.append((chrom1, max(0, lo - FLANK), lo + FLANK, "INV"))
            beds.append((chrom1, max(0, hi - FLANK), hi + FLANK, "INV"))
        elif svtype == "TRA" and chrom1 != chrom2:
            beds.append((chrom1, max(0, pos1 - FLANK), pos1 + FLANK, "TRA"))
            beds.append((chrom2, max(0, pos2 - FLANK), pos2 + FLANK, "TRA"))
    return beds


def main(argv=None) -> int:
    argv = argv if argv is not None else sys.argv[1:]
    if len(argv) != 2:
        print(__doc__, file=sys.stderr)
        return 2
    rows = _read_rows(argv[0])
    beds = convert(rows)
    with open(argv[1], "w") as f:
        for row in beds:
            f.write("\t".join(str(x) for x in row) + "\n")
    print(f"{argv[1]}: {len(beds)} typed regions", file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
