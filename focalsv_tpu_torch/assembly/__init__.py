"""Local per-haplotype assembly (replaces hifiasm/Flye/Shasta at region scale)."""
