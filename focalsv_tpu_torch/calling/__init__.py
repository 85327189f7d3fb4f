"""SV calling: DipPAV-equivalent contig variant caller, FP filter, dedup."""
