"""Whole-genome read-based SV scanner (the vendored-cuteSV replacement)."""
