"""Benchmarking: truvari-style SV comparison (parity harness)."""
