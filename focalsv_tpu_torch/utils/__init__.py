"""Logging, profiling, and timing utilities."""
