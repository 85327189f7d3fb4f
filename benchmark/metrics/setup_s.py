"""Seconds from the process's start to the first timed pass: inputs,
loading, kernel builds (first run in a checkout) and the warm pass."""


def read(run):
    return run.setup_s
