"""The repo's measurement scripts (bench*.py at the root) as modules of
the port: each runs as ``python -m focalsv_tpu_torch.benches.<name>``."""
