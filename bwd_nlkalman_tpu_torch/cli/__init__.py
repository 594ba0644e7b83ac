"""Command-line entry points of the port, run as ``python -m
bwd_nlkalman_tpu_torch.cli.<name>``; each takes the flags of its JAX twin
plus ``--device`` (default ``cuda``)."""
