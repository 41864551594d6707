"""rollbench: the benchmark of zkrollup_torch (see run.py)."""
