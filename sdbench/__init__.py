"""The benchmark of sigdigger_tpu_torch: run with ``python3 -m sdbench.run``."""
