"""session_idle_pct: share of a session cell's traced slice in which the
card ran no kernel, copy or memset, read as ``device_idle_pct`` reads it
in the fm cells."""

from sdbench.metrics.device_idle_pct import read  # noqa: F401
