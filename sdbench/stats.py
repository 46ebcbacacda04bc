"""The benchmark's statistics, fixed here: percentiles of a run's block
latencies."""

from __future__ import annotations


def percentile(values: list[float], q: float) -> float:
    """The q-th percentile (0..100), linear between closest ranks."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    pos = (len(v) - 1) * q / 100.0
    lo = int(pos)
    hi = min(lo + 1, len(v) - 1)
    return v[lo] + (v[hi] - v[lo]) * (pos - lo)


def p95(values: list[float]) -> float:
    return percentile(values, 95.0)


def median(values: list[float]) -> float:
    return percentile(values, 50.0)

