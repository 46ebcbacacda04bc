"""block_p95_ms.fm1024: the 95th percentile of a block's time from its
read to the return of its drain (audio and PSD on the host), over the
traced run's blocks that were neither read nor drained while the
profiler ran.  A per-layer reading, not an end-to-end metric: its runs
spread too widely for a bound (PERF.md)."""

from sdbench import stats


def read(ctx):
    return stats.p95(ctx.latency) * 1e3 if ctx.latency else None
