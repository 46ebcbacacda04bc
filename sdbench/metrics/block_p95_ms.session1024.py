"""block_p95_ms.session1024: the 95th percentile of a session block's
time from its read to the return of its drain (its SAMPLES messages and
carries on the host), over the traced run's blocks that were neither
read nor drained while the profiler ran."""

from sdbench import stats


def read(ctx):
    return stats.p95(ctx.latency) * 1e3 if ctx.latency else None
