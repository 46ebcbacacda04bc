"""other_threads_cpu_pct: CPU time of the process's other threads, in %
of one core, between the first and the last traced block's feed
(``rx.feed``'s process and thread CPU clocks at its start,
``process_cpu_ns`` and ``cpu0``): the process's CPU less the feeding
thread's, over the wall time."""

from sdbench import program_spans


def read(ctx):
    feeds = program_spans.spans(ctx, program_spans.FEED)
    if len(feeds) < 2 or feeds[0].thread != feeds[-1].thread:
        return None
    a, b = feeds[0], feeds[-1]
    proc = b.attrs["process_cpu_ns"] - a.attrs["process_cpu_ns"]
    own = b.cpu0 - a.cpu0
    return 100.0 * (proc - own) / (b.t0 - a.t0)
