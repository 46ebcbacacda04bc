"""frame_offcpu_pct: share of the framing's wall time in which the
framing thread was off its CPU (``rx.frame``: wall less the thread's
CPU time, over wall, summed over the traced blocks of the window)."""

from sdbench import program_spans


def read(ctx):
    frames = program_spans.spans(ctx, "rx.frame")
    wall = sum(r.ns for r in frames)
    if not wall:
        return None
    return 100.0 * sum(r.ns - r.cpu_ns for r in frames) / wall
