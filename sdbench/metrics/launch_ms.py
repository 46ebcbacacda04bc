"""launch_ms: host ms a block in the kernel wrappers' calls (``launch``:
the checks, allocations, scratch and the C call, up to its return),
summed; a mean over the traced blocks of the window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "launch")
