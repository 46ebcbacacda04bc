"""wait_ms: host ms a block in the drain's wait for the block's last launch
(``rx.wait``, on a CUDA event recorded after it); a mean over the traced
blocks of the window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "rx.wait")
