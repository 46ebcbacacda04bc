"""convert_ms: host ms a block in the host's bfloat16-to-float32 conversion
of the audio (``rx.convert``); a mean over the traced blocks of the
window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "rx.convert")
