"""upload_ms: host ms a block in its host-to-device copies (``rx.upload``:
the packed window buffer, and the rotator's tile phases in fm-tuned),
summed; a mean over the traced blocks of the window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "rx.upload")
