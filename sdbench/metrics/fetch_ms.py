"""fetch_ms: host ms a block in its device-to-host copies once the card is
done (``rx.fetch``: the PSD block and the audio), summed; a mean over
the traced blocks of the window."""

from sdbench import program_spans


def read(ctx):
    return program_spans.ms_a_block(ctx, "rx.fetch")
