"""session_fetch_ms: host ms a session block spends in the drain's
device-to-host copies, once the card is done (``an.fetch``, on the drain
worker); a mean over the traced blocks of the window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.ms_a_block(ctx, "an.fetch")
