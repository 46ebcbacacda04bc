"""emit_ms: host ms a session block spends handing its messages to the
analyzer's queue (``an.emit``, on the drain worker); a mean over the
traced blocks of the window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.ms_a_block(ctx, "an.emit")
