"""demap_ms: host ms a session block spends in the demap under the engine
lock (``an.demap``, on the drain worker); a mean over the traced blocks
of the window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.ms_a_block(ctx, "an.demap")
