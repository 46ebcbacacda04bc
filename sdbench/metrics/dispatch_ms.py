"""dispatch_ms: host ms a session block spends in the dispatch of its
banks, squeeze, pack and side compactor (``an.dispatch``); a mean over
the traced blocks of the window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.ms_a_block(ctx, "an.dispatch")
