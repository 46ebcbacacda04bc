"""session_frame_ms: host ms a session block spends in the framing of its
packed upload (``an.frame``); a mean over the traced blocks of the
window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.ms_a_block(ctx, "an.frame")
