"""emit_handoffs: queue operations a session block's emission takes
(``an.emit``'s ``handoffs``); a mean over the traced blocks of the
window.  None where the program does not count them."""

from sdbench import session_spans


def read(ctx):
    return session_spans.attr_mean(ctx, "an.emit", "handoffs")
