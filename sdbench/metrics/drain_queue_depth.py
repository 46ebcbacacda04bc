"""drain_queue_depth: the session's drain queue's depth when a block is
put on it (``an.feed``'s ``queue_depth``), in blocks; a mean over the
traced blocks of the window."""

from sdbench import session_spans


def read(ctx):
    return session_spans.attr_mean(ctx, "an.feed", "queue_depth")
