"""frame_ms: host ms a block in the program's framing (the ``frame``
span: ``MatChannelizer2._frame``), mean over the window."""


def read(ctx):
    return ctx.spans.mean_ms("frame")
