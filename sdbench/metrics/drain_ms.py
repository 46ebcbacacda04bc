"""drain_ms: host ms a block in the receiver's drain (the ``drain``
span: ``KernelReceiver.drain``, the fetch and the PSD fold), mean over
the window."""


def read(ctx):
    return ctx.spans.mean_ms("drain")
