"""kernel_ms: device ms a block of every kernel the card ran, from the
traced slice."""


def read(ctx):
    blocks = ctx.traced_blocks()
    if not blocks or not ctx.trace.get("kernel_s"):
        return None
    return 1e3 * ctx.trace["kernel_s"] / blocks
