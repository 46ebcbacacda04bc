"""h2d_ms: device ms a block of host-to-device copies, from the traced
slice."""


def read(ctx):
    blocks = ctx.traced_blocks()
    if not blocks:
        return None
    return 1e3 * ctx.trace["h2d_s"] / blocks
