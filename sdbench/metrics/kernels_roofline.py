"""kernels_roofline: the block's kernels' bounds summed, over the
traced time of every kernel the card ran a block (a kernel with no
bound counts its time and no bound)."""


def read(ctx):
    blocks = ctx.traced_blocks()
    kern = ctx.trace.get("kernel_s")
    if not blocks or not kern:
        return None
    runs = ctx.trace["span_counts"]
    bound_s = sum(ms * 1e-3 * runs.get(k, 0)
                  for k, ms in ctx.bounds_ms.items())
    return 100.0 * bound_s / kern
