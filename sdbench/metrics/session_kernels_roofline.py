"""session_kernels_roofline: a session block's kernels' bounds summed
(``sdbench/roofline_session.py``), over the traced time of every kernel
the card ran a block (a kernel with no bound, such as the cell driver's
carry copies, counts its time and no bound)."""


def read(ctx):
    blocks = ctx.traced_blocks()
    kern = ctx.trace.get("kernel_s")
    if not blocks or not kern or not ctx.bounds_ms:
        return None
    return 100.0 * sum(ctx.bounds_ms.values()) * 1e-3 * blocks / kern
