"""kernel2_roofline: the kernel2 launch's bound over the traced time of the
kernels launched from its host call (the ``kernel2`` span), a block."""


def read(ctx):
    runs = ctx.trace.get("span_counts", {}).get("kernel2", 0)
    t = ctx.trace.get("kernel_s_by_span", {}).get("kernel2")
    if not runs or not t or "kernel2" not in ctx.bounds_ms:
        return None
    return 100.0 * ctx.bounds_ms["kernel2"] * 1e-3 * runs / t
