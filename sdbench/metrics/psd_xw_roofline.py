"""psd_xw_roofline: the psd_xw launch's bound over the traced time of the
kernels launched from its host call (the ``psd_xw`` span), a block."""


def read(ctx):
    runs = ctx.trace.get("span_counts", {}).get("psd_xw", 0)
    t = ctx.trace.get("kernel_s_by_span", {}).get("psd_xw")
    if not runs or not t or "psd_xw" not in ctx.bounds_ms:
        return None
    return 100.0 * ctx.bounds_ms["psd_xw"] * 1e-3 * runs / t
