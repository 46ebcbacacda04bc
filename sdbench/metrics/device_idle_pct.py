"""device_idle_pct: share of the traced slice in which the card ran no
kernel, copy or memset."""


def read(ctx):
    t = ctx.trace
    if not t.get("window_s") or not t.get("busy_s"):
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
