"""The card's idle share in the traced stretch of a detection window, %:
1 - the union of its kernels' and copies' intervals over the stretch."""


def read(ctx):
    t = ctx.get("trace")
    if ctx["kind"] != "detect" or not t or t["busy_s"] <= 0 or t["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - t["busy_s"] / t["window_s"])
