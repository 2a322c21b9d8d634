"""device_idle_share.fit: 1 - the union of the device's operation intervals
over the traced window of fits."""


def read(ctx):
    if ctx.trace is None or not ctx.window.get("fits"):
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
