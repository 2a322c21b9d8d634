"""device_idle_share.serve: 1 - the union of the device's operation
intervals over the traced open-loop window."""


def read(ctx):
    if ctx.trace is None or ctx.window.get("lat") is None:
        return None
    return 100.0 * (1.0 - ctx.trace.busy_s() / ctx.trace.window_s)
