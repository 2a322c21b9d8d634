"""fit_iter_ms: the window's time over the optimizer iterations completed
in it (host clock; every fit started in the window runs to its end)."""


def read(ctx):
    fits = ctx.window.get("fits")
    if not fits:
        return None
    return ctx.window["seconds"] * 1e3 / sum(f["nit"] for f in fits)
