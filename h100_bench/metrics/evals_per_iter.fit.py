"""evals_per_iter.fit: loss+grad evaluations per optimizer iteration,
summed over the traced window's fits (the fit result's nfev over nit)."""


def read(ctx):
    fits = ctx.window.get("fits")
    if not fits:
        return None
    return sum(f["nfev"] for f in fits) / sum(f["nit"] for f in fits)
