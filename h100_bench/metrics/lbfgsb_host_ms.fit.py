"""lbfgsb_host_ms.fit: the optimizer's own host time per iteration over the
traced window's fits: the ``lcgp.fit`` spans (each a whole
``scipy.optimize.minimize`` call) less their ``lcgp.fit.eval`` children,
over the fits' iterations (program spans).  Nothing is read where the spans
do not number the window's fits."""
import sys

from hb import spans as S


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    spans = S.recorded()
    whole = S.named(spans, "lcgp.fit") if spans else []
    if not whole:
        return None
    if len(whole) != len(fits):
        print(f"lbfgsb_host_ms.fit: {len(whole)} lcgp.fit spans for "
              f"{len(fits)} fits", file=sys.stderr)
        return None
    ids = {s.id for s in whole}
    evals = sum(S.ms(s) for s in S.named(spans, "lcgp.fit.eval")
                if s.parent in ids)
    return (sum(S.ms(s) for s in whole) - evals) / sum(
        f["nit"] for f in fits)
