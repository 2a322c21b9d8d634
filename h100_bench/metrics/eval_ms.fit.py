"""eval_ms.fit: the mean ``lcgp.fit.eval`` span over the traced window's
fits: one loss and gradient evaluation inside the optimizer, at the fit's
own iterates, host-side work included (program spans).  Prints the spans'
count beside the fits' evaluations (their nfev)."""
import sys

from hb import spans as S


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    spans = S.recorded()
    evals = S.named(spans, "lcgp.fit.eval") if spans else []
    if not evals:
        return None
    print(f"eval_ms.fit: {len(evals)} lcgp.fit.eval spans; the fits' nfev "
          f"sum to {sum(f['nfev'] for f in fits)}", file=sys.stderr)
    return sum(S.ms(s) for s in evals) / len(evals)
