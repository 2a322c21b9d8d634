"""fitc_panel_ms.fit: the device time of the ``lcgp.fitc.panel`` spans (a
FITC panel's Knm Gram and its triangular solve W = Knm Lmm^-T, timed by
CUDA events on the stream) per loss+grad evaluation of the traced window's
fits (program spans).  Prints the spans' count beside the fits'
evaluations (their nfev).  Nothing is read without such spans."""
import sys

from hb import spans as S


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    spans = S.recorded()
    got = [s for s in S.named(spans, "lcgp.fitc.panel")
           if getattr(s, "device_ns", None) is not None] if spans else []
    if not got:
        return None
    evals = sum(f["nfev"] for f in fits)
    print(f"fitc_panel_ms.fit: {len(got)} lcgp.fitc.panel spans; the fits' "
          f"nfev sum to {evals}", file=sys.stderr)
    return sum(s.device_ns for s in got) * 1e-6 / evals
