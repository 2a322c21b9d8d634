"""fitc_nsum_ms.fit: the device time of the ``lcgp.fitc.nsum`` spans (each
FITC sum over the n rows of an f32 panel, blocked with f64 partials, and
each one's backward, timed by CUDA events on the stream) per loss+grad
evaluation of the traced window's fits (program spans).  Prints the spans'
count beside the fits' evaluations (their nfev) and the helper's call
counters (``sparse._nsum``: blocked sums and backwards since the process
began).  Nothing is read without such spans."""
import sys

from hb import spans as S


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    spans = S.recorded()
    got = [s for s in S.named(spans, "lcgp.fitc.nsum")
           if getattr(s, "device_ns", None) is not None] if spans else []
    if not got:
        return None
    evals = sum(f["nfev"] for f in fits)
    from lcgp_tpu_torch.models import sparse
    helper = getattr(sparse, "_nsum", None)
    print(f"fitc_nsum_ms.fit: {len(got)} lcgp.fitc.nsum spans; the fits' "
          f"nfev sum to {evals}; the helper's counters: blocked "
          f"{getattr(helper, 'blocked', None)}, backward "
          f"{getattr(helper, 'backward', None)}", file=sys.stderr)
    return sum(s.device_ns for s in got) * 1e-6 / evals
