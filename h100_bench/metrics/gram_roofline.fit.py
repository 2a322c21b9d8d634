"""gram_roofline.fit: the Gram kernels' (K1, K2) share of their roofline
over the traced window's loss+grad evaluations: the sum of the least times
of the launches those evaluations make (hb/flops.py, from the
configuration's shapes) over the device time of the K1 and K2 kernels in
the trace.  Nothing is read where the trace's launch counts are not those
the evaluations make."""
import re
import sys

from hb import flops

K1 = re.compile(r"\bgram_kernel<")
K2 = re.compile(r"\bgram_vjp_(partials|finish)_kernel<")
K2_LAUNCH = re.compile(r"\bgram_vjp_partials_kernel<")


def read(ctx):
    fits = ctx.window.get("fits")
    if ctx.trace is None or not fits:
        return None
    evals = sum(f["nfev"] for f in fits)
    launches = flops.gram_launches(ctx.cfg)
    n1, t1 = ctx.trace.device_time(lambda n: bool(K1.search(n)))
    _, t2 = ctx.trace.device_time(lambda n: bool(K2.search(n)))
    n2, _ = ctx.trace.device_time(lambda n: bool(K2_LAUNCH.search(n)))
    want1 = evals * sum(1 for k, _ in launches if k == "K1")
    want2 = evals * sum(1 for k, _ in launches if k == "K2")
    if (n1, n2) != (want1, want2) or t1 + t2 <= 0:
        print(f"gram_roofline.fit: the trace holds {n1} K1 and {n2} K2 "
              f"launches where {evals} evaluations make {want1} and "
              f"{want2}", file=sys.stderr)
        return None
    least = evals * sum(s for _, s in launches)
    return 100.0 * least / (t1 + t2)
