"""dispatch_host_ms.serve: the mean over the traced open-loop window's
dispatches of the ``lcgp.serve.dispatch`` span less its ``lcgp.serve.wait``
child: the dispatcher's host time (gather and pad, copy in, graph launch,
fan-out) in which it waits for no device work (program spans).  Prints the
dispatches, their rows and the trace's graph launches beside the window's
served rows."""
import sys

from hb import spans as S


def read(ctx):
    if ctx.trace is None or ctx.window.get("lat") is None:
        return None
    spans = S.recorded()
    if not spans:
        return None
    disp = S.named(spans, "lcgp.serve.dispatch")
    if not disp:
        return None
    waits = {}
    for s in S.named(spans, "lcgp.serve.wait"):
        waits[s.parent] = waits.get(s.parent, 0.0) + S.ms(s)
    rows = sum(s.attrs.get("rows", 0) for s in disp)
    print(f"dispatch_host_ms.serve: {len(disp)} dispatches of {rows} rows; "
          f"{ctx.trace.runtime_count('cudaGraphLaunch')} cudaGraphLaunch; "
          f"the window served {ctx.window['rows']} rows", file=sys.stderr)
    return sum(S.ms(s) - waits.get(s.id, 0.0) for s in disp) / len(disp)
