"""wake_ms.serve: the median over the traced open-loop window's requests of
the ``lcgp.serve.wake`` span, from the dispatcher handing a request's last
chunk over (its event set) to ``PredictServer.predict`` returning on the
sender (program spans)."""
import statistics

from hb import spans as S


def read(ctx):
    if ctx.trace is None or ctx.window.get("lat") is None:
        return None
    spans = S.recorded()
    wakes = S.named(spans, "lcgp.serve.wake") if spans else []
    return statistics.median(S.ms(s) for s in wakes) if wakes else None
