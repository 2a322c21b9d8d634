"""queue_wait_ms.serve: the median over the traced open-loop window's
chunks of the ``lcgp.serve.queue_wait`` span, from a chunk's entry into the
server's queue (on its sender) to the dispatcher taking it into a dispatch
(program spans)."""
import statistics

from hb import spans as S


def read(ctx):
    if ctx.trace is None or ctx.window.get("lat") is None:
        return None
    spans = S.recorded()
    waits = S.named(spans, "lcgp.serve.queue_wait") if spans else []
    return statistics.median(S.ms(s) for s in waits) if waits else None
