"""idle_with_work_share.serve: the share of the traced open-loop window in
which the device ran nothing (the complement of the trace's busy intervals)
while the server had work: a chunk in its queue (``lcgp.serve.queue_wait``)
or a dispatch open (``lcgp.serve.dispatch``).  The spans are put on the
trace's clock by pairing their graph replays with the trace's
``cudaGraphLaunch`` calls (``hb/spans.py``); nothing is read where the
counts differ."""
from hb import spans as S


def read(ctx):
    tr = ctx.trace
    if tr is None or ctx.window.get("lat") is None:
        return None
    spans = S.recorded()
    if not spans:
        return None
    off = S.offset_us(tr, spans, "idle_with_work_share.serve")
    if off is None:
        return None
    work = S.union(
        (max(s.start * 1e-3 + off, tr.t0), min(s.end * 1e-3 + off, tr.t1))
        for s in spans
        if s.name in ("lcgp.serve.queue_wait", "lcgp.serve.dispatch"))
    busy = tr.busy_intervals()
    idle_work = sum(e - s for s, e in work) - S.overlap(work, busy)
    return 100.0 * idle_work / (tr.t1 - tr.t0)
