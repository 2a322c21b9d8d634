"""The readers of the program's spans (``metrics/*.py`` with source
``program_span``, ``hb/spans.py``) on a synthetic trace and span list."""
from types import SimpleNamespace

import pytest

from hb import spans as S
from hb.manifest import Manifest
from hb.trace import Trace

# the spans' clock (ns) is the trace's (us) less OFF_US
OFF_US = 5000.0


def span(sid, name, start_us, end_us, parent=None, **attrs):
    """A span on the program's clock, given its times on the trace's."""
    return SimpleNamespace(id=sid, name=name, parent=parent, attrs=attrs,
                           start=round((start_us - OFF_US) * 1e3),
                           end=round((end_us - OFF_US) * 1e3))


def serve_case():
    """Two dispatches in a 1000 us window.  Device busy 100-300 and
    500-700; queued chunks 20-60 (idle) and 400-450 (idle); dispatches
    60-320 and 450-720, each with its replay ending at its graph launch's
    end and a wait child."""
    tr = Trace(t0=0.0, t1=1000.0,
               device=[("k", 100.0, 300.0), ("k", 500.0, 700.0)],
               runtime=[("cudaGraphLaunch", 90.0, 95.0),
                        ("cudaMemcpyAsync", 96.0, 97.0),
                        ("cudaGraphLaunch", 480.0, 490.0)])
    spans = [
        span(1, "lcgp.serve.request", 10, 340, rows=3),
        span(2, "lcgp.serve.queue_wait", 20, 60, parent=1, dispatch=4),
        span(3, "lcgp.serve.request", 390, 760, rows=5),
        span(6, "lcgp.serve.queue_wait", 400, 450, parent=3, dispatch=9),
        span(4, "lcgp.serve.dispatch", 60, 320, rows=3, chunks=1),
        span(5, "lcgp.serve.replay", 70, 95, parent=4),
        span(7, "lcgp.serve.wait", 95, 310, parent=4),
        span(9, "lcgp.serve.dispatch", 450, 720, rows=5, chunks=1),
        span(10, "lcgp.serve.replay", 455, 490, parent=9),
        span(11, "lcgp.serve.wait", 490, 700, parent=9),
        span(12, "lcgp.serve.wake", 325, 340, parent=1),
        span(13, "lcgp.serve.wake", 722, 760, parent=3),
    ]
    return tr, spans


def fit_case():
    tr = Trace(t0=0.0, t1=1000.0)
    spans = [span(1, "lcgp.fit", 0, 400), span(2, "lcgp.fit", 500, 900)]
    for i, (s, e, p) in enumerate([(10, 110, 1), (120, 330, 1),
                                   (510, 800, 2)]):
        spans.append(span(10 + i, "lcgp.fit.eval", s, e, parent=p))
    fits = [dict(nit=2, nfev=2), dict(nit=1, nfev=1)]
    return tr, spans, fits


@pytest.fixture
def reader():
    man = Manifest()
    return man.reader


def _ctx(tr, window):
    return SimpleNamespace(trace=tr, window=window)


def test_serve_readers(reader, monkeypatch):
    tr, spans = serve_case()
    monkeypatch.setattr(S, "recorded", lambda: spans)
    ctx = _ctx(tr, dict(lat=[0.001], rows=8))
    assert reader("queue_wait_ms.serve")(ctx) == pytest.approx(0.045)
    # (260 - 215 + 270 - 210) / 2 us
    assert reader("dispatch_host_ms.serve")(ctx) == pytest.approx(0.0525)
    assert reader("wake_ms.serve")(ctx) == pytest.approx(0.0265)
    # work 20-320 and 400-720; idle in it 20-100, 300-320, 400-500, 700-720
    assert S.offset_us(tr, spans, "t") == pytest.approx(OFF_US)
    assert reader("idle_with_work_share.serve")(ctx) == pytest.approx(22.0)


def test_alignment_needs_as_many_replays_as_launches(reader, monkeypatch):
    tr, spans = serve_case()
    tr.runtime.append(("cudaGraphLaunch", 800.0, 805.0))
    monkeypatch.setattr(S, "recorded", lambda: spans)
    ctx = _ctx(tr, dict(lat=[0.001], rows=8))
    assert S.offset_us(tr, spans, "t") is None
    assert reader("idle_with_work_share.serve")(ctx) is None
    # the readers that need no alignment still read
    assert reader("queue_wait_ms.serve")(ctx) == pytest.approx(0.045)


def test_alignment_takes_the_median_pair(monkeypatch):
    tr, spans = serve_case()
    # one replay span that ended 40 us late: the median of two pairs
    # moves by half of it, of three by none
    spans[8].end += 40_000
    assert S.offset_us(tr, spans, "t") == pytest.approx(OFF_US - 20.0)
    tr.runtime.append(("cudaGraphLaunch", 800.0, 805.0))
    spans.append(span(20, "lcgp.serve.replay", 790, 805))
    assert S.offset_us(tr, spans, "t") == pytest.approx(OFF_US)


def test_fit_readers(reader, monkeypatch):
    tr, spans, fits = fit_case()
    monkeypatch.setattr(S, "recorded", lambda: spans)
    ctx = _ctx(tr, dict(fits=fits))
    assert reader("eval_ms.fit")(ctx) == pytest.approx(0.6 / 3)
    # (400 + 400 - 100 - 210 - 290) us over 3 iterations
    assert reader("lbfgsb_host_ms.fit")(ctx) == pytest.approx(0.2 / 3)
    ctx = _ctx(tr, dict(fits=fits + [dict(nit=1, nfev=1)]))
    assert reader("lbfgsb_host_ms.fit")(ctx) is None


NEW = ("queue_wait_ms.serve", "dispatch_host_ms.serve", "wake_ms.serve",
       "idle_with_work_share.serve", "eval_ms.fit", "lbfgsb_host_ms.fit")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_spans_reads_none(reader, monkeypatch, name):
    """A program without the recorder (no ``profiling.spans``), or a
    session that recorded none, reads None and raises nothing."""
    from lcgp_tpu_torch.utils import profiling
    tr, _ = serve_case()
    ctx = _ctx(tr, dict(lat=[0.001], rows=8, fits=fit_case()[2]))
    monkeypatch.setattr(profiling, "spans", lambda: [])
    assert reader(name)(ctx) is None
    monkeypatch.delattr(profiling, "spans")
    assert S.recorded() is None
    assert reader(name)(ctx) is None


def test_the_new_metrics_are_declared():
    man = Manifest()
    declared = {m["name"]: m for m in man.data["per_layer"]}
    for name in NEW:
        m = declared[name]
        assert m["source"] == "program_span" and len(m["workloads"]) == 1
        cell = "large_field.fit" if name.endswith(".fit") \
            else "large_field.serve"
        assert m["workloads"] == [cell]
