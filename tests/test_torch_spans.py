"""The span recorder of ``lcgp_tpu_torch/utils/profiling.py`` and its spans
in the prediction server and the optimizers, on the CPU.

Spans are recorded exactly while a ``torch.profiler`` session is active, on
every thread; off, a span reads one flag, allocates nothing and enters no
``record_function``.  Also the server's dispatcher: should it die, queued
and later requests fail with its error instead of waiting.
"""
import glob
import logging
import json
import sys
import threading
import time
import traceback
import tracemalloc

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from lcgp_tpu_torch import LCGP
from lcgp_tpu_torch import serve
from lcgp_tpu_torch.serve import PredictServer
from lcgp_tpu_torch.utils import profiling

torch.set_num_threads(1)  # pytest -n workers share the host's cores


def _model(seed=0, n=20, d=2, p=3, q=2):
    rng = np.random.default_rng(seed)
    return LCGP(y=rng.standard_normal((p, n)), x=rng.uniform(0, 1, (n, d)),
                q=q, device='cpu')


def _profiled(fn):
    """fn() under a torch.profiler session; (its result, the spans)."""
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn()
    return out, profiling.spans()


def _named(spans, name):
    return [s for s in spans if s.name == name]


def _requests(srv, sizes, threads=4):
    """Requests of ``sizes`` from ``threads`` concurrent senders; the rows
    they were served."""
    done, errors = [], []

    def sender(part):
        try:
            for k in part:
                out = srv.predict(np.full((k, 2), 0.3))
                done.append(out[0].shape[1])
        except Exception as e:  # noqa: BLE001
            errors.append(e)
    pool = [threading.Thread(target=sender, args=(sizes[i::threads],))
            for i in range(threads)]
    for t in pool:
        t.start()
    for t in pool:
        t.join(timeout=60)
    assert not errors, errors
    return sum(done)


@pytest.fixture(scope='module')
def model():
    return _model()


def test_nothing_is_recorded_with_the_profiler_off(model, monkeypatch):
    _profiled(lambda: None)                  # a session with no span
    assert profiling.spans() == []

    def refuse(*a, **k):
        raise AssertionError('a span was made with the profiler off')
    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    monkeypatch.setattr(profiling.Span, '__init__', refuse)
    monkeypatch.setattr(serve, 'stamp', refuse)
    model.fit(method='scipy', maxiter=2)
    srv = PredictServer(model, batch_size=16, warmup=False, device='cpu')
    try:
        _requests(srv, [1, 5, 20, 33])
    finally:
        srv.shutdown()
    assert profiling.spans() == []


def test_a_span_off_allocates_nothing():
    def bare(items):
        for _ in items:
            pass

    def spans_off(items):
        for _ in items:
            with profiling.span('lcgp.test'):
                pass
    items = [None] * 20000
    growth = {}
    for loop in (bare, spans_off):
        loop(items[:10])
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            loop(items)
            now, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        growth[loop.__name__] = (now - before, peak - before)
    # 20000 spans take no more than the loop's own iterator
    assert growth['spans_off'] == growth['bare'], growth


def test_fit_spans_count_the_evaluations(model):
    m = _model(seed=1)
    _, spans = _profiled(lambda: m.fit(method='scipy', maxiter=4))
    res = m._fit_result
    (fit,) = _named(spans, 'lcgp.fit')
    evals = _named(spans, 'lcgp.fit.eval')
    assert len(evals) == res.nfev > 0
    assert all(e.parent == fit.id and fit.start <= e.start <= e.end
               <= fit.end for e in evals)
    assert {s.name for s in spans} == {'lcgp.fit', 'lcgp.fit.eval'}

    m = _model(seed=2)
    _, spans = _profiled(lambda: m.fit(method='lbfgs-jax', maxiter=3))
    (fit,) = _named(spans, 'lcgp.fit')
    evals = _named(spans, 'lcgp.fit.eval')
    assert len(evals) == m._fit_result.nfev > 0
    assert {e.parent for e in evals} == {fit.id}


def test_serve_spans_count_the_dispatches_and_rows(model):
    srv = PredictServer(model, batch_size=16, warmup=False, device='cpu')
    sizes = [1, 3, 7, 16, 20, 2, 33, 5, 9, 1, 12, 4]
    try:
        calls = srv._fn.calls
        rows, spans = _profiled(lambda: _requests(srv, sizes))
        calls = srv._fn.calls - calls
    finally:
        srv.shutdown()
    assert rows == sum(sizes)
    disp = _named(spans, 'lcgp.serve.dispatch')
    assert len(disp) == calls > 0
    assert sum(s.attrs['rows'] for s in disp) == rows
    n_chunks = sum(-(-k // 16) for k in sizes)
    assert sum(s.attrs['chunks'] for s in disp) == n_chunks
    reqs = _named(spans, 'lcgp.serve.request')
    assert sorted(s.attrs['rows'] for s in reqs) == sorted(sizes)
    assert all(s.request == s.id and s.parent is None for s in reqs)
    by_id = {s.id: s for s in spans}
    waits = _named(spans, 'lcgp.serve.queue_wait')
    assert len(waits) == n_chunks
    for w in waits:
        # on the sender's thread, within its request; ends as its dispatch
        # (on the dispatcher's thread) starts
        req, d = by_id[w.parent], by_id[w.attrs['dispatch']]
        assert req.name == 'lcgp.serve.request' and w.request == req.id
        assert w.thread == req.thread != d.thread
        assert w.end == d.start and req.start <= w.start <= w.end
    wakes = _named(spans, 'lcgp.serve.wake')
    assert sorted(w.parent for w in wakes) == sorted(r.id for r in reqs)
    assert all(by_id[w.parent].start <= w.start <= w.end
               <= by_id[w.parent].end for w in wakes)
    # no graph on the CPU: no replay; the eager step is the wait
    assert _named(spans, 'lcgp.serve.replay') == []
    part = _named(spans, 'lcgp.serve.wait')
    assert sorted(s.parent for s in part) == sorted(d.id for d in disp)
    assert all(s.thread == disp[0].thread for s in part)
    assert all(by_id[s.parent].start <= s.start <= s.end
               <= by_id[s.parent].end for s in part)
    assert {s.name for s in spans} == {
        'lcgp.serve.request', 'lcgp.serve.queue_wait', 'lcgp.serve.dispatch',
        'lcgp.serve.wait', 'lcgp.serve.wake'}
    # made once: a second read gives the same spans
    assert [(s.id, s.name) for s in profiling.spans()] == [
        (s.id, s.name) for s in spans]


def _later(record):
    """The expansion of test stamps: a span from a stamp on one thread to
    one on another, within ``outer``'s request."""
    t0, t1, outer = record
    yield profiling.finished('lcgp.test.later', t0, t1, outer.thread,
                             parent=outer.id, request=outer.id, chunks=1)


def test_spans_on_other_threads_and_in_the_trace_file(tmp_path):
    started = {}

    def work():
        with profiling.span('lcgp.test.outer') as outer:
            started.update(t0=time.time_ns(), outer=outer)
            with profiling.span('lcgp.test.inner'):
                time.sleep(0.002)

    with profiling.trace(str(tmp_path)):
        with profiling.span('lcgp.test.main'):
            torch.linalg.cholesky(torch.eye(8, dtype=torch.float64) * 2.0)
        t = threading.Thread(target=work)
        t.start()
        t.join()
        # begun on the worker, ended here
        profiling.stamp(_later, (started['t0'], time.time_ns(),
                                 started['outer']))
    spans = profiling.spans()
    (outer,) = _named(spans, 'lcgp.test.outer')
    (inner,) = _named(spans, 'lcgp.test.inner')
    (later,) = _named(spans, 'lcgp.test.later')
    (main,) = _named(spans, 'lcgp.test.main')
    assert outer.thread == inner.thread == later.thread != main.thread
    assert inner.parent == outer.id and outer.parent is None
    assert later.parent == outer.id and later.request == outer.id
    assert inner.attrs == {} and later.attrs == {'chunks': 1}
    assert later.start == started['t0'] and later.end > outer.end

    (path,) = glob.glob(str(tmp_path / 'trace_*.json'))
    events = [e for e in json.load(open(path))['traceEvents']
              if e.get('ph') == 'X']
    ours = {e['name']: e for e in events if e.get('cat') == 'lcgp_span'}
    assert ours['lcgp.test.inner']['tid'] == inner.thread
    assert ours['lcgp.test.inner']['args']['parent'] == outer.id
    # the main thread's span and its record_function twin, one clock
    (twin,) = [e for e in events if e['name'] == 'lcgp.test.main'
               and e.get('cat') != 'lcgp_span']
    mine = ours['lcgp.test.main']
    assert abs(twin['ts'] - mine['ts']) < 1000.0
    assert abs(twin['ts'] + twin['dur'] - mine['ts'] - mine['dur']) < 1000.0


def _one(record):
    yield profiling.finished(*record)


def test_many_threads_record_every_span():
    """16 threads, 600 spans each (200 stamped), switching as often as the
    interpreter allows: no span lost, ids unique, each parent on its own
    thread."""
    def work():
        tid = threading.get_native_id()
        for _ in range(200):
            with profiling.span('lcgp.test.outer'):
                with profiling.span('lcgp.test.inner'):
                    pass
            t = time.time_ns()
            profiling.stamp(_one, ('lcgp.test.stamped', t, t, tid))
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            pool = [threading.Thread(target=work) for _ in range(16)]
            for t in pool:
                t.start()
            for t in pool:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in pool)
    finally:
        sys.setswitchinterval(interval)
    spans = profiling.spans()
    assert len(spans) == 16 * 600 == len({s.id for s in spans})
    by_id = {s.id: s for s in spans}
    for s in _named(spans, 'lcgp.test.inner'):
        outer = by_id[s.parent]
        assert outer.name == 'lcgp.test.outer' and outer.thread == s.thread
        assert outer.start <= s.start <= s.end <= outer.end
    stamped = _named(spans, 'lcgp.test.stamped')
    assert len({s.thread for s in stamped}) == 16


def test_a_new_session_clears_the_spans():
    for name in ('lcgp.test.a', 'lcgp.test.b'):
        with profile(activities=[ProfilerActivity.CPU]):
            with profiling.span(name):
                pass
            profiling.stamp(_one, (name + '.stamped', 1, 2, 0))
    assert [s.name for s in profiling.spans()] == [
        'lcgp.test.b.stamped', 'lcgp.test.b']


def test_a_compile_event_is_a_span_while_recording(caplog):
    caplog.set_level(logging.WARNING, logger='lcgp_tpu_torch.compiles')
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.span('lcgp.test.outer') as outer:
            profiling.record_compile('a capture', 0.25)
        with profiling.log_compiles() as events:
            profiling.record_compile('another capture', 0.5)
    first, second = _named(profiling.spans(), 'lcgp.compile')
    assert (first.note, first.parent) == ('a capture', outer.id)
    assert first.end - first.start == 250_000_000 and first.end <= outer.end
    assert second.note == 'another capture' and second.parent is None
    # the block's list and its log are as without a session
    assert events == [('another capture', 0.5)]
    assert [r.getMessage() for r in caplog.records] == [
        'Compiling another capture took 0.500 s']


def test_a_dead_dispatcher_fails_queued_and_later_requests(model,
                                                           monkeypatch):
    died = []
    monkeypatch.setattr(threading, 'excepthook',
                        lambda args: died.append(args.exc_value))
    srv = PredictServer(model, batch_size=16, warmup=False, device='cpu')
    try:
        stall = _Stall()
        srv._queue.put(stall)             # the dispatcher dies on it
        assert stall.taken.wait(30)
        out = {}

        def sender():
            try:
                srv.predict(np.full((3, 2), 0.3))
            except Exception as e:  # noqa: BLE001
                out['error'] = e
        t = threading.Thread(target=sender)
        t.start()
        while srv._queue.qsize() < 1:     # the request is queued behind it
            time.sleep(0.001)
        stall.gate.set()
        t.join(timeout=30)
        assert not t.is_alive()
        assert isinstance(out['error'], RuntimeError)
        assert 'dispatcher thread died' in str(out['error'])
        srv._dispatcher.join(timeout=30)
        assert not srv._dispatcher.is_alive()
        assert [type(e) for e in died] == [ValueError]
        cause = died[0]
        depth = len(list(traceback.walk_tb(cause.__traceback__)))
        later = []
        for call in (lambda: srv.predict(np.full((2, 2), 0.3)),
                     lambda: srv.predict(np.full((2, 2), 0.3)),
                     lambda: srv.reload(model)):
            with pytest.raises(RuntimeError,
                               match='dispatcher thread died') as caught:
                call()
            later.append(caught.value)
        # a new error each call, caused by the one that killed the
        # dispatcher, whose traceback no call extends
        assert len({id(e) for e in later + [out['error']]}) == 4
        assert all(e.__cause__ is cause for e in later + [out['error']])
        assert later[0].__traceback__ is not later[1].__traceback__
        assert len(list(traceback.walk_tb(later[0].__traceback__))) == len(
            list(traceback.walk_tb(later[1].__traceback__)))
        assert len(list(traceback.walk_tb(cause.__traceback__))) == depth
    finally:
        srv.shutdown()


class _Stall:
    """A queue item that the dispatcher takes for a chunk and cannot read:
    its ``x0`` sets ``taken``, then raises once ``gate`` is set."""

    def __init__(self):
        self.taken, self.gate = threading.Event(), threading.Event()

    @property
    def x0(self):
        self.taken.set()
        self.gate.wait(30)
        raise ValueError('an unreadable queue item')


def _fitc_fast_model(n=1100, m=12):
    rng = np.random.default_rng(11)
    x = rng.uniform(0, 1, (n, 2))
    y = np.sin(4 * x[:, :1].T + np.linspace(0, 1, 4)[:, None]) \
        + 0.05 * rng.standard_normal((4, n))
    return LCGP(y=y, x=x, q=2, inducing=m, n_chunk=0, precision='fast',
                device='cpu')


def test_fitc_spans_only_while_profiling_once_per_stage_per_evaluation(
        monkeypatch):
    """``lcgp.fitc.panel`` once an evaluation (Knm and its solve);
    ``lcgp.fitc.nsum`` once for each of an evaluation's five sums over n
    (G and t, their backwards, the solve's gradient in Lmm), as many as
    the helper's counters count; none with the profiler off."""
    from lcgp_tpu_torch.models import sparse
    m = _fitc_fast_model()
    _profiled(lambda: None)

    def refuse(*a, **k):
        raise AssertionError('a span was made with the profiler off')
    monkeypatch.setattr(profiling.Span, '__init__', refuse)
    m.fit(method='scipy', maxiter=2)
    assert profiling.spans() == []
    monkeypatch.undo()

    m = _fitc_fast_model()
    before = sparse._nsum.blocked + sparse._nsum.backward
    _, spans = _profiled(lambda: m.fit(method='scipy', maxiter=3))
    nfev = m._fit_result.nfev
    panel = _named(spans, 'lcgp.fitc.panel')
    nsum = _named(spans, 'lcgp.fitc.nsum')
    assert len(panel) == nfev > 0
    assert len(nsum) == 5 * nfev == (sparse._nsum.blocked
                                     + sparse._nsum.backward - before)
    # on the CPU a device span is a host span: no device time
    assert all(s.device_ns is None and s.end >= s.start
               for s in panel + nsum)
    evals = {s.id for s in _named(spans, 'lcgp.fit.eval')}
    assert {s.parent for s in panel} <= evals


def test_a_device_span_off_allocates_nothing():
    cpu = torch.device('cpu')

    def bare(items):
        for _ in items:
            pass

    def spans_off(items):
        for _ in items:
            with profiling.device_span('lcgp.test', cpu):
                pass
    items = [None] * 20000
    growth = {}
    for loop in (bare, spans_off):
        loop(items[:10])
        tracemalloc.start()
        try:
            before = tracemalloc.get_traced_memory()[0]
            tracemalloc.reset_peak()
            loop(items)
            now, peak = tracemalloc.get_traced_memory()
        finally:
            tracemalloc.stop()
        growth[loop.__name__] = (now - before, peak - before)
    assert growth['spans_off'] == growth['bare'], growth
