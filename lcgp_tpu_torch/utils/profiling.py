"""Timing and profiling harness (counterpart of the JAX package's
``utils/profiling.py``; SURVEY §5: the reference has no tracing or
profiling, only wall-clock prints in example scripts).

- ``timed``: wall-clock timing with warmup, synchronising the CUDA devices
  of the tensors the function returns (nothing to wait for on the CPU).
- ``trace``: context manager around ``torch.profiler`` (CPU activities, and
  CUDA's when a card is present) that writes a Chrome trace into ``logdir``,
  with every thread's spans merged in.
- ``span``, ``stamp`` and ``spans``: the span recorder.  A span is a named
  interval of the port's own work (``lcgp.serve.*`` in the prediction
  server, ``lcgp.fit.*`` in the optimizers, ``lcgp.compile``), with its id,
  the id of the span that caused it, an optional request id, its thread and
  a few integer attributes (``rows``, ``chunks``, ``dispatch``).  Spans are
  recorded exactly while a ``torch.profiler`` session is active, on every
  thread; ``spans()`` returns those of the latest session.  Off, a span
  costs one read of torch's process-wide profiler flag.  ``span`` records
  a block as it runs; a hot path (the server's) ``stamp``s plain clock
  readings instead, made into spans only when ``spans()`` is read.
- ``log_compiles``: context manager that logs what the port "compiles"
  inside the block: each load or build of the kernel library
  (``ops/_build.build``) and each CUDA-graph capture of the prediction
  server (also an ``lcgp.compile`` span).  The port's counterpart of
  XLA's recompile detector, the tool for catching shape instability (a
  server that captures per request).
"""
from __future__ import annotations

import contextlib
import itertools
import json
import logging
import os
import threading
import time
from typing import Callable

import numpy as np
import torch
from torch.autograd import profiler as _tap

_LOG = logging.getLogger('lcgp_tpu_torch.compiles')
_blocks_lock = threading.Lock()
_blocks: list[list] = []   # the event lists of the open log_compiles blocks


# ---------------------------------------------------------------------------
# The span recorder
# ---------------------------------------------------------------------------

class Span:
    """One recorded interval, and while open its own context manager.
    ``start`` and ``end`` are ``time.time_ns()`` stamps: the clock of
    ``torch.profiler``'s Chrome trace, whose ``ts`` is (ns -
    ``baseTimeNanoseconds``) / 1e3 microseconds.  ``parent`` is the id of
    the span that caused this one, ``request`` the id of the request it
    serves (the request span's own id), ``thread`` the native id of the
    thread it belongs to, ``attrs`` its integer attributes and ``note`` a
    compile event's description.

    While open it is mirrored as a ``record_function`` range where the
    profiler records this thread's host operators (by default only on the
    thread that started it): that puts the span into the profiler's own
    trace.  Elsewhere the mirror would record nothing and cost ~26 us a span
    on the H100's host (PERF.md), so it is left out."""
    __slots__ = ('name', 'start', 'end', 'id', 'parent', 'request',
                 'thread', 'attrs', 'note', '_mirror', '_sink')

    def __init__(self, name, attrs, note=None):
        self.name, self.attrs, self.note = name, attrs, note
        self.id = next(_ids)
        self.start = self.end = 0
        self.parent = self.request = self.thread = self._mirror = None
        # a span still open at a new session ends in its own session
        self._sink = _session.spans

    def __enter__(self):
        stack = _stack()
        self.thread = _local.tid
        if stack:
            self.parent = stack[-1].id
        stack.append(self)
        if _thread_profiled():
            self._mirror = torch.profiler.record_function(self.name)
            self._mirror.__enter__()
        # stamped inside the mirror: the span times the block, not the
        # mirror (whose first call in a session took ~300 us on the H100)
        self.start = _now()
        return self

    def __exit__(self, exc_type, exc, tb):
        self.end = _now()
        if self._mirror is not None:
            self._mirror.__exit__(exc_type, exc, tb)
        _local.stack.pop()
        self._sink.append(self)
        return None

    def __repr__(self):
        return (f'Span({self.name!r}, id={self.id}, parent={self.parent}, '
                f'request={self.request}, '
                f'{(self.end - self.start) * 1e-6:.4f} ms, {self.attrs})')


class _Session:
    """What one profiler session recorded: ``spans``, and ``stamped``, the
    hot paths' ``(expand, record)`` pairs, of which the first ``made`` are
    already made into spans (in ``spans``)."""
    __slots__ = ('spans', 'stamped', 'made', 'lock')

    def __init__(self):
        self.spans, self.stamped, self.made = [], [], 0
        self.lock = threading.Lock()


_now = time.time_ns
# whether the profiler records this thread's host operators (thread-local)
_thread_profiled = torch._C._autograd._profiler_enabled
_ids = itertools.count(1)          # next() is atomic under the GIL
_session = _Session()              # the latest profiler session's
_local = threading.local()         # .stack: this thread's open spans; .tid
_NO_ATTRS: dict = {}               # the attrs of every span that has none


def _hook_profiler_start():
    """Have torch's profiler-start hook (``torch.autograd.profiler.
    _run_on_profiler_start``, run by every session's start) begin a new
    session's record.  Without the hook the record spans every session."""
    torch_start = getattr(_tap, '_run_on_profiler_start', None)
    if torch_start is None or getattr(torch_start, 'lcgp_hook', False):
        return

    def on_start():
        global _session
        _session = _Session()
        torch_start()
    on_start.lcgp_hook = True
    _tap._run_on_profiler_start = on_start


_hook_profiler_start()


def recording() -> bool:
    """Whether spans are recorded now: a profiler session is active (torch's
    process-wide flag, which every thread sees)."""
    return _tap._is_profiler_enabled


def new_id() -> int:
    """A fresh span id, for a hot path that stamps a span before making
    it (:func:`stamp`)."""
    return next(_ids)


def stamp(expand, record):
    """Keep ``record``, a hot path's tuple of ``time.time_ns()`` stamps and
    ids, for ``expand(record)`` to make into spans (:func:`finished`) when
    :func:`spans` is next read.  A hot path so pays for its clock readings
    and one append, and builds no span while it runs; it checks
    :func:`recording` first."""
    _session.stamped.append((expand, record))


def finished(name: str, start, end, thread, parent=None, request=None,
             span_id=None, note=None, **attrs) -> Span:
    """A span that is over: ``name`` from ``start`` to ``end`` on
    ``thread``, with the given ids (a fresh one unless ``span_id``), for an
    ``expand`` function of :func:`stamp`.  Its start and end may have been
    stamped on different threads."""
    s = Span(name, attrs or _NO_ATTRS, note)
    if span_id is not None:
        s.id = span_id
    s.start, s.end, s.thread = start, end, thread
    s.parent, s.request = parent, request
    return s


def spans() -> list:
    """The spans of the latest profiler session, every thread's, in the
    order they ended."""
    ses = _session
    with ses.lock:
        stamped = ses.stamped[ses.made:]
        for expand, record in stamped:
            ses.spans.extend(expand(record))
        ses.made += len(stamped)
        return sorted(ses.spans, key=lambda s: s.end)


def _stack() -> list:
    """This thread's open spans (and its native id in ``_local.tid``)."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack, _local.tid = [], threading.get_native_id()
        return _local.stack


class _Off:
    """The span while nothing records: static methods, so a ``with``
    binds and allocates nothing."""
    __slots__ = ()

    @staticmethod
    def __enter__():
        return None

    @staticmethod
    def __exit__(exc_type, exc, tb):
        return None


_OFF = _Off()


def span(name: str):
    """A context manager recording the block as a span ``name`` while a
    profiler session is active; off, it reads one flag and allocates
    nothing.  Its parent is the innermost span open on this thread.
    ``with span(...) as s`` gives the :class:`Span`, or None while off."""
    if not _tap._is_profiler_enabled:
        return _OFF
    return Span(name, _NO_ATTRS)


def _merge_spans(path: str, recorded: list):
    """Add ``recorded`` to the Chrome trace at ``path``: each span a
    complete event on its thread, on the file's own clock."""
    with open(path) as f:
        chrome = json.load(f)
    base = int(chrome.get('baseTimeNanoseconds', 0))
    pid = os.getpid()
    events = chrome.setdefault('traceEvents', [])
    for s in recorded:
        args = dict(id=s.id, parent=s.parent, request=s.request, **s.attrs)
        if s.note is not None:
            args['note'] = s.note
        events.append(dict(ph='X', cat='lcgp_span', name=s.name, pid=pid,
                           tid=s.thread, ts=(s.start - base) / 1e3,
                           dur=(s.end - s.start) / 1e3, args=args))
    with open(path, 'w') as f:
        json.dump(chrome, f)


def _cuda_devices(out, found=None):
    """The CUDA devices of the tensors in a (nested) function result."""
    found = set() if found is None else found
    if isinstance(out, torch.Tensor):
        if out.device.type == 'cuda':
            found.add(out.device)
    elif isinstance(out, dict):
        for v in out.values():
            _cuda_devices(v, found)
    elif isinstance(out, (list, tuple)):
        for v in out:
            _cuda_devices(v, found)
    return found


def _wait(out):
    for dev in _cuda_devices(out):
        torch.cuda.synchronize(dev)


def timed(fn: Callable, *args, warmup: int = 1, iters: int = 5,
          **kwargs) -> dict:
    """Run fn(*args) with device sync; returns timing stats in seconds."""
    out = None
    for _ in range(max(warmup, 1)):
        out = fn(*args, **kwargs)
    _wait(out)
    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _wait(out)
        times.append(time.perf_counter() - t0)
    return dict(median=float(np.median(times)), best=float(np.min(times)),
                mean=float(np.mean(times)), iters=iters)


@contextlib.contextmanager
def trace(logdir: str):
    """Profile the block with ``torch.profiler`` and write a Chrome trace
    (viewable in Perfetto or chrome://tracing) into ``logdir``, holding the
    spans every thread recorded in the block (the profiler itself records
    host operators on this thread only); yields the profiler, whose
    ``key_averages()`` sums the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    path = os.path.join(logdir, f'trace_{os.getpid()}_{time.time_ns()}.json')
    prof.export_chrome_trace(path)
    _merge_spans(path, spans())


def record_compile(what: str, seconds: float):
    """Report one compilation event (a kernel-library load or build, a
    CUDA-graph capture) that ends now: while spans are recorded, an
    ``lcgp.compile`` span; logged, and appended to every open
    :func:`log_compiles` block's list; a no-op when neither."""
    if _tap._is_profiler_enabled:
        end = _now()
        stack = _stack()
        _session.spans.append(finished(
            'lcgp.compile', end - round(seconds * 1e9), end, _local.tid,
            parent=stack[-1].id if stack else None, note=what))
    with _blocks_lock:
        if not _blocks:
            return
        for events in _blocks:
            events.append((what, seconds))
    _LOG.warning('Compiling %s took %.3f s', what, seconds)


@contextlib.contextmanager
def log_compiles():
    """Log every compilation inside the block (recompile detector).  Yields
    the list of ``(what, seconds)`` events recorded inside it, in order."""
    events: list = []
    with _blocks_lock:
        _blocks.append(events)
    try:
        yield events
    finally:
        with _blocks_lock:   # by identity: empty lists compare equal
            del _blocks[next(i for i, e in enumerate(_blocks)
                             if e is events)]
