"""Timing and profiling harness (counterpart of the JAX package's
``utils/profiling.py``; SURVEY §5: the reference has no tracing or
profiling, only wall-clock prints in example scripts).

- ``timed``: wall-clock timing with warmup, synchronising the CUDA devices
  of the tensors the function returns (nothing to wait for on the CPU).
- ``trace``: context manager around ``torch.profiler`` (CPU activities, and
  CUDA's when a card is present) that writes a Chrome trace into ``logdir``.
- ``log_compiles``: context manager that logs what the port "compiles"
  inside the block: each load or build of the kernel library
  (``ops/_build.build``) and each CUDA-graph capture of the prediction
  server.  The port's counterpart of XLA's recompile detector, the tool for
  catching shape instability (a server that captures per request).
"""
from __future__ import annotations

import contextlib
import logging
import os
import threading
import time
from typing import Callable

import numpy as np
import torch

_LOG = logging.getLogger('lcgp_tpu_torch.compiles')
_blocks_lock = threading.Lock()
_blocks: list[list] = []   # the event lists of the open log_compiles blocks


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
    (viewable in Perfetto or chrome://tracing) into ``logdir``; yields the
    profiler, whose ``key_averages()`` sums the device time by kernel."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(logdir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(
        logdir, f'trace_{os.getpid()}_{time.time_ns()}.json'))


def record_compile(what: str, seconds: float):
    """Report one compilation event (a kernel-library load or build, a
    CUDA-graph capture): logged, and appended to every open
    :func:`log_compiles` block's list; a no-op outside such blocks."""
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
