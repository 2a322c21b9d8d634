"""The cost of one ``utils.profiling.span`` in microseconds: with no
profiler session (off), and under ``torch.profiler`` (on) on the thread
that started the profiler and on another thread; and of one stamped span
as the prediction server records them (``recording()``, two clock readings
and ``stamp``), off and on another thread.  CUDA activity is traced too
when a card is present.  Prints one JSON line.

    python3 tools/span_cost.py [--n 100000]
"""
import argparse
import json
import os
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from lcgp_tpu_torch.utils import profiling  # noqa: E402


def per_span_us(n: int) -> float:
    """Mean microseconds of a `with span(...)` over n spans, less the bare
    loop's."""
    items = [None] * n
    t0 = time.perf_counter()
    for _ in items:
        pass
    bare = time.perf_counter() - t0
    t0 = time.perf_counter()
    for _ in items:
        with profiling.span('lcgp.cost'):
            pass
    return (time.perf_counter() - t0 - bare) / n * 1e6


def _made(record):
    yield profiling.finished('lcgp.cost', *record)


def per_stamp_us(n: int) -> float:
    """As :func:`per_span_us`, for a span stamped on a hot path."""
    items = [None] * n
    t0 = time.perf_counter()
    for _ in items:
        pass
    bare = time.perf_counter() - t0
    tid = threading.get_native_id()
    t0 = time.perf_counter()
    for _ in items:
        if profiling.recording():
            profiling.stamp(_made, (time.time_ns(), time.time_ns(), tid))
    return (time.perf_counter() - t0 - bare) / n * 1e6


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--n', type=int, default=100000)
    n = ap.parse_args(argv).n
    per_span_us(1000)
    out = {'off_us': per_span_us(n), 'stamp_off_us': per_stamp_us(n)}
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    m = max(n // 10, 1000)
    with profile(activities=acts):
        out['on_profiler_thread_us'] = per_span_us(m)
        res = {}
        t = threading.Thread(target=lambda: res.update(
            v=per_span_us(m), s=per_stamp_us(m)))
        t.start()
        t.join()
        out['on_other_thread_us'] = res['v']
        out['stamp_on_other_thread_us'] = res['s']
    out['spans_recorded'] = len(profiling.spans())
    out['torch'] = torch.__version__
    print(json.dumps(out))


if __name__ == '__main__':
    main()
