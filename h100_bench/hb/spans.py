"""The program's spans (``lcgp_tpu_torch.utils.profiling.spans()``) for the
per-layer readers, and their alignment with the reduced device trace.

A program without the span recorder reads as None, so a reader of spans
reports nothing there and raises nothing."""
from __future__ import annotations

import statistics
import sys


def recorded():
    """The spans of the latest profiler session, or None where the program
    records none (an older ``lcgp_tpu_torch``) or recorded none."""
    try:
        from lcgp_tpu_torch.utils import profiling
    except ImportError:
        return None
    fn = getattr(profiling, "spans", None)
    return (fn() or None) if fn is not None else None


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def ms(s) -> float:
    return (s.end - s.start) * 1e-6


def offset_us(trace, spans, metric: str):
    """The trace's clock less the spans' (microseconds): the k-th
    ``lcgp.serve.replay`` span paired with the k-th ``cudaGraphLaunch``, by
    their ends (a replay span ends as its graph launch returns), the median
    of the pairs' differences.  None where the counts differ."""
    replays = sorted(s.end * 1e-3 for s in named(spans, "lcgp.serve.replay"))
    launches = sorted(e for n, _, e in trace.runtime if n == "cudaGraphLaunch")
    if not replays or len(replays) != len(launches):
        print(f"{metric}: {len(replays)} lcgp.serve.replay spans and "
              f"{len(launches)} cudaGraphLaunch calls: not aligned",
              file=sys.stderr)
        return None
    return statistics.median(b - a for a, b in zip(replays, launches))


def union(intervals) -> list:
    """Sorted disjoint (start, end) covering ``intervals``."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        elif e > s:
            out.append([s, e])
    return [tuple(iv) for iv in out]


def overlap(a, b) -> float:
    """Total length of the intersection of two sorted disjoint lists."""
    i = j = 0
    tot = 0.0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        if hi > lo:
            tot += hi - lo
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return tot
