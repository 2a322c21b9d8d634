"""The traced window: ``torch.profiler`` over a block of the run, written as
a Chrome trace into ``TMPDIR`` and reduced to what the per-layer readers
need: the device's operations, the host's runtime calls and operators, and
the window's bounds (a ``hb.window`` annotation of the harness's own)."""
from __future__ import annotations

import bisect
import contextlib
import json
import os
import tempfile
from dataclasses import dataclass, field

import torch

WINDOW = "hb.window"
_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_RUNTIME_CATS = ("cuda_runtime", "cuda_driver")
_HOST_CATS = ("cpu_op", "user_annotation")


@dataclass
class Trace:
    """Events of the traced window, times in microseconds."""
    t0: float
    t1: float
    device: list = field(default_factory=list)    # (name, start, end)
    runtime: list = field(default_factory=list)   # (name, start, end)
    host: list = field(default_factory=list)      # (name, start, end)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def busy_intervals(self) -> list:
        """The union of the device's operation intervals, clipped to the
        window, as sorted disjoint (start, end)."""
        spans = sorted((max(s, self.t0), min(e, self.t1))
                       for _, s, e in self.device if e > self.t0
                       and s < self.t1)
        out = []
        for s, e in spans:
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return [tuple(iv) for iv in out]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) * 1e-6

    def device_time(self, match) -> tuple[int, float]:
        """(count, seconds) of the device operations whose name ``match``
        accepts."""
        hits = [e - s for name, s, e in self.device if match(name)]
        return len(hits), sum(hits) * 1e-6

    def runtime_count(self, name: str) -> int:
        return sum(1 for n, _, _ in self.runtime if n == name)

    def top_device_ops(self, k: int = 10) -> list:
        tot: dict = {}
        for name, s, e in self.device:
            tot[name] = tot.get(name, 0.0) + (e - s) * 1e-6
        return sorted(([_short(n), v] for n, v in tot.items()),
                      key=lambda kv: -kv[1])[:k]

    def idle_gaps(self, k: int = 10) -> list:
        """Idle time between device operations, summed by what the host was
        doing at each gap's midpoint: the innermost host operator or
        annotation then open, or none."""
        busy = self.busy_intervals()
        edges = [self.t0] + [x for iv in busy for x in iv] + [self.t1]
        host = sorted((h for h in self.host if h[0] != WINDOW),
                      key=lambda h: h[1])
        starts = [h[1] for h in host]
        tot: dict = {}
        for i in range(0, len(edges), 2):
            s, e = edges[i], edges[i + 1]
            if e <= s:
                continue
            mid = 0.5 * (s + e)
            label = "no torch operator on the host"
            # the latest-started operator still open at mid is the
            # innermost; look back a bounded way among those started before
            j = bisect.bisect_right(starts, mid) - 1
            for name, _, he in reversed(host[max(0, j - 4096):j + 1]):
                if he >= mid:
                    label = name
                    break
            tot[label] = tot.get(label, 0.0) + (e - s) * 1e-6
        return sorted(([_short(n), v] for n, v in tot.items()),
                      key=lambda kv: -kv[1])[:k]


def _short(name: str, limit: int = 120) -> str:
    return name if len(name) <= limit else name[:limit - 3] + "..."


@contextlib.contextmanager
def traced():
    """Profile the block (CPU and CUDA activities); yields a holder whose
    ``trace`` is set to the reduced :class:`Trace` after the block."""
    from torch.profiler import ProfilerActivity, profile

    holder = type("Held", (), {"trace": None})()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        with torch.profiler.record_function(WINDOW):
            yield holder
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json", prefix="hb_trace_")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder.trace = reduce(json.load(f))
    finally:
        os.remove(path)


def reduce(chrome: dict) -> Trace:
    """A Chrome trace (``export_chrome_trace``'s JSON) -> :class:`Trace`."""
    events = [e for e in chrome.get("traceEvents", [])
              if e.get("ph") == "X" and "dur" in e]
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("cat") in _HOST_CATS]
    if not win:
        raise RuntimeError("the traced window's annotation is missing")
    w = max(win, key=lambda e: e["dur"])
    tr = Trace(t0=float(w["ts"]), t1=float(w["ts"]) + float(w["dur"]))
    for e in events:
        cat = e.get("cat")
        iv = (e["name"], float(e["ts"]), float(e["ts"]) + float(e["dur"]))
        if cat in _DEVICE_CATS:
            tr.device.append(iv)
        elif cat in _RUNTIME_CATS:
            tr.runtime.append(iv)
        elif cat in _HOST_CATS:
            tr.host.append(iv)
    return tr
