"""One run of one cell: set-up, the measured (or traced) window, the check
against the reference, and the result line."""
from __future__ import annotations

import gc
import json
import math
import sys
import time

import torch

from . import Context
from .manifest import Manifest

FORBIDDEN = {"jax", "jaxlib", "flax", "lcgp_tpu"}


def context(man: Manifest, name: str, seed: int, seconds: float,
            traced: bool, device, t_start: float) -> Context:
    cell = man.cell(name)
    traffic = man.traffic(cell["traffic"])
    return Context(name=name, cell=cell, cfg=man.config(cell["config"]),
                   traffic=traffic, limits=man.limits(name),
                   kind=man.kind(traffic["kind"]), seed=int(seed),
                   seconds=float(seconds), traced=traced,
                   device=torch.device(device), t_start=t_start)


def measure(ctx: Context):
    """Set-up and the window; then the peak memory, and the program's state
    freed before the reference runs."""
    k = ctx.kind
    k.setup(ctx)
    # set-up's objects leave the collector's generations, so that a
    # collection in the window does not walk them
    gc.collect()
    gc.freeze()
    ctx.setup_s = time.perf_counter() - ctx.t_start
    (k.traced_window if ctx.traced else k.window)(ctx)
    if ctx.device.type == "cuda":
        torch.cuda.synchronize()
        ctx.memory_peak_bytes = int(torch.cuda.max_memory_allocated())
    k.release(ctx)
    gc.collect()
    if ctx.device.type == "cuda":
        torch.cuda.empty_cache()


def checks(ctx: Context) -> dict:
    """{number: (value, limit)}; a number passes while value <= limit."""
    nums = ctx.kind.numbers(ctx)
    return {k: (v, float(ctx.limits[k])) for k, v in nums.items()}


def metrics(man: Manifest, ctx: Context) -> dict:
    out = {}
    for m in man.metrics(ctx.name, ctx.traced):
        v = man.reader(m["name"])(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def forbidden_modules() -> list[str]:
    return sorted(m for m in list(sys.modules)
                  if m.split(".")[0] in FORBIDDEN)


def result(man: Manifest, ctx: Context, chips: int) -> dict:
    """The result line, after the window: metrics, device, breakdown and
    the compared numbers beside their limits (last)."""
    mets = metrics(man, ctx)
    gpu = ctx.device.type == "cuda"
    device = {"platform": "gpu" if gpu else "cpu",
              "kind": torch.cuda.get_device_name(0) if gpu else "cpu",
              "count": chips, "memory_peak_bytes": ctx.memory_peak_bytes}
    line = {"attempted": int(ctx.window["attempted"]),
            "failed": int(ctx.window["failed"]), "metrics": mets,
            "device": device}
    if ctx.traced:
        device["busy_s"] = ctx.trace.busy_s()
        device["window_s"] = ctx.trace.window_s
        line["breakdown"] = {"device_ops": ctx.trace.top_device_ops(),
                             "idle_gaps": ctx.trace.idle_gaps()}
    nums = checks(ctx)
    ok = all(math.isfinite(v) and v <= lim for v, lim in nums.values())
    line = {"correct": ok, **line,
            "checks": {k: {"value": v, "limit": lim}
                       for k, (v, lim) in nums.items()}}
    return line


def report(ctx: Context, line: dict):
    """Set-up's parts, then the compared numbers beside their limits as the
    last lines of standard error; the result as the last line of standard
    output."""
    for part, s in ctx.parts:
        print(f"setup: {part}: {s:.4f} s", file=sys.stderr)
    print(f"setup: total {ctx.setup_s:.4f} s", file=sys.stderr)
    for k, c in line["checks"].items():
        print(f"check {k}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(line), flush=True)
