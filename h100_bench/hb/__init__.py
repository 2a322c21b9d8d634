"""The harness of the H100 benchmark of ``lcgp_tpu_torch``: one run of one
cell (``runner``), driven by the files that ``BENCHMARK.json`` names.

Nothing here imports the JAX package or JAX; the package under test is
imported only inside the functions that build it.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import torch

from reference import data as _data
from reference import lcgp_ref as R


@dataclass
class Context:
    """One run: what the cell names, what set-up built, what the window
    produced, and what the per-layer readers read."""
    name: str
    cell: dict
    cfg: dict
    traffic: dict
    limits: dict
    kind: object     # the traffic's kind module, kinds/<kind>.py
    seed: int
    seconds: float
    traced: bool
    device: torch.device
    t_start: float
    parts: list = field(default_factory=list)   # set-up's (part, seconds)
    setup_s: float = 0.0
    window: dict = field(default_factory=dict)
    trace: object = None
    sub: dict = field(default_factory=dict)
    memory_peak_bytes: int = 0
    x: object = None
    y: object = None
    model: object = None
    _last: float = 0.0

    def mark(self, part: str):
        """Close one part of set-up, timed since the previous mark."""
        now = time.perf_counter()
        self.parts.append((part, now - (self._last or self.t_start)))
        self._last = now


def data_for(ctx: Context):
    """The configuration's (x, y) for the run's seed, on the run's device."""
    return _data.make(ctx.cfg, ctx.seed, ctx.device)


def build_model(ctx: Context, **override):
    """``lcgp_tpu_torch.LCGP`` on the run's data with the configuration's
    ``model`` arguments as they stand (``override`` replaces one, as
    ``precision``)."""
    from lcgp_tpu_torch import LCGP
    return LCGP(y=ctx.y, x=ctx.x, device=ctx.device,
                **{**ctx.cfg["model"], **override})


def inducing_points(ctx: Context, prob):
    """The reference's own choice of the inducing points, or None."""
    m = ctx.cfg["model"].get("inducing")
    if not m:
        return None
    return torch.as_tensor(R.select_inducing(prob.xs.cpu().numpy(), int(m)),
                           device=prob.xs.device)
