"""Seeded data for the benchmark's configurations, made on the device.

Frozen rewrites of two generators of ``benchmarks/run_configs.py`` (BASELINE
config 4 ``config4`` and the repository's config 7 ``config7``): the same
fields and noise, drawn by a ``torch.Generator`` on the device from the
configuration's ``data_seed``.  The run's ``--seed`` then orders the rows:
every seed fits and serves the same data set in another order, because a
fit's work (its line searches' evaluations) follows the data, and a seed
that changed the data would change the work measured.  Each field is
selected by the ``field`` key of a configuration file.
"""
from __future__ import annotations

import math

import torch

F64 = torch.float64


def generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number: the driver's
    seeds exceed 32 bits, so they are folded into 63 bits, not truncated."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (2 ** 63 - 1))
    return g


def _large_field(t, x):
    # benchmarks/run_configs.py config4: sin(2 pi (t + x1)) + cos(pi t x2)
    return (torch.sin(2 * math.pi * (t + x[:, :1].T))
            + torch.cos(math.pi * t * x[:, 1:2].T))


def _fitc_field(t, x):
    # benchmarks/run_configs.py config7 (config 6's field plus one octave)
    return (torch.sin(2 * math.pi * (t + x[:, :1].T)) * x[:, 1:2].T
            + torch.cos(math.pi * t * x[:, 1:2].T)
            + 0.3 * torch.sin(4 * math.pi * x[:, :1].T + math.pi * t))


FIELDS = {"large_field": _large_field, "fitc_field": _fitc_field}


def make(cfg: dict, seed: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """(x (n, d), y (p, n)) float64 on ``device`` for configuration ``cfg``:
    inputs uniform on [0, 1]^d, outputs the field at p points of [0, 1] plus
    N(0, noise^2) noise, drawn from ``cfg['data_seed']``; the rows in an
    order drawn from ``seed``."""
    n, p, d = int(cfg["n"]), int(cfg["p"]), int(cfg["d"])
    g = generator(int(cfg["data_seed"]), device)
    x = torch.rand((n, d), generator=g, dtype=F64, device=device)
    t = torch.linspace(0.0, 1.0, p, dtype=F64, device=device)[:, None]
    f = FIELDS[cfg["field"]](t, x)
    y = f + float(cfg["noise"]) * torch.randn(
        f.shape, generator=g, dtype=F64, device=device)
    perm = torch.randperm(n, generator=generator(seed, device),
                          device=device)
    return x[perm].contiguous(), y[:, perm].contiguous()


def inputs(n0: int, d: int, g: torch.Generator, device) -> torch.Tensor:
    """n0 prediction inputs uniform over the training box [0, 1]^d."""
    return torch.rand((n0, d), generator=g, dtype=F64, device=device)
