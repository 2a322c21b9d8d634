"""Input/output standardization (counterpart of ``lcgp_tpu/models/transforms.py``).

Plain functions on float64 tensors; they keep the device of their input.
"""
from __future__ import annotations

import numpy as np
import torch


def standardize_x(x: torch.Tensor):
    """Min-max scale x to [0,1]^d.  Returns (xs, x_min, x_max)."""
    x_min = torch.amin(x, dim=0)
    x_max = torch.amax(x, dim=0)
    xs = (x - x_min) / (x_max - x_min)
    return xs, x_min, x_max


def xnorm(x, block: int = 1024):
    """Per-dimension mean positive pairwise |x_i - x_j| (host NumPy)."""
    x = np.asarray(x)
    n, d = x.shape
    out = np.zeros(d)
    for j in range(d):
        tot = 0.0
        cnt = 0
        col = x[:, j]
        for s in range(0, n, block):
            dist = np.abs(col[s:s + block, None] - col[None, :])
            pos = dist > 0
            tot += dist[pos].sum()
            cnt += int(pos.sum())
        out[j] = tot / cnt if cnt else 0.0
    return out


def _median_rows(y: torch.Tensor) -> torch.Tensor:
    # jnp.percentile(..., 50) interpolates linearly between the two middle
    # elements of an even-length row; torch.median would return the lower one
    return torch.quantile(y, 0.5, dim=1, keepdim=True, interpolation='linear')


def center_spread(y: torch.Tensor, robust: bool, floor_zero_spread: bool = False):
    """Per-output-row center/spread.

    robust=True  -> median / median-absolute-deviation
    robust=False -> mean / population std
    floor_zero_spread replaces non-positive spreads with 1.
    """
    if robust:
        c = _median_rows(y)
        s = _median_rows(torch.abs(y - c))
    else:
        c = torch.mean(y, dim=1, keepdim=True)
        s = torch.std(y, dim=1, keepdim=True, correction=0)
    if floor_zero_spread:
        s = torch.where(s > 0, s, torch.ones_like(s))
    return c, s


def standardize_y(y: torch.Tensor, robust: bool):
    """Full-path y standardization.  Returns (ys, center, spread)."""
    c, s = center_spread(y, robust, floor_zero_spread=False)
    return (y - c) / s, c, s
