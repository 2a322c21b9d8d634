"""Replication grouping (reference lcgp.py:329-434).

A copy of ``lcgp_tpu/models/replication.py``: it is pure NumPy, and
importing it from ``lcgp_tpu`` would import JAX through that package's
``__init__``.  Grouping produces data-dependent shapes, so it runs on the
host before anything reaches the device.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Replication(NamedTuple):
    x_unique: np.ndarray   # (n, d) unique raw inputs (lexicographically sorted)
    group_ids: np.ndarray  # (N,) int32: row -> unique index
    r: np.ndarray          # (n,) int32 replicate counts
    ybar: np.ndarray       # (p, n) per-group mean of raw y


def group_replicates(x_raw, y_raw) -> Replication:
    """Group duplicate rows of x and average y within groups.

    x_raw: (N, d); y_raw: (p, N).  Unique rows in ``np.unique(axis=0)``
    order (sorted lexicographically), as the reference (lcgp.py:349-356).
    """
    xr = np.asarray(x_raw, dtype=np.float64)
    yr = np.asarray(y_raw, dtype=np.float64)
    if xr.ndim != 2:
        raise AssertionError("x_raw must be (N, d)")
    if yr.ndim != 2:
        raise AssertionError("y_raw must be (p, N)")
    if yr.shape[1] != xr.shape[0]:
        raise AssertionError("y_raw columns must match x_raw rows")

    x_unique, inverse, counts = np.unique(
        xr, axis=0, return_inverse=True, return_counts=True)
    inverse = inverse.reshape(-1)
    n = x_unique.shape[0]

    # segment mean: scatter-add columns of y into their group (in row
    # order, as lcgp_tpu sums them), then divide by the count
    ysum = np.zeros((yr.shape[0], n), dtype=np.float64)
    np.add.at(ysum.T, inverse, yr.T)
    ybar = ysum / counts[None, :]

    return Replication(x_unique=x_unique, group_ids=inverse.astype(np.int32),
                       r=counts.astype(np.int32), ybar=ybar)
