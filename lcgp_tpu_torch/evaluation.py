"""Offline evaluation metrics (a copy of ``lcgp_tpu/evaluation.py``: it is
pure NumPy/SciPy, and importing it from ``lcgp_tpu`` would import JAX
through that package's ``__init__``).

Behavioral spec: reference evaluation.py:5-63 (rmse, range-normalized rmse,
Dawid–Sebastiani score of Gneiting & Raftery (2007) Eq. 25, and 95% interval
coverage/width) plus the variant semantics the reference duplicates in its
run harness (docs/call_model.py:89-126), exposed here as keyword options.

Implementation is independent of the reference and fully vectorized: the
DSS full-covariance path runs one batched ``slogdet`` + one batched
``solve`` over the n test points instead of a per-point Python loop with an
eigendecomposition each — O(ms) for (p=3, n=10k).

All functions are pure NumPy/SciPy and accept anything array-like,
including the port's tensors (on the CPU; move CUDA tensors with
``.cpu()``); layout is the model's (p, n) convention.
"""
from __future__ import annotations

import numpy as np
import scipy.stats as sps


def rmse(y, ypredmean):
    """Root mean squared error over all outputs and points."""
    resid = np.asarray(y, dtype=float) - np.asarray(ypredmean, dtype=float)
    return float(np.sqrt(np.mean(np.square(resid))))


def normalized_rmse(y, ypredmean, method: str = "range",
                    aggregate: str = "pooled"):
    """RMSE with per-output normalization.

    method:
      'range' — divide each output's residuals by that output's value range
                (the reference default, evaluation.py:12-18);
      'std'   — divide by the per-output standard deviation (the harness
                variant, call_model.py:97-101).
    aggregate:
      'pooled'         — sqrt of the mean squared scaled residual over all
                         entries (reference semantics);
      'mean_per_output' — mean over outputs of each output's own scaled RMSE
                         (harness semantics).
    """
    y = np.asarray(y, dtype=float)
    yhat = np.asarray(ypredmean, dtype=float)
    if method == "range":
        scale = np.ptp(y, axis=1, keepdims=True)
    elif method == "std":
        scale = np.std(y, axis=1, keepdims=True)
    else:
        raise ValueError("method must be 'range' or 'std'")
    scale = np.where(scale == 0.0, 1.0, scale)
    scaled = (y - yhat) / scale
    if aggregate == "pooled":
        return float(np.sqrt(np.mean(np.square(scaled))))
    if aggregate == "mean_per_output":
        return float(np.mean(np.sqrt(np.mean(np.square(scaled), axis=1))))
    raise ValueError("aggregate must be 'pooled' or 'mean_per_output'")


def dss(y, ypredmean, ypredcov, use_diag, aggregate: str = "per_point",
        var_floor: float = 0.0):
    """Dawid–Sebastiani score, Gneiting & Raftery (2007) Eq. 25.

    For each test point i with residual r_i and predictive covariance S_i:
        DSS_i = log|S_i| + r_i^T S_i^{-1} r_i

    use_diag=True takes ``ypredcov`` as (p, n) marginal variances (S_i
    diagonal); otherwise as (p, p, n) full covariances.

    aggregate:
      'per_point' — mean of DSS_i over the n points (reference semantics,
                    evaluation.py:40-50);
      'per_entry' — mean over all n*p entries (diag only; harness variant,
                    call_model.py:115-120, i.e. per_point / p).
    var_floor: clamp variances below this to it (harness uses 1e-12).
    """
    y = np.asarray(y, dtype=float)
    mu = np.asarray(ypredmean, dtype=float)
    cov = np.asarray(ypredcov, dtype=float)
    resid = y - mu                                     # (p, n)
    p, n = y.shape

    if use_diag:
        v = np.maximum(cov, var_floor) if var_floor else cov
        per_entry = np.log(v) + np.square(resid) / v   # (p, n)
        if aggregate == "per_entry":
            return float(np.mean(per_entry))
        if aggregate != "per_point":
            raise ValueError("aggregate must be 'per_point' or 'per_entry'")
        return float(np.mean(np.sum(per_entry, axis=0)))

    if aggregate != "per_point":
        raise ValueError("full-covariance dss supports aggregate='per_point'")
    sig = np.moveaxis(cov, -1, 0)                      # (n, p, p)
    _, logdets = np.linalg.slogdet(sig)                # (n,)
    rvec = resid.T[..., None]                          # (n, p, 1)
    quad = np.squeeze(
        np.swapaxes(rvec, -1, -2) @ np.linalg.solve(sig, rvec), (-1, -2))
    return float(np.mean(logdets + quad))


def intervalstats(y, ypredmean, ypredvar, level: float = 0.95, z=None):
    """Empirical central-interval coverage and mean width.

    Default is the 95% normal interval (reference evaluation.py:53-63).
    ``level`` sets a different nominal coverage; ``z`` overrides the
    half-width multiplier directly (harness variant, call_model.py:105-112,
    e.g. z=1.96).
    """
    y = np.asarray(y, dtype=float)
    mu = np.asarray(ypredmean, dtype=float)
    sd = np.sqrt(np.asarray(ypredvar, dtype=float))
    if z is None:
        z = sps.norm.ppf(0.5 + level / 2.0)
    half = z * sd
    coverage = float(np.mean(np.abs(y - mu) <= half))
    width = float(np.mean(2.0 * half))
    return coverage, width
