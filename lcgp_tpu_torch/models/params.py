"""Hyperparameters: SoftClip-constrained parameter set + data-driven init
(counterpart of ``lcgp_tpu/models/params.py``).

SoftClip (hinge softness 1, the gpflow default):

    f(x) = low + softplus(x - low) - softplus(x - high)

with the closed-form inverse, for u = y - low and delta = high - low,

    f^{-1}(y) = low + u + log1p(-exp(-u)) - log1p(-exp(u - delta)).
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


def softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x), exact everywhere.

    ``torch.nn.functional.softplus`` returns x itself above its threshold
    (20), an error of about 2e-9 there; ``jax.nn.softplus`` is
    ``logaddexp(x, 0)``, which this matches."""
    return torch.logaddexp(x, torch.zeros_like(x))


class SoftClip(NamedTuple):
    low: float
    high: float

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = self.low + softplus(x - self.low) - softplus(x - self.high)
        # fp rounding can land an ulp outside (low, high) for narrow
        # intervals.  jnp.clip is minimum(maximum(.)), whose gradient splits
        # a tie (y exactly on a bound) half and half; torch.clamp would pass
        # the whole gradient, twice JAX's, so clip the same way here.
        low = torch.full_like(y, self.low)
        high = torch.full_like(y, self.high)
        return torch.minimum(torch.maximum(y, low), high)

    def inverse(self, y: torch.Tensor) -> torch.Tensor:
        u = y - self.low
        delta = self.high - self.low
        return (self.low + u + torch.log1p(-torch.exp(-u))
                - torch.log1p(-torch.exp(u - delta)))


class Identity(NamedTuple):
    def forward(self, x):
        return x

    def inverse(self, y):
        return y


# Constraint ranges, exactly the reference's (lcgp.py:184-210)
LLMB_CLIP = SoftClip(1e-6, 1e4)      # per-dim lengthscales
LLMB0_CLIP = SoftClip(1e-4, 1e4)     # amplitudes
LNUG_CLIP = SoftClip(math.exp(-16.0), math.exp(-2.0))  # nugget scale
LSIGMA_ID = Identity()               # error log-variances: unconstrained


class FreeParams(NamedTuple):
    """Unconstrained parameters.  lLmb (q,d), lLmb0 (q,), lsigma2s
    (n_groups,), lnugGPs (q,)."""
    lLmb: torch.Tensor
    lLmb0: torch.Tensor
    lsigma2s: torch.Tensor
    lnugGPs: torch.Tensor


def constrain(free: FreeParams):
    """free -> constrained (lLmb, lLmb0, lsigma2s, lnugGPs)."""
    return (
        LLMB_CLIP.forward(free.lLmb),
        LLMB0_CLIP.forward(free.lLmb0),
        LSIGMA_ID.forward(free.lsigma2s),
        LNUG_CLIP.forward(free.lnugGPs),
    )


def unconstrain(lLmb, lLmb0, lsigma2s, lnugGPs) -> FreeParams:
    return FreeParams(
        lLmb=LLMB_CLIP.inverse(lLmb),
        lLmb0=LLMB0_CLIP.inverse(lLmb0),
        lsigma2s=LSIGMA_ID.inverse(lsigma2s),
        lnugGPs=LNUG_CLIP.inverse(lnugGPs),
    )


def sigma_index_map(diag_error_structure, device) -> torch.Tensor:
    """(p,) int64 map: output dim -> error group."""
    idx = np.repeat(np.arange(len(diag_error_structure)),
                    np.asarray(diag_error_structure, dtype=np.int64))
    return torch.as_tensor(idx, dtype=torch.int64, device=device)


def expand_sigma(lsigma2s: torch.Tensor, index_map: torch.Tensor) -> torch.Tensor:
    """(n_groups,) grouped log-variances -> (p,) per-output, via gather."""
    return lsigma2s[index_map]


def init_values(x_std, y_for_sigma, q: int, diag_error_structure,
                device) -> FreeParams:
    """Data-driven constrained init (reference init_params, lcgp.py:490-513),
    returned unconstrained.

    x_std : (N, d) standardized inputs; y_for_sigma : (p, N) the outputs the
    error variances are initialized from (standardized y on the full path).
    """
    x_std = np.asarray(x_std, dtype=np.float64)
    y = np.asarray(y_for_sigma, dtype=np.float64)
    d = x_std.shape[1]

    llmb = np.exp(0.5 * np.log(d) + np.log(np.std(x_std, axis=0)))
    lLmb = np.tile(llmb, q).reshape(q, d)
    lLmb0 = np.ones(q)
    lnug = np.exp(-10.0) * np.ones(q)

    groups = list(diag_error_structure)
    lsig = np.zeros(len(groups))
    col = 0
    for k, g in enumerate(groups):
        lsig[k] = np.log(np.var(y[col:col + g]))
        col += g

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)

    return unconstrain(t(lLmb), t(lLmb0), t(lsig), t(lnug))
