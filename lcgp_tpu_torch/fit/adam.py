"""Adam on the device (counterpart of ``lcgp_tpu/fit/optax_fit.py``'s
``minimize_adam`` and ``PlateauTracker``).

Adam is written out on the flat parameter vector with optax's defaults and
order of operations (``optax.adam``: b1=0.9, b2=0.999, eps=1e-8,
bias-corrected ``m_hat / (sqrt(v_hat) + eps)``), so a few steps match the
JAX package to rounding.  The loop stays on the device; it reads the loss
back only every ``block_steps`` steps, for ``verbose`` and ``callback``.
The JAX package segments its scan there to bound a TPU dispatch; PyTorch
dispatches step by step, so here the blocks are only that cadence.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import numpy as np
import torch

from ._flat import Flattener

_B1, _B2, _EPS = 0.9, 0.999, 1e-8


class DeviceFitResult(NamedTuple):
    params: object
    fun: float
    nit: int
    stop_reason: str = 'cap'   # 'gtol' | 'plateau' | 'cap' | 'steps'
    nfev: int = 0              # loss and gradient evaluations


class PlateauTracker:
    """Early stop for host-synced block loops: stop once the best loss so
    far has failed to improve by ``rtol`` (relative) for ``patience``
    consecutive syncs.  ``rtol=None`` disables.  A line-searched L-BFGS
    loss is monotone, so patience=1 suffices there; a non-monotone Adam
    loop needs patience > 1 so transient oscillation cannot cut a fit."""

    def __init__(self, rtol, patience: int = 1):
        self.rtol = rtol
        self.patience = patience
        self.best = np.inf
        self.stale = 0

    def update(self, v: float) -> bool:
        """Feed one synced loss value; True means stop on plateau."""
        if self.rtol is None or not np.isfinite(v):
            return False
        if (self.best - v) / max(1.0, abs(v)) < self.rtol:
            self.stale += 1
            if self.stale >= self.patience:
                return True
        else:
            self.stale = 0
        self.best = min(self.best, v)
        return False


def minimize_adam(loss_fn: Callable, params0, *, steps: int = 500,
                  learning_rate: float = 5e-2, block_steps: int = 50,
                  verbose: bool = False,
                  callback: Callable = None) -> DeviceFitResult:
    """``steps`` Adam steps on loss_fn(params).

    callback(step, loss, params) is invoked every ``block_steps`` steps and
    after the last (use for mid-fit checkpointing/telemetry).  ``fun`` is
    the loss evaluated at the last step, before its update, as the JAX
    package reports it."""
    flattener = Flattener(params0)
    x = flattener.ravel(params0).detach().clone()
    mu = torch.zeros_like(x)
    nu = torch.zeros_like(x)
    last = None
    v = None
    for count in range(1, steps + 1):
        leaf = x.clone().requires_grad_(True)
        v = loss_fn(flattener.unravel(leaf))
        (g,) = torch.autograd.grad(v, leaf)
        v = v.detach()
        with torch.no_grad():
            mu = (1 - _B1) * g + _B1 * mu
            nu = (1 - _B2) * (g ** 2) + _B2 * nu
            mu_hat = mu / (1 - _B1 ** count)
            nu_hat = nu / (1 - _B2 ** count)
            x = x + (-learning_rate) * (mu_hat / (torch.sqrt(nu_hat) + _EPS))
        if count % block_steps == 0 or count == steps:
            last = float(v)
            if verbose:
                print(f'[lcgp_tpu_torch.fit adam] step {count:4d}  '
                      f'loss {last:.8g}')
            if callback is not None:
                callback(count, last, flattener.unravel(x.clone()))
    # Adam's step count is a budget, not a convergence criterion: 'steps'
    # (not 'cap') keeps fit() from announcing a premature stop
    return DeviceFitResult(params=flattener.unravel(x.clone()), fun=last,
                           nit=steps, stop_reason='steps', nfev=steps)
