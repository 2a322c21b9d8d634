"""scipy L-BFGS-B over the loss and its autograd gradient (counterpart of
``lcgp_tpu/fit/scipy_lbfgs.py``).

The reference's training semantics: gpflow.optimizers.Scipy wrapping
scipy.optimize.minimize(method='L-BFGS-B') with default options.  Each
evaluation builds a fresh leaf on the model's device from scipy's iterate,
runs the loss and ``torch.autograd.grad``, and copies the value and the
gradient to the host in one transfer: the one synchronisation per
evaluation.  Spans (``utils.profiling``): ``lcgp.fit`` the whole
minimization, ``lcgp.fit.eval`` each evaluation.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import numpy as np
import scipy.optimize
import torch

from ..utils.profiling import span
from ._flat import Flattener


class FitResult(NamedTuple):
    params: object          # optimized parameters (same type as params0)
    fun: float
    nit: int
    nfev: int
    success: bool
    message: str
    stop_reason: str = 'gtol'   # 'gtol' | 'plateau' | 'cap' | 'other'


def value_and_grad(loss_fn: Callable, flattener: Flattener):
    """z (host float64) -> (loss, flat gradient) as host float64."""
    def vg(z):
        flat = torch.as_tensor(np.asarray(z, dtype=np.float64),
                               device=flattener.device).clone()
        flat.requires_grad_(True)
        v = loss_fn(flattener.unravel(flat))
        (g,) = torch.autograd.grad(v, flat)
        host = torch.cat([v.detach().reshape(1).to(torch.float64),
                          g]).cpu().numpy()
        return float(host[0]), host[1:]
    return vg


def minimize_lbfgs(loss_fn: Callable, params0, verbose: bool = False,
                   callback: Callable = None,
                   plateau_patience: Optional[int] = None,
                   plateau_rtol: float = 1e-8,
                   **scipy_options) -> FitResult:
    """Minimize loss_fn(params) with scipy L-BFGS-B.

    scipy_options are forwarded to scipy's ``options`` dict (maxiter, ftol,
    gtol, ...); defaults are scipy's, matching gpflow's defaults.
    callback(iteration, loss, params) is invoked per L-BFGS iteration.

    plateau_patience: if set, stop once the relative loss decrease over the
    last ``plateau_patience`` iterations falls below ``plateau_rtol``.  The
    result's ``stop_reason`` records why optimization ended
    ('gtol'/'plateau'/'cap'/'other').
    """
    flattener = Flattener(params0)
    flat0 = flattener.ravel(params0).cpu().numpy()
    vg = value_and_grad(loss_fn, flattener)

    neval = 0
    nit_seen = 0
    last_val = [np.inf]
    history: list = []
    plateaued = [False]

    last_xk = [None]

    def scipy_cb(xk):
        nonlocal nit_seen
        nit_seen += 1
        last_xk[0] = np.array(xk, copy=True)
        if callback is not None:
            callback(nit_seen, last_val[0], flattener.unravel_host(xk))
        if plateau_patience is not None:
            history.append(last_val[0])
            if len(history) > plateau_patience:
                prev = history[-plateau_patience - 1]
                cur = history[-1]
                denom = max(1.0, abs(cur))
                if np.isfinite(prev) and np.isfinite(cur) and \
                        (prev - cur) / denom < plateau_rtol:
                    plateaued[0] = True
                    raise StopIteration

    def fun_and_jac(z):
        nonlocal neval
        neval += 1
        with span('lcgp.fit.eval'):
            v, g = vg(z)
            if not np.isfinite(v):
                # L-BFGS-B backtracks reliably on inf but can stall on NaN:
                # map any non-finite objective to +inf and kill non-finite
                # gradient entries so the line search can recover
                v = np.inf
                g = np.where(np.isfinite(g), g, 0.0)
        if verbose:
            print(f"[lcgp_tpu_torch.fit] eval {neval:4d}  loss {v:.8g}")
        last_val[0] = v
        return v, g

    use_cb = callback is not None or plateau_patience is not None
    try:
        with span('lcgp.fit'):
            res = scipy.optimize.minimize(
                fun_and_jac,
                np.asarray(flat0, dtype=np.float64),
                jac=True,
                method="L-BFGS-B",
                callback=scipy_cb if use_cb else None,
                options=scipy_options or None,
            )
    except StopIteration:
        # scipy < 1.11 does not turn a callback's StopIteration into a
        # graceful stop; recover the best-seen iterate
        res = scipy.optimize.OptimizeResult(
            x=last_xk[0] if last_xk[0] is not None
            else np.asarray(flat0, dtype=np.float64),
            fun=last_val[0], nit=nit_seen, nfev=neval, success=True,
            message='plateau stop (pre-1.11 scipy StopIteration path)')
    msg = str(res.message)
    if plateaued[0]:
        reason = 'plateau'
    elif 'MAXIMUM NUMBER OF ITERATION' in msg.upper() or \
            ('maxiter' in scipy_options
             and int(res.nit) >= int(scipy_options['maxiter'])):
        reason = 'cap'
    elif res.success:
        reason = 'gtol'
    else:
        reason = 'other'
    return FitResult(
        params=flattener.unravel_host(res.x),
        fun=float(res.fun),
        nit=int(res.nit),
        nfev=int(res.nfev),
        success=bool(res.success) or plateaued[0],
        message=msg,
        stop_reason=reason,
    )
