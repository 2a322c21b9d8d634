"""L-BFGS on the device: the port of ``lcgp_tpu``'s ``fit(method='lbfgs-jax')``
(``lcgp_tpu/fit/optax_fit.py:110-190``, ``minimize_lbfgs_jax``).

The method keeps its name for surface parity.  It is a transcription of
optax 0.2.6's ``optax.lbfgs()`` as the JAX package builds it:

- ``scale_by_lbfgs(memory_size=10, scale_init_precond=True)``: the memory
  update and the two-loop recursion (``optax/_src/transform.py:1497-1753``);
- ``scale(-1)``;
- ``scale_by_zoom_linesearch(max_linesearch_steps=20,
  initial_guess_strategy='one')`` with optax's other defaults
  (``optax/_src/linesearch.py:455-1625``): the interval search, the zoom
  with cubic, quadratic and bisection steps, the Armijo and approximate
  (Hager-Zhang) decrease rules, the curvature rule and the safe step; or
  ``scale_by_backtracking_linesearch(max_backtracking_steps=20,
  store_grad=True)`` (``linesearch.py:75-441``) for
  ``linesearch='backtracking'``.

It is not ``torch.optim.LBFGS``, whose strong-Wolfe search is another
algorithm: here the iterates follow the JAX package's.  The parameter
vector, the memory and the two-loop recursion stay on the parameters'
device; the line search's scalars (values, slopes, step sizes) are read to
the host, one synchronisation per evaluation, where the search decides its
next step as optax's ``while_loop`` does on the device.  Each evaluation
is one loss and its gradient (``nfev`` counts them); the value and
gradient at the accepted step are reused by the next iteration, as
``optax.value_and_grad_from_state`` reuses them.  Spans
(``utils.profiling``): ``lcgp.fit`` the whole minimization,
``lcgp.fit.eval`` each evaluation.
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch

from ..utils.profiling import span
from ._flat import Flattener
from .adam import DeviceFitResult, PlateauTracker

_MEMORY = 10
_MAX_LS_STEPS = 20

# optax.scale_by_zoom_linesearch's defaults
_SLOPE_RTOL = 1e-4
_CURV_RTOL = 0.9
_APPROX_DEC_RTOL = 1e-6
_INTERVAL_THRESHOLD = 1e-5
_INCREASE = 2.0

# optax.scale_by_backtracking_linesearch's defaults
_BT_DECREASE = 0.8
_BT_INCREASE = 1.5
_BT_MAX_LR = 1.0


def _dot(a: torch.Tensor, b: torch.Tensor) -> np.float64:
    return np.float64(torch.dot(a, b).item())


def _nan_to_inf(v):
    return np.inf if np.isnan(v) else v


class _Objective:
    """Loss and gradient over the flat parameter vector; counts calls."""

    def __init__(self, loss_fn: Callable, flattener: Flattener):
        self.loss_fn = loss_fn
        self.flattener = flattener
        self.nfev = 0

    def __call__(self, x: torch.Tensor):
        with span('lcgp.fit.eval'):
            leaf = x.detach().clone().requires_grad_(True)
            v = self.loss_fn(self.flattener.unravel(leaf))
            (g,) = torch.autograd.grad(v, leaf)
            self.nfev += 1
            return np.float64(v.item()), g


class _LBFGSMemory:
    """``optax.scale_by_lbfgs`` followed by ``scale(-1)``: the descent
    direction -P_k g from the last ``_MEMORY`` differences."""

    def __init__(self, x0: torch.Tensor):
        self.count = 0
        self.params = torch.zeros_like(x0)
        self.updates = torch.zeros_like(x0)
        self.dw = x0.new_zeros((_MEMORY,) + tuple(x0.shape))
        self.du = x0.new_zeros((_MEMORY,) + tuple(x0.shape))
        self.rho = x0.new_zeros((_MEMORY,))

    def direction(self, grad: torch.Tensor, params: torch.Tensor):
        m = _MEMORY
        idx, prev = self.count % m, (self.count - 1) % m
        if self.count > 0:
            dw = params - self.params
            du = grad - self.updates
            vd = torch.dot(du, dw)
            self.rho[prev] = torch.where(vd == 0.0, torch.zeros_like(vd),
                                         1.0 / vd)
            den = torch.sum(du * du)
            scale = torch.where(den > 0.0, torch.dot(du, dw) / den,
                                torch.ones_like(den))
        else:
            dw = torch.zeros_like(params)
            du = torch.zeros_like(params)
            self.rho[prev] = 0.0
            # the first step: a capped reciprocal of the gradient norm
            scale = torch.minimum(torch.ones((), dtype=grad.dtype,
                                             device=grad.device),
                                  1.0 / torch.sqrt(torch.sum(grad * grad)))
        self.dw[prev] = dw
        self.du[prev] = du
        # the two-loop recursion over the memory, oldest slot first
        order = [(idx + i) % m for i in range(m)]
        vec = grad
        alphas = [None] * m
        for pos in reversed(range(m)):
            j = order[pos]
            alphas[pos] = self.rho[j] * torch.dot(self.dw[j], vec)
            vec = vec - alphas[pos] * self.du[j]
        vec = scale * vec
        for pos in range(m):
            j = order[pos]
            beta = self.rho[j] * torch.dot(self.du[j], vec)
            vec = vec + (alphas[pos] - beta) * self.dw[j]
        self.count += 1
        self.params = params
        self.updates = grad
        return -1.0 * vec


def _cubicmin(a, fa, fpa, b, fb, c, fc):
    """Critical point of the cubic through (a, fa), (b, fb), (c, fc) with
    slope fpa at a; NaN when there is none (optax ``_cubicmin``)."""
    C = fpa
    db = b - a
    dc = c - a
    denom = (db * dc) * (db * dc) * (db - dc)
    r1 = fb - fa - C * db
    r2 = fc - fa - C * dc
    A = (dc * dc * r1 + (-(db * db)) * r2) / denom
    B = ((-(dc * dc * dc)) * r1 + db * db * db * r2) / denom
    radical = B * B - 3.0 * A * C
    return a + (-B + np.sqrt(radical)) / (3.0 * A)


def _quadmin(a, fa, fpa, b, fb):
    """Critical point of the quadratic through (a, fa), (b, fb) with slope
    fpa at a (optax ``_quadmin``)."""
    db = b - a
    B = (fb - fa - fpa * db) / (db * db)
    return a - fpa / (2.0 * B)


class _Zoom:
    """One run of optax's ``zoom_linesearch`` along ``updates`` from
    ``params``; the fields are those of its ``ZoomLinesearchState``."""

    def __init__(self, obj, params, updates, value, grad):
        self.obj, self.params, self.updates = obj, params, updates
        slope = _dot(updates, grad)
        self.count = 0
        self.stepsize, self.value, self.grad, self.slope = (
            np.float64(0.0), value, grad, slope)
        self.value_init, self.slope_init = value, slope
        self.decrease_error = self.curvature_error = np.float64(np.inf)
        self.interval_found = self.done = self.failed = False
        self.low, self.value_low, self.slope_low = (np.float64(0.0), value,
                                                    slope)
        self.high, self.value_high, self.slope_high = (np.float64(0.0),
                                                       value, slope)
        self.cubic_ref, self.value_cubic_ref = np.float64(0.0), value
        self.safe_stepsize, self.safe_value, self.safe_grad = (
            np.float64(0.0), value, grad)

    def _on_line(self, stepsize):
        v, g = self.obj(self.params + float(stepsize) * self.updates)
        return v, g, _dot(g, self.updates)

    def _decrease_error(self, stepsize, value_step, slope_step):
        err = (value_step - self.value_init
               - _SLOPE_RTOL * stepsize * self.slope_init)
        approx = slope_step - (2 * _SLOPE_RTOL - 1.0) * self.slope_init
        delta = (value_step - self.value_init
                 - _APPROX_DEC_RTOL * np.abs(self.value_init))
        err = np.minimum(np.maximum(approx, delta), err)
        return _nan_to_inf(np.maximum(err, 0.0))

    def _curvature_error(self, slope_step):
        err = np.abs(slope_step) - _CURV_RTOL * np.abs(self.slope_init)
        return _nan_to_inf(np.maximum(err, 0.0))

    def _search_interval(self):
        """Algorithm 3.5 of Nocedal and Wright."""
        it = self.count
        new = np.float64(1.0) if it == 0 else _INCREASE * self.stepsize
        v, g, sl = self._on_line(new)
        de = self._decrease_error(new, v, sl)
        ce = self._curvature_error(sl)
        err = np.maximum(de, ce)
        if de <= 0.0:
            self.safe_stepsize, self.safe_value, self.safe_grad = new, v, g
        set_high = bool(de > 0.0) or bool(v >= self.value and it > 0)
        set_low = bool(sl >= 0.0) and not set_high
        prev = (self.stepsize, self.value, self.slope)
        if set_low:
            low, high = (new, v, sl), prev
        else:
            low, high = prev, (new, v, sl)
        self.low, self.value_low, self.slope_low = low
        self.high, self.value_high, self.slope_high = high
        self.cubic_ref, self.value_cubic_ref = self.low, self.value_low
        self.interval_found = set_high or set_low or bool(err <= 0.0)
        self.done = bool(err <= 0.0)
        self.failed = (it + 1 >= _MAX_LS_STEPS) and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = new, v, g, sl
        self.decrease_error, self.curvature_error = de, ce

    def _zoom_into_interval(self):
        """Algorithm 3.6 of Nocedal and Wright."""
        it = self.count
        low, high = self.low, self.high
        delta = np.abs(high - low)
        left, right = np.minimum(high, low), np.maximum(high, low)
        cubic_chk, quad_chk = 0.2 * delta, 0.1 * delta
        too_small = bool(delta <= _INTERVAL_THRESHOLD)
        mc = _cubicmin(low, self.value_low, self.slope_low, high,
                       self.value_high, self.cubic_ref, self.value_cubic_ref)
        use_cubic = bool((mc > left + cubic_chk) & (mc < right - cubic_chk))
        mq = _quadmin(low, self.value_low, self.slope_low, high,
                      self.value_high)
        use_quad = (not use_cubic) and bool((mq > left + quad_chk)
                                            & (mq < right - quad_chk))
        if use_cubic:
            middle = mc
        elif use_quad:
            middle = mq
        else:
            middle = (low + high) / 2.0
        v, g, sl = self._on_line(middle)
        de = self._decrease_error(middle, v, sl)
        ce = self._curvature_error(sl)
        err = np.maximum(de, ce)
        if de <= 0.0 and v < self.safe_value:
            self.safe_stepsize, self.safe_value, self.safe_grad = middle, v, g
        self.done = bool(err <= 0.0)
        set_high_to_middle = bool(de > 0.0) or bool(v >= self.value_low)
        set_high_to_low = (bool(sl * (high - low) >= 0.0)
                           and not set_high_to_middle)
        old_low = (self.low, self.value_low, self.slope_low)
        old_high = (self.high, self.value_high, self.slope_high)
        new_high = (middle, v, sl) if set_high_to_middle else old_high
        if set_high_to_low:
            new_high = old_low
        new_low = old_low if set_high_to_middle else (middle, v, sl)
        # the cubic reference is the old high if high changed, else the
        # old low
        if set_high_to_middle or set_high_to_low:
            self.cubic_ref, self.value_cubic_ref = old_high[:2]
        else:
            self.cubic_ref, self.value_cubic_ref = old_low[:2]
        self.low, self.value_low, self.slope_low = new_low
        self.high, self.value_high, self.slope_high = new_high
        presumably_failed = ((it + 1 >= _MAX_LS_STEPS)
                             or (too_small and self.safe_stepsize > 0.0))
        self.failed = presumably_failed and not self.done
        self.count = it + 1
        self.stepsize, self.value, self.grad, self.slope = middle, v, g, sl
        self.decrease_error, self.curvature_error = de, ce

    def _try_safe_step(self):
        if self.safe_stepsize > 0.0 or np.isinf(self.decrease_error):
            self.stepsize, self.value, self.grad = (
                self.safe_stepsize, self.safe_value, self.safe_grad)

    def run(self):
        """(stepsize, value, gradient) at the accepted step."""
        while not (self.done or self.failed):
            if self.interval_found:
                self._zoom_into_interval()
            else:
                self._search_interval()
            if self.failed:
                self._try_safe_step()
        return self.stepsize, self.value, self.grad


def _backtracking(obj, params, updates, value, grad, prev_lr):
    """``optax.scale_by_backtracking_linesearch`` (Armijo, store_grad):
    (learning rate, value, gradient) at the accepted step."""
    slope = _dot(updates, grad)
    lr = np.minimum(_BT_INCREASE * prev_lr, _BT_MAX_LR)
    new_value, new_grad = value, torch.zeros_like(params)
    err, it = np.float64(np.inf), 0
    while not (err <= 0.0) and it <= _MAX_LS_STEPS:
        if it > 0:
            lr = _BT_DECREASE * lr
        v, g = obj(params + float(lr) * updates)
        err = _nan_to_inf(v - 1.0 * value - lr * _SLOPE_RTOL * slope)
        err = np.maximum(err, 0.0)
        if err <= 0.0 or it == _MAX_LS_STEPS:
            new_grad = g
        new_value = v
        it += 1
    # no step at all where every trial was infinite or NaN
    return (np.float64(0.0) if np.isinf(err) else lr), new_value, new_grad


def minimize_lbfgs_jax(loss_fn: Callable, params0, *, maxiter: int = 500,
                       tol: float = 1e-9, block_iters: int = 25,
                       linesearch: str = 'zoom', verbose: bool = False,
                       plateau_rtol: float = None,
                       callback: Callable = None) -> DeviceFitResult:
    """L-BFGS with optax's zoom (or backtracking) line search: the port of
    ``lcgp_tpu.fit.optax_fit.minimize_lbfgs_jax``.

    Stops when the gradient's global norm at the current iterate is at
    most ``tol`` ('gtol'), after ``maxiter`` iterations ('cap'), or, with
    ``plateau_rtol``, when the loss fell by less than that (relative) over
    a block ('plateau').  Every ``block_iters`` iterations, and at a stop,
    the loop reports: ``verbose`` prints, ``callback(step, loss, params)``
    runs, and the stop rules that need the loss are checked, as the JAX
    package's host syncs between its on-device blocks do."""
    if linesearch not in ('zoom', 'backtracking'):
        raise ValueError(f"linesearch must be 'zoom' or 'backtracking', got "
                         f"{linesearch!r}")
    # optax's scalar arithmetic: 1/0 is inf and sqrt(-1) NaN, unannounced
    with np.errstate(all='ignore'), span('lcgp.fit'):
        flattener = Flattener(params0)
        x = flattener.ravel(params0).detach().clone()
        obj = _Objective(loss_fn, flattener)
        memory = _LBFGSMemory(x)
        # the line search's state: the value and gradient at the current
        # iterate (none yet) and its last learning rate
        value, grad, lr = np.float64(np.inf), torch.zeros_like(x), 1.0
        plateau = PlateauTracker(plateau_rtol)
        it = 0
        while True:
            start = it
            while (it < start + block_iters and it < maxiter
                   and (it == 0 or float(torch.sqrt(torch.sum(grad * grad)))
                        > tol)):
                if not np.isfinite(value):
                    value, grad = obj(x)
                direction = memory.direction(grad, x)
                if linesearch == 'zoom':
                    lr, value, grad = _Zoom(obj, x, direction, value,
                                            grad).run()
                else:
                    lr, value, grad = _backtracking(obj, x, direction, value,
                                                    grad, lr)
                x = x + float(lr) * direction
                it += 1
            v = float(value)
            if verbose:
                print(f'[lcgp_tpu_torch.fit lbfgs-jax] iter {it:4d}  '
                      f'loss {v:.8g}')
            if callback is not None:
                callback(it, v, flattener.unravel(x.clone()))
            if it == start:
                reason = 'gtol'     # no iteration: the gradient norm stop
                break
            if plateau.update(v):
                reason = 'plateau'
                break
            if it >= maxiter:
                reason = 'cap'
                break
    return DeviceFitResult(params=flattener.unravel(x.clone()), fun=v,
                           nit=it, stop_reason=reason, nfev=obj.nfev)
