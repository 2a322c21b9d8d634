"""The ``refit`` traffic: repeated fits of ``LCGP.fit``, each from the same
init, for the length of the window.

Set-up builds the model from the seed's data and warms the window's own
call with a fit of one iteration, which builds or loads the kernel library
and runs every shape a fit runs.  The window runs fits of the mix's
``maxiter`` back to back until its time is up (the fit under way then
finishes); ``fit_iter_ms`` is its time over the iterations done in it.
"""
from __future__ import annotations

import sys
import time
import traceback

import numpy as np
import torch

from hb import build_model, check, data_for, inducing_points
from reference import lcgp_ref as R


def _flat_host(params) -> np.ndarray:
    return torch.cat([t.detach().reshape(-1).to(torch.float64)
                      for t in params]).cpu().numpy()


def run_fit(ctx, model, maxiter: int) -> dict:
    """One fit from the init, with the loss and iterate of every iteration
    the fit's callback hands over."""
    from lcgp_tpu_torch.models.params import FreeParams
    model.free = FreeParams(*(t.clone() for t in ctx.free0))
    seen = {}

    def callback(step, loss, params):
        seen[int(step)] = (float(loss), _flat_host(params))

    model.fit(method=ctx.cfg["fit"]["method"], maxiter=maxiter,
              callback=callback)
    res = model._fit_result
    return dict(nit=int(res.nit), nfev=int(res.nfev),
                final=_flat_host(model.free), iters=seen)


def setup(ctx):
    ctx.x, ctx.y = data_for(ctx)
    ctx.mark("data")
    ctx.model = build_model(ctx)
    ctx.free0 = tuple(t.detach().clone() for t in ctx.model.free)
    ctx.mark("construction")
    run_fit(ctx, ctx.model, 1)
    ctx.mark("warm-up fit of one iteration (builds or loads the kernel "
             "library)")


def window(ctx):
    t0 = time.perf_counter()
    fits, failed = [], 0
    while time.perf_counter() < t0 + ctx.seconds:
        try:
            fits.append(run_fit(ctx, ctx.model, int(ctx.traffic["maxiter"])))
        except Exception:  # noqa: BLE001 — a failed fit is counted
            traceback.print_exc(file=sys.stderr)
            failed = 1
            break
    ctx.window = dict(seconds=time.perf_counter() - t0, fits=fits,
                      attempted=len(fits) + failed, failed=failed)


def traced_window(ctx):
    from hb.trace import traced
    with traced() as held:
        window(ctx)
    ctx.trace = held.trace
    ctx.sub = loss_grad_subwindow(ctx)


def loss_grad_subwindow(ctx, seconds: float = 1.0) -> dict:
    """``model.loss()`` and its backward at the init, outside the
    optimizer, each ending in a synchronize, until ``seconds`` have passed
    (at least three)."""
    from lcgp_tpu_torch.models.params import FreeParams
    model = ctx.model
    leaves = [t.clone().requires_grad_(True) for t in ctx.free0]
    model.free = FreeParams(*leaves)
    evals = 0
    t0 = time.perf_counter()
    while evals < 3 or time.perf_counter() - t0 < seconds:
        for t in leaves:
            t.grad = None
        model.loss().backward()
        torch.cuda.synchronize()
        evals += 1
    return dict(evals=evals, seconds=time.perf_counter() - t0)


def release(ctx):
    ctx.model = None


def lossfn(ctx, prob, z, dtype=torch.float64, tf32=False):
    """``fn(free, grad=False) -> (loss, gradient or None)`` of the plain
    reference in ``dtype``; the control's setting (TF32) held around each
    call."""
    def fn(free, grad=False):
        with check.precision(dtype, tf32):
            if z is not None:
                return R.fitc_loss(free, prob, z, dt=dtype, grad=grad)
            return R.exact_loss(free, prob, dt=dtype, grad=grad)
    return fn


def control_lossfn(ctx, prob, z):
    return lossfn(ctx, prob, z,
                  *check.CONTROL[ctx.cfg["model"]["precision"]])


def half_batch_lossfn(ctx, prob, z):
    """A planted fault: the loss over the first half of the rows, scaled to
    the whole (half the batch left out, the mean taken over the rest)."""
    h = prob.xs.shape[0] // 2
    base = lossfn(ctx, prob._replace(xs=prob.xs[:h], ys=prob.ys[:, :h]), z)

    def fn(free, grad=False):
        v, g = base(free, grad)
        return 2.0 * v, (None if g is None
                         else {k: 2.0 * t for k, t in g.items()})
    return fn


def numbers(ctx, stand_ins=None) -> dict:
    """The fit cell's compared numbers over the window's fits: the
    program's, or with ``stand_ins`` ({name: fn(ctx, prob, z) -> lossfn}:
    the control, a planted fault) each stand-in's in the program's place,
    as {name: numbers}.

    loss_gap: the loss each fit reports at every iterate its callback hands
    over, up to its last, against the reference's loss there, per output
    entry.  grad_gap: the direction of each fit's first step (L-BFGS's
    first step is along minus the gradient) against the reference's
    gradient at the reference's own init.  change_gap: each fit's change
    from the init to its end against the change that the configuration's
    reference optimizer (a ``scipy.optimize.minimize`` method) makes over
    the reference in the same number of iterations.  A stand-in gives its
    loss at the same iterates, its gradient at the init and the reference
    optimizer's change over it."""
    fits = ctx.window["fits"]
    maxiter = int(ctx.traffic["maxiter"])
    method = ctx.cfg["fit"]["reference_optimizer"]
    prob = R.prepare(ctx.x, ctx.y, int(ctx.cfg["model"]["q"]))
    th0 = R.init_free(prob)
    flat0 = R.flat(th0).cpu().numpy()
    z = inducing_points(ctx, prob)
    ref = lossfn(ctx, prob, z)
    g0 = R.flat(ref(th0, grad=True)[1]).cpu().numpy()
    # every reported iterate, once: {bytes: (free, [reported loss, ...])}
    points: dict = {}
    for f in fits:
        for loss, vec in f["iters"].values():
            entry = points.setdefault(vec.tobytes(),
                                      (R.unflat(vec, th0), []))
            entry[1].append(loss)
    print(f"check: {len(points)} distinct iterates in {len(fits)} fits",
          file=sys.stderr)
    lref = {k: ref(free)[0] for k, (free, _) in points.items()}
    per = int(ctx.cfg["n"]) * int(ctx.cfg["p"])
    want = check.reference_change(ref, th0, maxiter, method)
    if stand_ins is None:
        # a fit that does not hand over its first and last iterates reads
        # infinity: what it did cannot be checked
        unseen = [f for f in fits
                  if 1 not in f["iters"] or f["nit"] not in f["iters"]]
        return {"loss_gap": max(
                    [check.loss_gap(v, lref[k], per)
                     for k, (_, got) in points.items() for v in got]
                    + [float("inf")] * bool(unseen or not fits)),
                "grad_gap": max([check.norm_gap(flat0 - f["iters"][1][1],
                                                g0, th0, direction=True)
                                 for f in fits if 1 in f["iters"]],
                                default=float("inf")),
                "change_gap": max([check.norm_gap(f["final"] - flat0, want,
                                                  th0) for f in fits],
                                  default=float("inf"))}
    res = {}
    for name, make in stand_ins.items():
        alt = check.failing_as_inf(make(ctx, prob, z))
        res[name] = {
            "loss_gap": max(check.loss_gap(alt(free)[0], lref[k], per)
                            for k, (free, _) in points.items()),
            "grad_gap": check.norm_gap(R.flat(alt(th0, grad=True)[1])
                                       .cpu().numpy(), g0, th0,
                                       direction=True),
            "change_gap": check.norm_gap(
                check.reference_change(alt, th0, maxiter, method), want,
                th0)}
    return res


def stand_in_numbers(ctx) -> dict:
    """The control's and a planted fault's numbers, for setting limits."""
    return numbers(ctx, stand_ins={"control": control_lossfn,
                                   "half_batch": half_batch_lossfn})
