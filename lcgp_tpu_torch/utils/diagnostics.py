"""Model health diagnostics for production deployments (counterpart of
``lcgp_tpu/utils/diagnostics.py``, reading the port's tensors).

The reference surfaces failures only as downstream Python asserts
(SURVEY §5 "failure detection: absent"); this gives operators a one-call
structured check before serving a fitted model:

- parameter sanity (finite, inside their SoftClip ranges),
- loss finiteness,
- factorization conditioning (diagonal-ratio estimate of each
  component's Cholesky factor — the quantity that decides whether the
  f32/'mixed' paths are trustworthy, cond ~ (dmax/dmin)^2),
- a predict smoke test (finite mean, positive variance, confvar bound).
"""
from __future__ import annotations

import numpy as np


def _host(a) -> np.ndarray:
    """A tensor (on any device) or array as a NumPy array."""
    if hasattr(a, 'detach'):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def health_check(model, n_probe: int = 8) -> dict:
    """Structured health report for a (fitted) LCGP model.

    Returns a dict with an overall ``ok`` flag and per-check details;
    raises nothing — failures are reported, not thrown.
    """
    report: dict = {"ok": True, "checks": {}}

    def record(name, ok, **info):
        report["checks"][name] = dict(ok=bool(ok), **info)
        if not ok:
            report["ok"] = False

    # parameters
    try:
        lLmb, lLmb0, lsig, lnug = (_host(a) for a in model.get_param())
        finite = all(np.isfinite(a).all() for a in (lLmb, lLmb0, lsig, lnug))
        record("params_finite", finite,
               amp_max=float(lLmb0.max()), amp_min=float(lLmb0.min()),
               lengthscale_min=float(lLmb.min()),
               lengthscale_max=float(lLmb.max()))
    except Exception as e:  # noqa: BLE001
        record("params_finite", False, error=repr(e))
        return report

    # loss
    try:
        loss = float(model.loss())
        record("loss_finite", np.isfinite(loss), loss=loss)
    except Exception as e:  # noqa: BLE001
        record("loss_finite", False, error=repr(e))

    # factor conditioning: diag-ratio of the stored Cholesky factor;
    # cond(target) ~= (dmax/dmin)^2.  FITC models skip (no dense factor).
    try:
        L = model.LBs if model.submethod == 'full' else model.LTs
        if L is not None:
            d = np.abs(np.diagonal(_host(L), axis1=-2, axis2=-1))
            ratio = (d.max(axis=-1) / d.min(axis=-1)) ** 2
            # f32-refinable while cond * eps32 stays < 1
            record("factor_conditioning", bool(np.isfinite(ratio).all()),
                   cond_estimate_max=float(ratio.max()),
                   mixed_precision_safe=bool(ratio.max() < 1e6),
                   refine_steps_recommended=int(
                       model.recommended_refine_steps()))
        else:
            record("factor_conditioning", True, skipped="fitc-or-unavailable")
    except Exception as e:  # noqa: BLE001
        record("factor_conditioning", False, error=repr(e))

    # predict smoke: a few points spanning the training range
    try:
        x = _host(model.x_orig)
        idx = np.linspace(0, x.shape[0] - 1, min(n_probe, x.shape[0]))
        probe = x[idx.astype(int)]
        yp, ypv, ycv = (_host(o) for o in model.predict(probe))
        ok = (np.isfinite(yp).all() and (ypv > 0).all()
              and (ycv <= ypv + 1e-12).all())
        record("predict_smoke", ok,
               mean_abs=float(np.abs(yp).mean()),
               var_min=float(ypv.min()))
    except Exception as e:  # noqa: BLE001
        record("predict_smoke", False, error=repr(e))

    # FITC negative-variance clamping: a symptom of a bad inducing set.
    # Surfaced, not hidden (round-2 review): check fails when a
    # non-negligible fraction of the last predict's variances were clamped.
    stats = getattr(model, '_fitc_clamp_stats', None)
    if stats is not None:
        record("fitc_variance_clamp",
               stats['frac'] <= 0.01 and stats['worst'] > -1e-6,
               **stats,
               hint=("refine_inducing() or a larger `inducing=` m "
                     "usually removes the clamping"))

    return report
