"""The port's optimizers and ``LCGP.fit`` against lcgp_tpu's.

Same (y, x) and the same starting free parameters through both packages, on
the CPU in float64.  Stated tolerances:

- ``fit(method='scipy', maxiter=5)``: the same ``nit`` and the final loss to
  rtol 1e-8 (five iterations on gradients that agree to ~1e-12);
- ``fit(method='auto')`` to convergence: the same ``stop_reason`` and the
  final loss to rtol 1e-6 (two L-BFGS runs whose paths part by rounding);
- ``fit(method='adam', steps=20)``: the parameters and the loss to rtol 1e-9
  (Adam's steps are written out as optax orders them).
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.fit import optax_fit as JOpt
from lcgp_tpu.fit import scipy_lbfgs as JFit
from lcgp_tpu.models import params as JP
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.fit import (PlateauTracker, minimize_adam,
                                minimize_lbfgs)
from lcgp_tpu_torch.fit._flat import Flattener
from lcgp_tpu_torch.models import params as TP

torch.set_num_threads(1)  # pytest -n workers share the host's cores

SCIPY_RTOL = 1e-8
AUTO_RTOL = 1e-6
ADAM_RTOL = 1e-9


def _problem(seed, n=120, d=2, p=10):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, -1:].T)
         + 0.05 * rng.standard_normal((p, n)))
    return x, y


def _pair(seed=0, **kw):
    """(JAX model, port model) on the same data, the port started from the
    JAX model's free parameters."""
    x, y = _problem(seed, **kw)
    jm = lcgp_tpu.LCGP(y, x, q=2)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu')
    tm.free = convert.free_params_from_numpy(
        *(np.asarray(v) for v in jm._free), 'cpu')
    return jm, tm


def _free_close(tm, jm, rtol):
    for name, a, b in zip(JP.FreeParams._fields, tm.free, jm._free):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=rtol,
                                   atol=0, err_msg=name)


def _rosen_torch(p):
    x = p.x
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


class _Vec(tuple):
    """A one-leaf parameter set, as a NamedTuple would be."""
    _fields = ('x',)

    def __new__(cls, x):
        return super().__new__(cls, (x,))

    @property
    def x(self):
        return self[0]


# ---------------------------------------------------------------------------
# the optimizers alone
# ---------------------------------------------------------------------------


def test_flat_order_matches_ravel_pytree():
    from jax.flatten_util import ravel_pytree
    rng = np.random.default_rng(0)
    leaves = (rng.standard_normal((3, 2)), rng.standard_normal(3),
              rng.standard_normal(4), rng.standard_normal(3))
    flat_j, _ = ravel_pytree(JP.FreeParams(*map(jnp.asarray, leaves)))
    fl = Flattener(convert.free_params_from_numpy(*leaves, 'cpu'))
    flat_t = fl.ravel(convert.free_params_from_numpy(*leaves, 'cpu'))
    np.testing.assert_array_equal(flat_t.numpy(), np.asarray(flat_j))
    back = fl.unravel_host(np.asarray(flat_j))
    assert isinstance(back, TP.FreeParams)
    for a, b in zip(back, leaves):
        np.testing.assert_array_equal(a.numpy(), b)


def test_plateau_stop_scipy():
    res = minimize_lbfgs(_rosen_torch, _Vec(torch.zeros(6, dtype=torch.float64)),
                         plateau_patience=3, plateau_rtol=1e-2)
    assert res.stop_reason in ('plateau', 'gtol')
    assert res.nit < 100          # the loose plateau bites early


def test_plateau_stop_matches_jax():
    def rosen_j(p):
        x = p['x']
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    ref = JFit.minimize_lbfgs(rosen_j, {'x': jnp.zeros(6)},
                              plateau_patience=3, plateau_rtol=1e-2)
    res = minimize_lbfgs(_rosen_torch, _Vec(torch.zeros(6, dtype=torch.float64)),
                         plateau_patience=3, plateau_rtol=1e-2)
    assert (res.stop_reason, res.nit, res.nfev) == (ref.stop_reason, ref.nit,
                                                    ref.nfev)
    # near the optimum the value is ~4e-5 of the initial 5: compare
    # against the initial loss, not the final one
    np.testing.assert_allclose(res.fun, ref.fun, rtol=0, atol=1e-10 * 5.0)


def test_cap_stop_reported():
    res = minimize_lbfgs(_rosen_torch, _Vec(torch.zeros(6, dtype=torch.float64)),
                         maxiter=3)
    assert res.stop_reason == 'cap'
    assert res.nit == 3


def test_callback_gets_iteration_loss_and_params():
    seen = []
    minimize_lbfgs(_rosen_torch, _Vec(torch.zeros(4, dtype=torch.float64)),
                   maxiter=4, callback=lambda it, v, p: seen.append((it, v, p)))
    assert [s[0] for s in seen] == [1, 2, 3, 4]
    assert all(np.isfinite(s[1]) for s in seen)
    assert all(isinstance(s[2], _Vec) and s[2].x.shape == (4,) for s in seen)
    # the loss handed over is the one at the iterate handed over
    for _, v, p in seen:
        np.testing.assert_allclose(v, float(_rosen_torch(p)), rtol=1e-12)


def test_nonfinite_loss_maps_to_inf_and_recovers():
    """A NaN loss (a failed factor) reads as +inf with its NaN gradient
    entries zeroed, so the line search backtracks instead of stalling."""
    def loss(p):
        x = p.x
        v = torch.sum((x - 3.0) ** 2)
        return torch.where(x[0] > 4.0, torch.full_like(v, float('nan')), v)
    res = minimize_lbfgs(loss, _Vec(torch.zeros(2, dtype=torch.float64)))
    assert res.stop_reason == 'gtol'
    np.testing.assert_allclose(res.params.x.numpy(), [3.0, 3.0], atol=1e-5)


def test_stop_iteration_fallback(monkeypatch):
    """scipy < 1.11 lets a callback's StopIteration escape: the result is
    then the last iterate the callback saw."""
    import scipy.optimize

    def old_scipy(fun, x0, jac, method, callback, options):
        x = np.asarray(x0, dtype=np.float64)
        for _ in range(5):
            fun(x)
            callback(x)             # raises StopIteration on the plateau
            x = x + 0.01
        raise AssertionError('the plateau stop never fired')
    monkeypatch.setattr(scipy.optimize, 'minimize', old_scipy)
    res = minimize_lbfgs(_rosen_torch, _Vec(torch.zeros(6, dtype=torch.float64)),
                         plateau_patience=1, plateau_rtol=1e3)
    assert res.stop_reason == 'plateau'
    assert res.success and 'pre-1.11' in res.message
    assert (res.nit, res.nfev) == (2, 2)
    np.testing.assert_array_equal(res.params.x.numpy(), np.full(6, 0.01))
    np.testing.assert_allclose(res.fun, float(_rosen_torch(res.params)),
                               rtol=1e-15)


@pytest.mark.parametrize('patience', [1, 3])
def test_plateau_tracker_matches_jax(patience):
    seq = [100.0, 50.0, 51.0, 50.5, 45.0, 45.2, 45.1, 45.05, float('nan'),
           45.04, 45.0449, float('inf'), 44.0]
    t, j = PlateauTracker(1e-3, patience), JOpt.PlateauTracker(1e-3, patience)
    assert [t.update(v) for v in seq] == [j.update(v) for v in seq]
    assert not any(PlateauTracker(None).update(v) for v in seq)


def test_adam_matches_optax_on_rosenbrock():
    def rosen_j(p):
        x = p['x']
        return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)
    ref = JOpt.minimize_adam(rosen_j, {'x': jnp.zeros(5)}, steps=30,
                             learning_rate=1e-2, block_steps=7)
    seen = []
    res = minimize_adam(_rosen_torch, _Vec(torch.zeros(5, dtype=torch.float64)),
                        steps=30, learning_rate=1e-2, block_steps=7,
                        callback=lambda s, v, p: seen.append(s))
    assert seen == [7, 14, 21, 28, 30]
    assert (res.nit, res.stop_reason) == (30, 'steps')
    np.testing.assert_allclose(res.params.x.numpy(), np.asarray(ref.params['x']),
                               rtol=1e-12, atol=1e-15)
    np.testing.assert_allclose(res.fun, float(ref.fun), rtol=1e-12)


# ---------------------------------------------------------------------------
# LCGP.fit against lcgp_tpu's
# ---------------------------------------------------------------------------


def test_fit_scipy_maxiter_matches_jax():
    jm, tm = _pair(0)
    jm.fit(method='scipy', maxiter=5)
    tm.fit(method='scipy', maxiter=5)
    rj, rt = jm._fit_result, tm._fit_result
    assert rt.nit == rj.nit == 5
    assert rt.stop_reason == rj.stop_reason == 'cap'
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=SCIPY_RTOL)
    np.testing.assert_allclose(float(tm.loss()), float(jm.loss()),
                               rtol=SCIPY_RTOL)


def test_fit_auto_to_convergence_matches_jax():
    jm, tm = _pair(1)
    l0 = float(tm.loss())
    jm.fit()
    tm.fit()
    rj, rt = jm._fit_result, tm._fit_result
    assert rt.stop_reason == rj.stop_reason
    assert rt.fun < l0
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=AUTO_RTOL)
    np.testing.assert_allclose(float(tm.loss()), float(jm.loss()),
                               rtol=AUTO_RTOL)


def test_fit_auto_rule_at_large_n(monkeypatch):
    """At n >= 512 'auto' is scipy with the plateau stop and a 2000 cap."""
    _, tm = _pair(2, n=40)
    seen = {}

    def fake(loss_fn, params0, verbose=False, **kw):
        seen.update(kw)
        return JFit.FitResult(params0, 1.0, 1, 1, True, 'ok', 'gtol')
    monkeypatch.setattr(lcgp_tpu_torch.models.lcgp, 'minimize_lbfgs', fake)
    tm.fit()
    assert seen == {}
    monkeypatch.setattr(tm, 'n', 512)
    tm.fit()
    assert seen == dict(plateau_patience=20, plateau_rtol=1e-8, maxiter=2000)


def test_fit_adam_matches_jax():
    jm, tm = _pair(3)
    jm.fit(method='adam', steps=20, block_steps=8)
    tm.fit(method='adam', steps=20, block_steps=8)
    _free_close(tm, jm, ADAM_RTOL)
    np.testing.assert_allclose(tm._fit_result.fun, float(jm._fit_result.fun),
                               rtol=ADAM_RTOL)
    assert tm._fit_result.stop_reason == 'steps'


def test_fit_cap_is_announced(capsys):
    _, tm = _pair(4)
    tm.fit(method='scipy', maxiter=2)
    assert tm._fit_result.stop_reason == 'cap'
    assert 'iteration cap' in capsys.readouterr().out


def test_unknown_fit_method_raises():
    _, tm = _pair(4, n=30)
    with pytest.raises(ValueError):
        tm.fit(method='sgd-magic')


@pytest.mark.parametrize('method,kw', [('scipy', dict(maxiter=4)),
                                       ('adam', dict(steps=12, block_steps=4))])
def test_checkpoint_roundtrip_across_packages(tmp_path, method, kw):
    """A checkpoint written by the port's fit restores into both packages;
    the suffixless path finds the '.npz' np.savez wrote."""
    jm, tm = _pair(5)
    path = str(tmp_path / 'ckpt')
    steps = []
    tm.fit(method=method, checkpoint_path=path,
           callback=lambda s, v, p: steps.append(s), **kw)
    last = 4 if method == 'scipy' else 12
    assert steps[-1] == last
    fresh = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                                q=2, device='cpu')
    step, loss = fresh.restore_checkpoint(path)
    assert step == last and np.isfinite(loss)
    for a, b in zip(fresh.free, tm.free):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    if method == 'scipy':
        # the loss recorded is the loss at the recorded parameters
        np.testing.assert_allclose(loss, float(fresh.loss()), rtol=1e-12)
    jstep, _ = jm.restore_checkpoint(path)
    assert jstep == last
    np.testing.assert_allclose(float(jm.loss()), float(fresh.loss()),
                               rtol=1e-10)


def test_aux_is_rebuilt_after_fit():
    _, tm = _pair(6)
    x0 = np.random.default_rng(6).uniform(0, 1, (7, 2))
    before = tm.predict(x0)[0]
    version = tm._params_version
    tm.fit(method='scipy', maxiter=3)
    assert tm._params_version == version + 1
    after = tm.predict(x0)[0]
    assert not torch.allclose(before, after)
    ref = lcgp_tpu_torch.LCGP(np.asarray(tm.y_orig), np.asarray(tm.x_orig),
                              q=2, device='cpu')
    ref.free = tm.free
    torch.testing.assert_close(after, ref.predict(x0)[0], rtol=1e-12,
                               atol=1e-14)
