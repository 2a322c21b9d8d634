"""``minimize_lbfgs_jax`` (the port of lcgp_tpu's on-device optax L-BFGS)
against optax and against lcgp_tpu's ``fit(method='lbfgs-jax'|'hybrid')``,
on the CPU in float64.  Stated tolerances:

- on Rosenbrock, each of the first 10 iterates against ``optax.lbfgs()``'s
  (zoom and backtracking line searches): atol 1e-13, the rounding of two
  implementations that take the same steps (sums in another order);
- ``fit(method='lbfgs-jax', maxiter=20)`` at precision 'high': the same
  nit and stop reason and the final loss rtol 1e-8 (twenty iterations on
  gradients that agree to ~1e-12); at 'fast' and for 'hybrid' the band
  of ``tests/test_fit.py:52``, |l1 - l2| < 0.05 (1 + min |l|), since f32
  gradients ('fast', and 'mixed' by design) part the two paths.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

import lcgp_tpu
from lcgp_tpu.fit import optax_fit as JOpt
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.fit import DeviceFitResult, minimize_lbfgs_jax
from lcgp_tpu_torch.models import params as TP

torch.set_num_threads(1)  # pytest -n workers share the host's cores

ITERATE_ATOL = 1e-13
LOSS_RTOL = 1e-8


def _band(l1, l2):
    return abs(l1 - l2) < 0.05 * (1 + min(abs(l1), abs(l2)))


class _Vec(tuple):
    """A one-leaf parameter set, as a NamedTuple would be."""
    _fields = ('x',)

    def __new__(cls, x):
        return super().__new__(cls, (x,))

    @property
    def x(self):
        return self[0]


def _rosen_torch(p):
    x = p.x
    return torch.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _rosen_jax(x):
    return jnp.sum(100.0 * (x[1:] - x[:-1] ** 2) ** 2 + (1 - x[:-1]) ** 2)


def _optax_iterates(opt, x0, iters):
    """The iterates of the optax loop as lcgp_tpu drives it."""
    vg = optax.value_and_grad_from_state(_rosen_jax)

    @jax.jit
    def step(x, state):
        value, grad = vg(x, state=state)
        updates, state = opt.update(grad, state, x, value=value, grad=grad,
                                    value_fn=_rosen_jax)
        return optax.apply_updates(x, updates), state

    x, state, out = jnp.asarray(x0), opt.init(jnp.asarray(x0)), []
    for _ in range(iters):
        x, state = step(x, state)
        out.append(np.asarray(x))
    return out


def _problem(seed, n=80, d=2, p=3):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, -1:].T)
         + 0.05 * rng.standard_normal((p, n)))
    return x, y


def _pair(seed=0, **kw):
    x, y = _problem(seed)
    jm = lcgp_tpu.LCGP(y, x, q=2, **kw)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu', **kw)
    tm.free = convert.free_params_from_numpy(
        *(np.asarray(v) for v in jm._free), 'cpu')
    return jm, tm


# ---------------------------------------------------------------------------
# the optimizer alone
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('linesearch', ['zoom', 'backtracking'])
def test_iterates_match_optax_lbfgs_on_rosenbrock(linesearch):
    x0 = np.zeros(5)
    opt = (optax.lbfgs() if linesearch == 'zoom' else optax.lbfgs(
        linesearch=optax.scale_by_backtracking_linesearch(
            max_backtracking_steps=20, store_grad=True)))
    ref = _optax_iterates(opt, x0, 10)
    seen = []
    res = minimize_lbfgs_jax(_rosen_torch,
                             _Vec(torch.zeros(5, dtype=torch.float64)),
                             maxiter=10, block_iters=1, linesearch=linesearch,
                             callback=lambda it, v, p: seen.append(
                                 (it, v, p.x.numpy().copy())))
    assert [s[0] for s in seen] == list(range(1, 11))
    for (it, v, x), r in zip(seen, ref):
        np.testing.assert_allclose(x, r, rtol=0, atol=ITERATE_ATOL,
                                   err_msg=f'iterate {it}')
        np.testing.assert_allclose(v, float(_rosen_jax(jnp.asarray(r))),
                                   rtol=1e-12, atol=1e-14)
    assert (res.nit, res.stop_reason) == (10, 'cap')
    assert isinstance(res, DeviceFitResult)


@pytest.mark.parametrize('linesearch', ['zoom', 'backtracking'])
@pytest.mark.parametrize('kw', [dict(maxiter=3), dict(maxiter=200),
                                dict(plateau_rtol=1e-2, block_iters=3),
                                dict(maxiter=11, block_iters=4)])
def test_stop_rules_and_callbacks_match_jax(linesearch, kw):
    seen_t, seen_j = [], []
    res = minimize_lbfgs_jax(_rosen_torch,
                             _Vec(torch.zeros(4, dtype=torch.float64)),
                             linesearch=linesearch,
                             callback=lambda it, v, p: seen_t.append(it),
                             **kw)
    ref = JOpt.minimize_lbfgs_jax(lambda p: _rosen_jax(p['x']),
                                  {'x': jnp.zeros(4)}, linesearch=linesearch,
                                  callback=lambda it, v, p: seen_j.append(it),
                                  **kw)
    assert (res.stop_reason, res.nit) == (ref.stop_reason, int(ref.nit))
    assert seen_t == seen_j
    np.testing.assert_allclose(res.fun, float(ref.fun), rtol=1e-9,
                               atol=1e-20)


def test_nfev_counts_every_loss_evaluation():
    calls = []

    def loss(p):
        calls.append(1)
        return _rosen_torch(p)
    res = minimize_lbfgs_jax(loss, _Vec(torch.zeros(3, dtype=torch.float64)),
                             maxiter=6)
    assert res.nfev == len(calls) > res.nit == 6


def test_value_and_gradient_at_the_accepted_step_are_reused():
    # a quadratic: the first iteration's unit step is accepted at once, so
    # two iterations cost 1 + 1 + 1 evaluations, none repeated
    def quad(p):
        return torch.sum((p.x - 3.0) ** 2)
    res = minimize_lbfgs_jax(quad, _Vec(torch.zeros(2, dtype=torch.float64)),
                             maxiter=50)
    assert res.stop_reason == 'gtol'
    np.testing.assert_allclose(res.params.x.numpy(), [3.0, 3.0], atol=1e-9)
    assert res.nfev <= 2 * res.nit + 1


def test_unknown_linesearch_raises():
    with pytest.raises(ValueError, match='linesearch'):
        minimize_lbfgs_jax(_rosen_torch,
                           _Vec(torch.zeros(2, dtype=torch.float64)),
                           linesearch='wolfe')


# ---------------------------------------------------------------------------
# LCGP.fit
# ---------------------------------------------------------------------------


def test_fit_lbfgs_jax_matches_jax_at_high():
    jm, tm = _pair(0)
    jm.fit(method='lbfgs-jax', maxiter=20)
    tm.fit(method='lbfgs-jax', maxiter=20)
    rj, rt = jm._fit_result, tm._fit_result
    assert (rt.nit, rt.stop_reason) == (int(rj.nit), rj.stop_reason)
    np.testing.assert_allclose(rt.fun, float(rj.fun), rtol=LOSS_RTOL)
    np.testing.assert_allclose(float(tm.loss()), float(jm.loss()),
                               rtol=LOSS_RTOL)


def test_fit_lbfgs_jax_at_fast_within_band_of_jax():
    jm, tm = _pair(1, precision='fast')
    l0 = float(tm.loss())
    jm.fit(method='lbfgs-jax', maxiter=20)
    tm.fit(method='lbfgs-jax', maxiter=20)
    l_t, l_j = float(tm.loss()), float(jm.loss())
    assert l_t < l0 and _band(l_t, l_j)
    assert all(t.dtype == torch.float64 for t in tm.free)


def test_fit_auto_resolves_to_lbfgs_jax_under_fast(monkeypatch, capsys):
    jm, tm = _pair(2, precision='fast')
    monkeypatch.setattr(lcgp_tpu_torch.LCGP, '_AUTO_ONDEVICE_N', 50)
    monkeypatch.setattr(lcgp_tpu.LCGP, '_AUTO_ONDEVICE_N', 50)
    l0 = float(tm.loss())
    tm.fit(verbose=True, maxiter=15)
    out = capsys.readouterr().out
    assert "auto-selected method='lbfgs-jax'" in out
    assert "'plateau_rtol': 1e-08" in out
    assert isinstance(tm._fit_result, DeviceFitResult)
    jm.fit(maxiter=15)
    assert float(tm.loss()) < l0
    assert _band(float(tm.loss()), float(jm.loss()))


def test_fit_auto_stays_scipy_under_high_and_mixed(monkeypatch, capsys):
    monkeypatch.setattr(lcgp_tpu_torch.LCGP, '_AUTO_ONDEVICE_N', 50)
    for precision in ('high', 'mixed'):
        _, tm = _pair(3, precision=precision)
        tm.fit(verbose=True, maxiter=2)
        assert "auto-selected method='scipy'" in capsys.readouterr().out


def test_hybrid_decreases_the_loss_within_band_of_jax():
    jm, tm = _pair(4)
    l0 = float(tm.loss())
    jm.fit(method='hybrid', maxiter=20, polish_maxiter=10)
    tm.fit(method='hybrid', maxiter=20, polish_maxiter=10)
    l_t, l_j = float(tm.loss()), float(jm.loss())
    assert l_t < l0 and _band(l_t, l_j)
    assert tm._fit_result.nit == int(jm._fit_result.nit) == 10


def test_hybrid_runs_its_first_stage_in_f32(monkeypatch):
    _, tm = _pair(5)
    seen = []
    real = tm._loss_fn

    def spy(compute_dtype='model', jitter=None):
        seen.append((compute_dtype, jitter))
        return real(compute_dtype=compute_dtype, jitter=jitter)
    monkeypatch.setattr(tm, '_loss_fn', spy)
    tm.fit(method='hybrid', maxiter=3, polish_maxiter=2)
    assert seen == [(torch.float32, 1e-6), ('model', None)]


def test_lbfgs_jax_checkpoint_restores(tmp_path):
    _, tm = _pair(6)
    steps = []
    tm.fit(method='lbfgs-jax', maxiter=7, block_iters=3,
           checkpoint_path=tmp_path / 'ck',
           callback=lambda it, v, p: steps.append(it))
    assert steps == [3, 6, 7]
    _, fresh = _pair(6)
    step, loss = fresh.restore_checkpoint(tmp_path / 'ck')
    assert step == 7
    np.testing.assert_allclose(loss, tm._fit_result.fun, rtol=1e-15)
    for a, b in zip(fresh.free, tm.free):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_mixed_fit_starts_at_the_recommended_refinement():
    x, y = _problem(7, n=150)
    jm = lcgp_tpu.LCGP(y, x, q=2, precision='mixed')
    jm.set_params(lLmb0=np.full(2, 9e3))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, precision='mixed', device='cpu')
    tm.free = convert.free_params_from_numpy(
        *(np.asarray(v) for v in jm._free), 'cpu')
    rec = tm.recommended_refine_steps()
    assert rec == jm.recommended_refine_steps() > 2
    tm.fit(method='lbfgs-jax', maxiter=2)
    jm.fit(method='lbfgs-jax', maxiter=2)
    assert tm._compute_dtype == jm._compute_dtype
    steps = max(rec, tm.recommended_refine_steps())
    assert tm._compute_dtype == f'mixed:{steps}'
    # f32-grade gradients part the two paths within two iterations
    assert _band(float(tm.loss()), float(jm.loss()))
    _, _, lsig, lnug = TP.constrain(tm.free)
    assert torch.isfinite(lsig).all() and torch.isfinite(lnug).all()
