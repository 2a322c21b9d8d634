"""The port's replication path (``submethod='rep'``) against lcgp_tpu and
the NumPy oracle.

Same raw (y, x), made from a seed with NumPy, and the same free parameters
(carried over with ``lcgp_tpu_torch.convert``) through both packages, on
the CPU in float64.  Stated tolerances:

- ``group_replicates``: exactly equal;
- ``neglpost_rep`` rtol 1e-10; its gradient within 1e-10 of each leaf's
  max |g| (the loss is divided by n, so the two packages agree to
  rounding, not bit for bit);
- the aux (``CinvM``, ``LT``, ``mks``, ``psi_c``), ``predict_rep_core``,
  ``recombine_rep`` and the model's predictions rtol 1e-9, atol 1e-12, at
  moderate parameters;
- at BASELINE config 5's committed fit the loss rtol 1e-10, and the
  predictions, the factor, mks and the dual weights within 1e-9 of each
  one's largest entry: cond(C + Lam) reaches 2.5e7 there, and the two
  packages' LAPACK factors of one matrix differ by 2.2e-12, which shows as
  ~1e-8 relative in entries of the mean near zero;
- ``fit(method='scipy', maxiter=5)``: the final loss rtol 1e-8;
- against the NumPy oracle at moderate parameters: the loss rtol 1e-9 and
  the predictions rtol 1e-7, atol 1e-9 (the oracle inverts C explicitly;
  lcgp_tpu's own rep oracle bar, ``tests/test_predict.py:127``).
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import likelihood as JLik
from lcgp_tpu.models import params as JP
from lcgp_tpu.models import predict as JPred
from lcgp_tpu.models import replication as JRep
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.models import likelihood as TLik
from lcgp_tpu_torch.models import params as TP
from lcgp_tpu_torch.models import predict as TPred
from lcgp_tpu_torch.models import replication as TRep
from lcgp_tpu_torch.ops import linalg as TL
from lcgp_tpu_torch.ops import matern as TM
import oracle

torch.set_num_threads(1)  # pytest -n workers share the host's cores

ROOT = Path(__file__).resolve().parents[1]
LOSS_RTOL = 1e-10
GRAD_RTOL = 1e-10
PRED_TOL = dict(rtol=1e-9, atol=1e-12)
ORACLE_PRED_TOL = dict(rtol=1e-7, atol=1e-9)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), np.asarray(ref), **tol)


def _rep_problem(seed, n_unique=100, d=2, p=8, n0=12, max_reps=5):
    """Raw replicated (x, y): n_unique sites with 1..max_reps replicates,
    rows shuffled; and n0 held-out points."""
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n_unique + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + xu[:, :1].T)) * xu[:, 1:2].T
         + np.cos(np.pi * t * xu[:, -1:].T))
    reps = rng.integers(1, max_reps + 1, n_unique)
    x = np.repeat(xu[:n_unique], reps, axis=0)
    y = np.repeat(f[:, :n_unique], reps, axis=1)
    y = y + 0.1 * rng.standard_normal(y.shape)
    order = rng.permutation(x.shape[0])
    return x[order], y[:, order], xu[n_unique:]


def _fitted_like(jm, seed):
    """Move the JAX model off its init to moderate parameters."""
    rng = np.random.default_rng(seed)
    q, d = int(jm.q), int(jm.d)
    jm.set_params(lLmb=rng.uniform(0.2, 1.5, (q, d)),
                  lLmb0=rng.uniform(0.5, 3.0, q),
                  lnugGPs=rng.uniform(1e-6, 1e-3, q),
                  lsigma2s=np.asarray(jm.lsigma2s) - 1.0)


def _free_np(jm):
    return [np.asarray(v) for v in jm._free]


def _port_of(jm, **kw):
    kw.setdefault('q_chunk', jm._q_chunk_arg)
    tm = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                             q=int(jm.q), submethod='rep',
                             rep_standardize_ybar=jm.rep_standardize_ybar,
                             diag_error_structure=jm.diag_error_structure,
                             device='cpu', **kw)
    tm.free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    return tm


def _data_of(jm):
    return convert.rep_data_from_numpy(*jm._data, 'cpu')


_CASES = {'std': dict(), 'raw': dict(rep_standardize_ybar=False),
          'grouped': dict(diag_error_structure=[3, 5])}


@pytest.fixture(scope='module')
def models():
    """{case: (jax model, port model)} on one replicated data set (100
    unique sites, replicates 1-5, d=2, p=8, q=3), moved off the init;
    cases: standardized ybar, raw ybar, a grouped error structure."""
    x, y, _ = _rep_problem(0)
    out = {}
    for i, (case, kw) in enumerate(_CASES.items()):
        jm = lcgp_tpu.LCGP(y, x, q=3, submethod='rep', **kw)
        _fitted_like(jm, 1 + i)
        out[case] = (jm, _port_of(jm))
    return out


@pytest.fixture(scope='module')
def x0():
    return _rep_problem(0)[2]


# ---------------------------------------------------------------------------
# grouping
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('replicated', [True, False])
def test_group_replicates_equals_jax(replicated):
    x, y, _ = _rep_problem(3, max_reps=5 if replicated else 1)
    got, ref = TRep.group_replicates(x, y), JRep.group_replicates(x, y)
    for name in ref._fields:
        a, b = getattr(got, name), getattr(ref, name)
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b, err_msg=name)
    assert got.r.dtype == np.int32 and got.group_ids.dtype == np.int32
    if not replicated:
        # no replication: every row is its own group, in sorted order
        order = np.lexsort(x.T[::-1])
        np.testing.assert_array_equal(got.x_unique, x[order])
        np.testing.assert_array_equal(got.ybar, y[:, order])
        assert (got.r == 1).all()


# ---------------------------------------------------------------------------
# functions of (free, data), fed the JAX model's own data
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case,q_chunk', [('std', None), ('std', 3),
                                          ('raw', None), ('grouped', None),
                                          ('grouped', 3)])
def test_neglpost_rep_matches_jax(models, case, q_chunk):
    jm, _ = models[case]
    free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    got = TLik.neglpost_rep(free, _data_of(jm), q_chunk=q_chunk)
    ref = JLik.neglpost_rep(jm._free, jm._data, q_chunk=q_chunk)
    assert got.dtype == torch.float64
    _close(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize('case,q_chunk', [('std', None), ('raw', 3),
                                          ('grouped', None)])
def test_neglpost_rep_grad_matches_jax(models, case, q_chunk):
    jm, _ = models[case]
    free = TP.FreeParams(*(torch.as_tensor(np.array(v)).requires_grad_(True)
                           for v in _free_np(jm)))
    v = TLik.neglpost_rep(free, _data_of(jm), q_chunk=q_chunk)
    g = torch.autograd.grad(v, free)
    vj, gj = jax.value_and_grad(JLik.neglpost_rep)(
        JP.FreeParams(*(jnp.asarray(a) for a in _free_np(jm))), jm._data,
        q_chunk=q_chunk)
    _close(v, vj, rtol=LOSS_RTOL)
    for name, a, b in zip(JP.FreeParams._fields, g, gj):
        err = np.max(np.abs(_np(a) - np.asarray(b)))
        assert err <= GRAD_RTOL * np.max(np.abs(np.asarray(b))), (name, err)


def test_rep_terms_gradcheck():
    """torch.autograd.gradcheck of the autograd.Function at n=20, q=2,
    d=2: its analytic backward against finite differences of its forward,
    in every differentiable input."""
    rng = np.random.default_rng(11)

    def t(a, grad=False):
        return torch.as_tensor(np.asarray(a, dtype=np.float64)) \
            .requires_grad_(grad)
    xs, D = t(rng.uniform(0, 1, (20, 2))), t(rng.uniform(0.5, 3.0, 2))
    sr = torch.sqrt(t(rng.integers(1, 6, 20)))
    args = (t(rng.uniform(0.3, 1.0, (2, 2)), True),
            t(rng.uniform(0.5, 2.0, 2), True),
            t(rng.uniform(1e-4, 1e-2, 2), True),
            t(rng.standard_normal((2, 20)), True))

    def terms(ls, amp, nug, b):
        return TLik._RepTerms.apply(None, 0.0, 'matern32', xs, sr, ls, amp,
                                    nug, D, b)
    assert torch.autograd.gradcheck(terms, args, eps=1e-6, atol=1e-8,
                                    rtol=1e-6)


def test_rep_loss_without_grad_does_no_gradient_work(models, monkeypatch):
    calls = {'inv': 0, 'vjp': 0}
    real_inv, real_vjp = TL.chol_inverse, TLik.gram_vjp_fused

    def inv(*a, **k):
        calls['inv'] += 1
        return real_inv(*a, **k)

    def vjp(*a, **k):
        calls['vjp'] += 1
        return real_vjp(*a, **k)
    monkeypatch.setattr(TLik.linalg, 'chol_inverse', inv)
    monkeypatch.setattr(TLik, 'gram_vjp_fused', vjp)
    _, tm = models['std']
    tm.loss()
    free = TP.FreeParams(*(v.clone().requires_grad_(True) for v in tm.free))
    only_sigma = free._replace(lLmb=free.lLmb.detach(),
                               lLmb0=free.lLmb0.detach(),
                               lnugGPs=free.lnugGPs.detach())
    (gs,) = torch.autograd.grad(TLik.neglpost_rep(only_sigma, tm._data),
                                only_sigma.lsigma2s)
    assert calls == {'inv': 0, 'vjp': 0}
    g = torch.autograd.grad(TLik.neglpost_rep(free, tm._data), free)
    assert calls == {'inv': 1, 'vjp': 1}
    torch.testing.assert_close(gs, g[2], rtol=1e-14, atol=0)


@pytest.mark.parametrize('case,q_chunk', [('std', None), ('raw', 3),
                                          ('grouped', None)])
def test_aux_predict_core_recombine_match_jax(models, x0, case, q_chunk):
    jm, _ = models[case]
    free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    data = _data_of(jm)
    aux = TPred.compute_aux_rep(free, data, q_chunk=q_chunk)
    aux_j = JPred.compute_aux_rep(jm._free, jm._data, q_chunk=q_chunk)
    for name in JPred.RepAux._fields:
        _close(getattr(aux, name), getattr(aux_j, name), **PRED_TOL)
    x0s = (x0 - np.asarray(jm.x_min)) / (np.asarray(jm.x_max)
                                         - np.asarray(jm.x_min))
    ghat, gvar = TPred.predict_rep_core(free, data, aux, torch.as_tensor(x0s),
                                        q_chunk=q_chunk)
    ghat_j, gvar_j = JPred.predict_rep_core(jm._free, jm._data, aux_j,
                                            jnp.asarray(x0s),
                                            q_chunk=q_chunk)
    _close(ghat, ghat_j, **PRED_TOL)
    _close(gvar, gvar_j, **PRED_TOL)
    mean, std = np.array(jm.ybar_mean), np.array(jm.ybar_std)
    got = TPred.recombine_rep(free, data, ghat, gvar, torch.as_tensor(mean),
                              torch.as_tensor(std))
    ref = JPred.recombine_rep(jm._free, jm._data, ghat_j, gvar_j,
                              jnp.asarray(mean), jnp.asarray(std))
    for a, b in zip(got, ref):
        _close(a, b, **PRED_TOL)


def test_mks_where_lambda_dominates_matches_jax():
    """No replication (r = 1) and amplitudes near the 1e-4 floor: the
    diagonal 1/(D r) dominates C.  The identity C u = Lam b - (lam + jit) u
    cancels there; the aux forms mks = C @ CinvM, as lcgp_tpu does."""
    x, y, _ = _rep_problem(4, n_unique=60, max_reps=1)
    jm = lcgp_tpu.LCGP(y, x, q=3, submethod='rep')
    jm.set_params(lLmb0=np.array([2e-4, 1e-3, 5e-4]))
    tm = _port_of(jm)
    aux, aux_j = tm._ensure_aux(), jm._ensure_aux()
    lam = 1.0 / np.asarray(jm.diag_D)
    assert lam.min() > 100 * float(np.max(np.asarray(jm.lLmb0)))
    for name in ('CinvM', 'LT', 'mks'):
        _close(getattr(aux, name), getattr(aux_j, name), **PRED_TOL)
    _close(tm.mks, jm.mks, **PRED_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: both LCGPs built from the same raw (y, x)
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', list(_CASES))
def test_construction_matches_jax(models, case):
    jm, tm = models[case]
    assert (tm.n, tm.d, tm.p, tm.q) == (jm.n, jm.d, jm.p, jm.q)
    assert tm.n == 100 and tm.x_orig.shape[0] > tm.n
    for name in ('x', 'y', 'x_min', 'x_max', 'x_unique', 'x_unique_s', 'ybar',
                 'ybar_s', 'ybar_mean', 'ybar_std'):
        _close(getattr(tm, name), getattr(jm, name), rtol=1e-15, atol=1e-15)
    for name in ('r', 'group_ids'):
        a, b = getattr(tm, name), np.asarray(getattr(jm, name))
        assert a.dtype == torch.int32
        np.testing.assert_array_equal(a.numpy(), b)
    _close(tm.R, jm.R, rtol=0, atol=0)
    for name in ('phi', 'diag_D', 'g'):
        _close(getattr(tm, name), getattr(jm, name), rtol=1e-12, atol=1e-13)
    for a, b in zip(tm._data, jm._data):
        _close(a, b, rtol=1e-15, atol=1e-15)
    # the data-driven init reads the raw y and the standardized full x
    init = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                               q=3, submethod='rep',
                               rep_standardize_ybar=jm.rep_standardize_ybar,
                               diag_error_structure=jm.diag_error_structure,
                               device='cpu')
    fresh = lcgp_tpu.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig), q=3,
                          submethod='rep',
                          rep_standardize_ybar=jm.rep_standardize_ybar,
                          diag_error_structure=jm.diag_error_structure)
    for a, b in zip(init.free, fresh._free):
        _close(a, b, rtol=1e-13, atol=1e-15)


def test_preprocess_and_tx_y_match_jax(models):
    jm, tm = models['std']
    got, ref = tm.preprocess(), jm.preprocess()
    assert len(got) == len(ref) == 12
    for a, b in zip(got, ref):
        if isinstance(b, int):
            assert a == b
        else:
            _close(a, b, rtol=1e-15, atol=1e-15)
    ys = np.random.default_rng(5).standard_normal((8, 4))
    _close(tm.tx_y(torch.as_tensor(ys)), jm.tx_y(jnp.asarray(ys)), rtol=1e-15)
    _, raw = models['raw']
    assert torch.equal(raw.tx_y(torch.as_tensor(ys)), torch.as_tensor(ys))


@pytest.mark.parametrize('case', list(_CASES))
def test_loss_and_predict_match_jax(models, x0, case):
    jm, tm = models[case]
    _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)
    got = tm.predict(x0, return_fullcov=True)
    ref = jm.predict(x0, return_fullcov=True)
    assert len(got) == 4 and got[3] is None and ref[3] is None
    for a, b in zip(got[:3], ref[:3]):
        assert a.dtype == torch.float64
        _close(a, b, **PRED_TOL)
    for a, b in zip(tm.predict(x0, batch_size=5), ref[:3]):
        _close(a, b, **PRED_TOL)


def test_aux_accessors_match_jax(models):
    jm, tm = models['grouped']
    for name in ('CinvMs', 'LTs', 'Tks', 'mks', 'psi_c'):
        _close(getattr(tm, name), getattr(jm, name), **PRED_TOL)
    assert tm.LBs is None and tm.Ths is None
    assert jm.LBs is None and jm.Ths is None


def test_fit_scipy_matches_jax():
    x, y, _ = _rep_problem(6, n_unique=60)
    jm = lcgp_tpu.LCGP(y, x, q=2, submethod='rep')
    tm = _port_of(jm)
    jm.fit(method='scipy', maxiter=5)
    tm.fit(method='scipy', maxiter=5)
    rj, rt = jm._fit_result, tm._fit_result
    assert rt.nit == rj.nit == 5
    np.testing.assert_allclose(rt.fun, rj.fun, rtol=1e-8)
    np.testing.assert_allclose(float(tm.loss()), float(jm.loss()), rtol=1e-8)


def test_fit_auto_rule_counts_unique_sites(monkeypatch):
    """'auto' reads n as the number of unique sites: 600 raw rows at 120
    sites stay below the n >= 512 plateau rule."""
    from lcgp_tpu.fit import scipy_lbfgs as JFit
    x, y, _ = _rep_problem(7, n_unique=120, max_reps=5)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, submethod='rep', device='cpu')
    assert tm.n == 120 and x.shape[0] > 300
    seen = {}

    def fake(loss_fn, params0, verbose=False, **kw):
        seen.update(kw)
        return JFit.FitResult(params0, 1.0, 1, 1, True, 'ok', 'gtol')
    monkeypatch.setattr(lcgp_tpu_torch.models.lcgp, 'minimize_lbfgs', fake)
    tm.fit()
    assert seen == {}


def test_fit_adam_lowers_the_rep_loss(models):
    jm, _ = models['std']
    tm = _port_of(jm)
    before = float(tm.loss())
    tm.fit(method='adam', steps=6, block_steps=3)
    assert tm._fit_result.stop_reason == 'steps'
    assert float(tm.loss()) < before


def test_rep_models_save_and_load_across_packages(models, x0, tmp_path):
    jm, tm = models['grouped']
    jpath, tpath = tmp_path / 'jax_rep.npz', tmp_path / 'port_rep.npz'
    jm.save(jpath)
    tm.save(tpath)
    from_jax = lcgp_tpu_torch.LCGP.load(jpath, device='cpu')
    from_port = lcgp_tpu.LCGP.load(tpath)
    assert from_jax.submethod == 'rep' and from_port.submethod == 'rep'
    for a, b in zip(from_jax.free, jm._free):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(from_port._free, tm.free):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    ref = jm.predict(x0)
    for got in (from_jax.predict(x0), from_port.predict(x0)):
        for a, b in zip(got, ref):
            _close(a, b, **PRED_TOL)


def test_cpu_rep_model_never_launches_a_kernel(models, x0):
    _, tm = models['std']
    before = TM.matern32_gram.launches, TM.matern32_gram_vjp.launches
    tm.loss()
    tm.compute_aux_predictive_quantities()
    tm.predict(x0, batch_size=4)
    free = TP.FreeParams(*(v.clone().requires_grad_(True) for v in tm.free))
    torch.autograd.grad(TLik.neglpost_rep(free, tm._data), free)
    assert (TM.matern32_gram.launches, TM.matern32_gram_vjp.launches) == before


# ---------------------------------------------------------------------------
# the NumPy oracle, and BASELINE config 5
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('case', list(_CASES))
def test_matches_oracle(models, x0, case):
    jm, tm = models[case]
    params = [_np(v) for v in TP.constrain(tm.free)]
    data = [_np(v) for v in tm._data[:6]] + [tm.diag_error_structure]
    _close(tm.loss(), oracle.neglpost_rep_np(*params, *data), rtol=1e-9)
    ref = oracle.predict_rep_np(*params, *data, _np(tm.ybar_mean),
                                _np(tm.ybar_std), tm.rep_standardize_ybar,
                                _np(tm._standardize_x0(x0)))
    for a, b in zip(tm.predict(x0), ref):
        _close(a, b, **ORACLE_PRED_TOL)


def _config5():
    """BASELINE config 5 (benchmarks/run_configs.py:config5)."""
    rng = np.random.default_rng(7)
    n_unique, reps = 1000, 10
    xu = rng.uniform(0, 1, (n_unique, 4))
    f = np.vstack([np.sin(2 * np.pi * xu[:, 0]) * xu[:, 1],
                   np.cos(np.pi * xu[:, 2]) + xu[:, 3] ** 2,
                   xu[:, 0] * xu[:, 2]])
    noise = np.array([0.05, 0.1, 0.2])
    x = np.repeat(xu, reps, axis=0)
    y = (np.repeat(f, reps, axis=1)
         + rng.standard_normal((3, n_unique * reps)) * noise[:, None])
    xte = rng.uniform(0, 1, (400, 4))
    return x, y, xte


def test_config5_fitted_matches_jax():
    """At config 5's committed fit (amplitudes ~3e3) the yardstick is
    lcgp_tpu, not the oracle (whose cancellation loses ~1e-2 there)."""
    x, y, xte = _config5()
    jm = lcgp_tpu.LCGP(y, x, submethod='rep', diag_error_structure=[1, 1, 1])
    with np.load(ROOT / 'benchmarks' / 'fitted_params_rep_heavy_10k.npz') as z:
        free_np = [z[k] for k in ('lLmb', 'lLmb0', 'lsigma2s', 'lnugGPs')]
    jm._free = JP.FreeParams(*(jnp.asarray(v) for v in free_np))
    jm._params_version += 1
    tm = _port_of(jm)
    assert (tm.n, tm.q) == (1000, 3)
    _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)
    _close(tm.loss(), -4.393535528164473, rtol=1e-9)

    def normwise(got, ref):
        err = np.max(np.abs(_np(got) - np.asarray(ref)))
        assert err <= 1e-9 * np.max(np.abs(np.asarray(ref))), err
    for a, b in zip(tm.predict(xte), jm.predict(xte)):
        normwise(a, b)
    for name in ('CinvM', 'LT', 'mks', 'psi_c'):
        normwise(getattr(tm._ensure_aux(), name),
                 getattr(jm._ensure_aux(), name))


def test_port_imports_no_jax():
    """Importing lcgp_tpu_torch and every module in it, the rep path's and
    the precision modes' included, loads neither JAX, nor optax, nor
    lcgp_tpu."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import lcgp_tpu_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    lcgp_tpu_torch.__path__, 'lcgp_tpu_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "for need in ('models.replication', 'ops.mixed', 'fit.lbfgs'):\n"
        "    assert 'lcgp_tpu_torch.' + need in names, names\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in\n"
        "             ('jax', 'jaxlib', 'optax', 'lcgp_tpu'))\n"
        "print(len(names), bad)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    out = subprocess.run([sys.executable, '-c', code], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split(maxsplit=1)[1].strip() == '[]', out.stdout
