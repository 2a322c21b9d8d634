"""The port's FITC inducing-point path (``lcgp_tpu_torch/models/sparse.py``,
``inducing=``, ``n_chunk=``, ``refine_inducing``) against lcgp_tpu.

Same raw (y, x), made from a seed with NumPy, the same free parameters and
the same inducing set (carried over with ``lcgp_tpu_torch.convert``) go
through both packages, on the CPU in float64, where the port's Gram and its
VJPs (``GramFn``: the parameters' VJP and K5's plain version for the
points) are the plain PyTorch versions.  Stated tolerances:

- ``select_inducing``: the same rows, exactly;
- ``neglpost_full_fitc``/``neglpost_rep_fitc``, dense and streamed
  (``n_chunk`` 16 and a ragged 7): rtol 1e-9;
- their gradient with respect to the free parameters and z, against
  ``jax.grad``: within 1e-8 of each leaf's max |g|;
- ``compute_aux_fitc`` (alpha, inner, u) rtol 1e-9, atol 1e-12;
  ``predict_fitc_core`` and the model's predictions rtol 1e-7, atol 1e-10;
- streamed against dense, in the port: the loss rtol 1e-12, the gradient
  1e-10 of each leaf's max |g|, the aux rtol 1e-10 (one reduction order
  against another);
- ``GramFn``'s backward against ``torch.autograd`` of the plain Gram:
  within 1e-13 of each gradient's max |g|;
- model level: ``fit(method='adam', steps=10)`` and
  ``refine_inducing(steps=5)`` end within 1e-8 of lcgp_tpu's parameters
  and loss (Adam's steps divide by sqrt(v), which turns the ~1e-15
  differences of the gradients into ~1e-9 of the parameters); ``save`` and
  ``load`` both ways exactly; 'mixed' predictions bitwise 'high''s;
  'fast''s loss within rtol 1e-3 of 'high''s.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import sparse as JS
from lcgp_tpu.utils.diagnostics import health_check as j_health_check
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.fit._flat import Flattener
from lcgp_tpu_torch.models import sparse as TS
from lcgp_tpu_torch.ops.gram import gram_stack
from lcgp_tpu_torch.ops.launch import FAMILIES
from lcgp_tpu_torch.utils.diagnostics import health_check

torch.set_num_threads(1)  # pytest -n workers share the host's cores

LOSS_RTOL = 1e-9
GRAD_RTOL = 1e-8
AUX_TOL = dict(rtol=1e-9, atol=1e-12)
PRED_TOL = dict(rtol=1e-7, atol=1e-10)
FIT_RTOL = 1e-8


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _close(got, ref, **tol):
    np.testing.assert_allclose(_np(got), _np(ref), **tol)


def _leafwise(got, ref, rtol):
    """Each leaf within rtol of its largest |entry|."""
    for a, b in zip(got, ref):
        a, b = _np(a), _np(b)
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=rtol * max(np.abs(b).max(), 1e-300))


def _problem(submethod, seed=0, n=60, d=2, p=5, n0=9):
    """Raw (y, x) and n0 held-out points; on the rep path n unique sites
    with 1-3 replicates each."""
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + xu[:, :1].T)) * xu[:, 1:2].T
         + np.cos(np.pi * t * xu[:, -1:].T))
    if submethod == 'rep':
        reps = rng.integers(1, 4, n)
        x = np.repeat(xu[:n], reps, axis=0)
        y = np.repeat(f[:, :n], reps, axis=1)
    else:
        x, y = xu[:n], f[:, :n]
    y = y + 0.1 * rng.standard_normal(y.shape)
    return x, y, xu[n:]


def _moderate(jm, seed):
    """Move the JAX model off its init to parameters a fit could reach."""
    rng = np.random.default_rng(seed)
    q, d = int(jm.q), int(jm.d)
    jm.set_params(lLmb=rng.uniform(0.2, 1.0, (q, d)),
                  lLmb0=rng.uniform(0.5, 3.0, q),
                  lnugGPs=rng.uniform(1e-6, 1e-3, q),
                  lsigma2s=np.asarray(jm.lsigma2s) - 1.0)


def _port_of(jm, **kw):
    """The port's model of jm's data, with jm's parameters and z."""
    kw.setdefault('inducing', np.asarray(jm.tx_x(jm._z)))
    tm = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                             q=int(jm.q), submethod=jm.submethod,
                             kernel=jm.kernel, precision=jm.precision,
                             n_chunk=jm._n_chunk_arg, device='cpu', **kw)
    tm.free = convert.free_params_from_numpy(
        *[np.asarray(v) for v in jm._free], 'cpu')
    tm._z = convert.inducing_from_numpy(np.asarray(jm._z), 'cpu')
    return tm


def _pair(submethod, n_chunk=0, kernel='matern32', seed=0, m=12, **kw):
    x, y, x0 = _problem(submethod, seed)
    jm = lcgp_tpu.LCGP(y, x, q=3, submethod=submethod, inducing=m,
                       n_chunk=n_chunk, kernel=kernel, **kw)
    _moderate(jm, seed + 1)
    return jm, _port_of(jm), x0


@pytest.fixture(scope='module')
def pairs():
    """{submethod: (jax model, port model, held-out x)} at n=60 (unique
    sites on the rep path), d=2, p=5, q=3, m=12, un-chunked."""
    return {sub: _pair(sub) for sub in ('full', 'rep')}


_FITC = {'full': (JS.neglpost_full_fitc, TS.neglpost_full_fitc),
         'rep': (JS.neglpost_rep_fitc, TS.neglpost_rep_fitc)}


def _port_loss_grad(tm, n_chunk, compute_dtype=None):
    """The port's loss and its gradient in the tree {'free', 'z'}."""
    fitc = _FITC[tm.submethod][1]
    tree = {'free': tm._free, 'z': tm._z}
    fl = Flattener(tree)
    flat = fl.ravel(tree).clone().requires_grad_(True)
    t = fl.unravel(flat)
    v = fitc(t['free'], tm._data, t['z'], compute_dtype=compute_dtype,
             kernel=tm.kernel, n_chunk=n_chunk)
    (g,) = torch.autograd.grad(v, flat)
    return v.detach(), fl.unravel(g)


@pytest.mark.parametrize('n,m,d', [(200, 20, 2), (57, 9, 3), (30, 40, 1)])
def test_select_inducing_same_rows(n, m, d):
    x = np.random.default_rng(n).uniform(0, 1, (n, d))
    np.testing.assert_array_equal(TS.select_inducing(x, m),
                                  JS.select_inducing(x, m))


@pytest.mark.parametrize('n_chunk', [0, 16, 7])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_fitc_loss_matches_jax(pairs, submethod, n_chunk):
    jm, tm, _ = pairs[submethod]
    jf, tf = _FITC[submethod]
    ref = jf(jm._free, jm._data, jm._z, n_chunk=n_chunk or None)
    got = tf(tm._free, tm._data, tm._z, n_chunk=n_chunk or None)
    _close(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize('n_chunk', [0, 16, 7])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_fitc_grad_matches_jax(pairs, submethod, n_chunk):
    """The gradient through GramFn against jax.grad, in the free
    parameters and z."""
    jm, tm, _ = pairs[submethod]
    jf = _FITC[submethod][0]
    ref = jax.grad(lambda t: jf(t['free'], jm._data, t['z'],
                                n_chunk=n_chunk or None))(
        {'free': jm._free, 'z': jm._z})
    _, got = _port_loss_grad(tm, n_chunk or None)
    _leafwise(list(got['free']) + [got['z']],
              list(ref['free']) + [ref['z']], GRAD_RTOL)
    assert np.abs(_np(got['z'])).max() > 0


@pytest.mark.parametrize('n_chunk', [0, 16, 7])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_aux_and_predict_core_match_jax(pairs, submethod, n_chunk):
    jm, tm, x0 = pairs[submethod]
    ref = JS.compute_aux_fitc(jm._free, jm._data, jm._z, submethod,
                              n_chunk=n_chunk or None)
    got = TS.compute_aux_fitc(tm._free, tm._data, tm._z, submethod,
                              n_chunk=n_chunk or None)
    for name in ('alpha', 'inner', 'u', 'Lmm'):
        _close(getattr(got, name), getattr(ref, name), **AUX_TOL)
    x0s = (x0 - np.asarray(jm.x_min)) / np.asarray(jm.x_max - jm.x_min)
    gj = JS.predict_fitc_core(jm._free, jm._data, ref, jm._z,
                              jnp.asarray(x0s))
    gt = TS.predict_fitc_core(tm._free, tm._data, got, tm._z,
                              torch.as_tensor(x0s))
    for a, b in zip(gt, gj):
        _close(a, b, **PRED_TOL)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_streamed_equals_dense(pairs, submethod):
    _, tm, _ = pairs[submethod]
    v0, g0 = _port_loss_grad(tm, None)
    for n_chunk in (16, 7):
        v, g = _port_loss_grad(tm, n_chunk)
        _close(v, v0, rtol=1e-12)
        _leafwise(list(g['free']) + [g['z']], list(g0['free']) + [g0['z']],
                  1e-10)
        a0 = TS.compute_aux_fitc(tm._free, tm._data, tm._z, submethod)
        a = TS.compute_aux_fitc(tm._free, tm._data, tm._z, submethod,
                                n_chunk=n_chunk)
        for x, y in zip(a, a0):
            _close(x, y, rtol=1e-10, atol=1e-13)


@pytest.mark.parametrize('same', [False, True])
@pytest.mark.parametrize('kind', ['matern32', 'matern52', 'rbf'])
def test_gramfn_cpu_backward_matches_autograd(kind, same):
    """GramFn's backward (the plain VJP and K5's plain version) against
    torch.autograd through the plain Gram, x1 and x2 included; with
    same=False and x1 the same tensor as x2 (FITC's Kmm) the two point
    gradients add."""
    rng = np.random.default_rng(3)
    fam = FAMILIES[kind]
    x1 = torch.tensor(rng.uniform(0, 1, (11, 3)))
    x2 = torch.tensor(rng.uniform(0, 1, (7, 3)))
    x2[:2] = x1[:2]                          # coincident points: S = 0
    ls = torch.tensor(rng.uniform(0.3, 2.0, (2, 3)))
    amp = torch.tensor(rng.uniform(0.5, 2.0, 2))
    nug = torch.tensor(rng.uniform(1e-3, 0.1, 2))
    for operands in ((x1, x1) if same else (x1, x2), (x2, x2)):
        leaves = [t.clone().requires_grad_(True) for t in
                  (operands[0], ls, amp, nug)]
        xa = leaves[0]
        xb = xa if operands[1] is operands[0] else \
            operands[1].clone().requires_grad_(True)
        if xb is not xa:
            leaves.append(xb)
        M = torch.tensor(rng.standard_normal((2, xa.shape[0], xb.shape[0])))
        args = (xa, xb, *leaves[1:4])
        got = torch.autograd.grad(
            (gram_stack(*args, same=same, kind=kind) * M).sum(), leaves)
        ref = torch.autograd.grad(
            (fam.plain(*args, same=same) * M).sum(), leaves)
        _leafwise(got, ref, 1e-13)


def test_model_inducing_int_and_array():
    x, y, _ = _problem('full', 4)
    jm = lcgp_tpu.LCGP(y, x, q=3, inducing=10)
    tm = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=10, device='cpu')
    np.testing.assert_array_equal(tm._z.numpy(), np.asarray(jm._z))
    assert tm.n_chunk is None and jm.n_chunk is None
    zx = np.stack([np.linspace(0.1, 0.9, 6), np.linspace(0.2, 0.7, 6)], 1)
    ja = lcgp_tpu.LCGP(y, x, q=3, inducing=zx, n_chunk=16)
    ta = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=zx, n_chunk=16,
                             device='cpu')
    _close(ta._z, ja._z, rtol=1e-15)
    assert ta.n_chunk == ja.n_chunk == 16
    ta.free = convert.free_params_from_numpy(
        *[np.asarray(v) for v in ja._free], 'cpu')
    _close(ta.loss(), ja.loss(), rtol=LOSS_RTOL)


def test_inducing_m_ge_n_raises():
    x, y, _ = _problem('full', 5, n=20)
    for submethod in ('full', 'rep'):
        with pytest.raises(ValueError, match='inducing'):
            lcgp_tpu_torch.LCGP(y, x, q=2, inducing=20, submethod=submethod,
                                device='cpu')


@pytest.mark.parametrize('kind', ['matern52', 'rbf'])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_kernel_kinds_fitc_match_jax(kind, submethod):
    jm, tm, x0 = _pair(submethod, kernel=kind, seed=7)
    _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)
    ref = jax.grad(lambda z: _FITC[submethod][0](
        jm._free, jm._data, z, kernel=kind))(jm._z)
    z = tm._z.clone().requires_grad_(True)
    (got,) = torch.autograd.grad(
        _FITC[submethod][1](tm._free, tm._data, z, kernel=kind), z)
    _leafwise([got], [ref], GRAD_RTOL)
    for a, b in zip(tm.predict(x0), jm.predict(x0)):
        _close(a, b, **PRED_TOL)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_model_fit_adam_and_predict_match_jax(submethod):
    jm, tm, x0 = _pair(submethod, seed=11)
    jm.fit(method='adam', steps=10)
    tm.fit(method='adam', steps=10)
    _leafwise(list(tm._free), list(jm._free), FIT_RTOL)
    _close(tm.loss(), jm.loss(), rtol=FIT_RTOL)
    # predictions at shared (free, z), in one shot and in padded batches
    tm.free = convert.free_params_from_numpy(
        *[np.asarray(v) for v in jm._free], 'cpu')
    ref = jm.predict(x0)
    for got in (tm.predict(x0), tm.predict(x0, batch_size=4)):
        for a, b in zip(got, ref):
            _close(a, b, **PRED_TOL)
    _close(tm.CinvMs, jm.CinvMs, **AUX_TOL)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_saveload_both_ways(tmp_path, submethod):
    jm, tm, x0 = _pair(submethod, n_chunk=7, seed=13)
    tm.save(tmp_path / 't.npz')
    jm2 = lcgp_tpu.LCGP.load(tmp_path / 't.npz')
    jm.save(tmp_path / 'j.npz')
    tm2 = lcgp_tpu_torch.LCGP.load(tmp_path / 'j.npz', device='cpu')
    tm3 = lcgp_tpu_torch.LCGP.load(tmp_path / 't.npz', device='cpu')
    assert jm2.n_chunk == tm2.n_chunk == tm3.n_chunk == 7
    for a, b in ((jm2._z, tm._z), (tm2._z, jm._z), (tm3._z, tm._z)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(list(jm2._free) + list(tm2._free) + list(tm3._free),
                    list(tm._free) + list(jm._free) + list(tm._free)):
        np.testing.assert_array_equal(_np(a), _np(b))
    np.testing.assert_array_equal(_np(tm3.loss()), _np(tm.loss()))


def test_clamp_stats_and_health_check():
    """The clamp statistics count the user's points (not batch padding),
    as lcgp_tpu's do, and health_check reports them."""
    x, y, _ = _problem('full', 17, n=80)
    jm = lcgp_tpu.LCGP(y, x, q=3, inducing=6)
    jm.set_params(lLmb=np.full((3, 2), 0.05))   # short: clamping likely
    tm = _port_of(jm)
    for kw in (dict(), dict(batch_size=4)):
        jm.predict(x[:10], **kw)
        tm.predict(x[:10], **kw)
        st, sj = tm._fitc_clamp_stats, jm._fitc_clamp_stats
        assert st['total'] == sj['total'] == 3 * 10
        assert st['n_clamped'] == sj['n_clamped']
        np.testing.assert_allclose(st['worst'], sj['worst'], rtol=1e-7,
                                   atol=1e-12)
    rep, ref = health_check(tm), j_health_check(jm)
    assert rep['checks']['fitc_variance_clamp']['n_clamped'] == \
        ref['checks']['fitc_variance_clamp']['n_clamped']
    assert rep['checks']['factor_conditioning']['skipped'] == \
        'fitc-or-unavailable'
    assert set(rep['checks']) == set(ref['checks'])
    assert rep['ok'] == ref['ok']


def test_refine_inducing_matches_jax():
    jm, tm, _ = _pair('full', seed=19, m=8)
    l0 = float(tm.loss())
    z0 = tm._z.clone()
    lj = jm.refine_inducing(steps=5, learning_rate=5e-3, joint=False)
    lt = tm.refine_inducing(steps=5, learning_rate=5e-3, joint=False)
    assert not torch.equal(tm._z, z0)
    _close(tm._z, jm._z, rtol=0, atol=FIT_RTOL)
    np.testing.assert_allclose(lt, lj, rtol=FIT_RTOL)
    assert float(tm.loss()) <= l0 + 1e-9
    lj = jm.refine_inducing(steps=3, learning_rate=2e-3, joint=True)
    lt = tm.refine_inducing(steps=3, learning_rate=2e-3, joint=True)
    np.testing.assert_allclose(lt, lj, rtol=FIT_RTOL)
    _leafwise(list(tm._free) + [tm._z], list(jm._free) + [jm._z], FIT_RTOL)


def test_refine_requires_inducing():
    x, y, _ = _problem('full', 23, n=20)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu')
    with pytest.raises(ValueError, match='inducing'):
        tm.refine_inducing()


def test_aux_accessors():
    _, tm, _ = _pair('rep', seed=29)
    assert tm.Tks is None and tm.LTs is None and tm.mks is None
    assert tm.psi_c is None and tm.LBs is None and tm.Ths is None
    assert tuple(tm.CinvMs.shape) == (tm.q, tm.n)


def test_mixed_predict_bitwise_high_and_fast_loss():
    x, y, x0 = _problem('full', 31, n=80)
    hi = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=16, device='cpu')
    mx = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=16, precision='mixed',
                             device='cpu')
    fa = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=16, precision='fast',
                             device='cpu')
    for a, b in zip(mx.predict(x0), hi.predict(x0)):
        assert torch.equal(a, b)
    np.testing.assert_allclose(float(fa.loss()), float(hi.loss()),
                               rtol=1e-3)
    yp, ypv, _ = fa.predict(x0)
    assert torch.isfinite(yp).all() and (ypv > 0).all()


def test_auto_n_chunk_and_memory_budget(monkeypatch):
    """_auto_n_chunk gives lcgp_tpu's blocks under the default budget and
    under LCGP_TPU_HBM_BUDGET_BYTES, which both packages read first (the
    q-chunk planner too, as tests/test_model.py pins lcgp_tpu's)."""
    cls, cpu = lcgp_tpu_torch.LCGP, torch.device('cpu')
    cases = [(4, 50_000, 256, 'fast'), (4, 50_000, 256, 'high'),
             (4, 400_000, 512, 'fast'), (4, 2_000_000, 512, 'fast'),
             (4, 2_000_000, 512, 'high'), (2, 40, 8, 'high')]
    monkeypatch.delenv('LCGP_TPU_HBM_BUDGET_BYTES', raising=False)
    assert cls._mem_budget_bytes(cpu) == 10e9
    assert cls._auto_n_chunk(4, 2_000_000, 512, cpu, 'fast') == 32768
    for budget in (None, '20e9', '2e9', '1e3'):
        if budget is not None:
            monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', budget)
            assert cls._mem_budget_bytes(cpu) == float(budget)
        for q, n, m, prec in cases:
            assert cls._auto_n_chunk(q, n, m, cpu, prec) == \
                lcgp_tpu.LCGP._auto_n_chunk(q, n, m, prec)
        assert cls._auto_q_chunk(20, 4096, cpu, 'high') == \
            lcgp_tpu.LCGP._auto_q_chunk(20, 4096, 'high')
    monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '20e9')
    assert cls._auto_q_chunk(20, 4096, cpu, 'high') == 10
    monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '2e9')
    assert cls._auto_q_chunk(20, 4096, cpu, 'high') == 1
    monkeypatch.setenv('LCGP_TPU_HBM_BUDGET_BYTES', '1e3')
    x, y, _ = _problem('full', 37, n=40)
    # the model resolves it, and a block never exceeds n
    assert lcgp_tpu_torch.LCGP(y, x, q=2, inducing=8, device='cpu').n_chunk \
        == 40


def test_shell_members_match_jax():
    """xnorm (lazy), init_standard_x, init_standard_y and init_params."""
    x, y, _ = _problem('full', 41, n=30, d=3)
    jm = lcgp_tpu.LCGP(y, x, q=2)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu')
    assert tm._xnorm_cache is None
    _close(tm.xnorm, jm.xnorm, rtol=1e-14)
    for a, b in zip(tm.init_standard_x(x), jm.init_standard_x(x)):
        _close(a, b, rtol=1e-15)
    for a, b in zip(tm.init_standard_y(torch.as_tensor(y)),
                    jm.init_standard_y(jnp.asarray(y))):
        _close(a, b, rtol=1e-14)
    tm.set_params(lLmb0=np.full(2, 5.0))
    v = tm._params_version
    tm.init_params()
    assert tm._params_version == v + 1
    jm.init_params()
    for a, b in zip(tm._free, jm._free):
        _close(a, b, rtol=1e-14)


# ---------------------------------------------------------------------------
# 'fast' (f32 panel) FITC on config 7's field, against f64 and lcgp_tpu
# ---------------------------------------------------------------------------

_LEAVES = ('lLmb', 'lLmb0', 'lsigma2s', 'lnugGPs')


def _jax_fitc7(x, y, x0, z, precision):
    """lcgp_tpu's un-chunked FITC model at its init on (x, y) with
    inducing points z ((m, d) in x's units): (loss, {leaf: gradient},
    (ypred, ypredvar, yconfvar))."""
    jm = lcgp_tpu.LCGP(y, x, q=4, inducing=z, n_chunk=0,
                       precision=precision)
    fn = lambda f: JS.neglpost_full_fitc(           # noqa: E731
        f, jm._data, jm._z, compute_dtype=jm._compute_dtype,
        kernel=jm.kernel, n_chunk=None)
    v, g = jax.value_and_grad(fn)(jm._free)
    grads = {nm: np.asarray(a, dtype=np.float64) for nm, a in zip(_LEAVES, g)}
    pred = [np.asarray(a, dtype=np.float64) for a in jm.predict(x0)]
    return float(v), grads, pred


def _port_fitc7(x, y, x0, z, precision):
    """The same through lcgp_tpu_torch on the CPU."""
    tm = lcgp_tpu_torch.LCGP(y, x, q=4, inducing=z, n_chunk=0,
                             precision=precision, device='cpu')
    fl = Flattener(tm.free)
    flat = fl.ravel(tm.free).clone().requires_grad_(True)
    v = tm._loss_fn()(fl.unravel(flat))
    (g,) = torch.autograd.grad(v, flat)
    grads = {nm: _np(a).astype(np.float64)
             for nm, a in zip(_LEAVES, fl.unravel(g))}
    pred = [_np(a).astype(np.float64) for a in tm.predict(x0)]
    return float(v.detach()), grads, pred


def _errors(got, ref):
    """(loss relative, {leaf: of its max |g|}, ypred, ypredvar and
    yconfvar of the largest entry) of one (loss, grads, pred) against
    another."""
    (v, g, p), (vr, gr, pr) = got, ref
    out = dict(loss=abs(v - vr) / abs(vr))
    for nm in gr:
        out[nm] = float(np.abs(g[nm] - gr[nm]).max() / np.abs(gr[nm]).max())
    for nm, a, b in zip(('ypred', 'ypredvar', 'yconfvar'), p, pr):
        out[nm] = float(np.abs(a - b).max() / np.abs(b).max())
    return out


def test_fast_fitc_on_config7_field():
    """At the first 20,000 rows of config 7's field, with config 7's
    inducing points and 64-point request (chip_smoke.fitc7_inputs): the
    port's 'fast' FITC within chip_smoke.fitc7_fast_bounds(20_000) (4x
    lcgp_tpu's own 'fast' error at these rows, capped at
    FITC7_FAST_BOUNDS) of its own f64 and of lcgp_tpu's 'fast' (the loss,
    each gradient leaf, the 64-point predictions)."""
    from chip_smoke import fitc7_fast_bounds, fitc7_inputs
    n = 20_000
    x, y, x0, z = fitc7_inputs()
    x, y = x[:n], y[:, :n]
    jax32 = _jax_fitc7(x, y, x0, z, 'fast')
    port64 = _port_fitc7(x, y, x0, z, 'high')
    port32 = _port_fitc7(x, y, x0, z, 'fast')
    bounds = fitc7_fast_bounds(n)
    for what, ref in (('f64', port64), ("lcgp_tpu's 'fast'", jax32)):
        err = _errors(port32, ref)
        for k, bound in bounds.items():
            assert err[k] <= bound, (what, k, err[k], bound)
