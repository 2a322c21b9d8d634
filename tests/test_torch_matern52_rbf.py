"""kernel='matern52' and kernel='rbf' in the port against lcgp_tpu, on the
CPU.

On CPU tensors the port runs the plain PyTorch versions of K3 and K4
(``ops/matern52.py``, ``ops/rbf.py``), transcriptions of the JAX package's
jnp functions, so the same NumPy inputs must give its stacks and VJPs.  The
kernels themselves are held against the plain versions on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``.  Stated tolerances:

- the plain Gram stacks: rtol 1e-12 (atol 1e-14) in f64, rtol 1e-5 (atol
  1e-6) in f32, at lengthscales in [0.3, 2];
- the plain VJPs: each output within 1e-10 of the magnitude of its sum's
  terms (``*_gram_vjp_scale``), which is rtol 1e-10 where a sum does not
  cancel;
- the model, 'high' and 'mixed': losses rtol 1e-9, gradients against
  ``jax.grad`` rtol 1e-8 ('high'), the aux and the predictions with the
  full covariance rtol 1e-7 (atol 1e-12; 'mixed' atol 1e-9, the bar of
  ``tests/test_torch_precision.py``);
- 'fast' (f32 factorizations of one f64 target differ by up to
  n eps32 cond(B)): the loss within sum_k n eps32 cond(B_k) and the
  predictions within n eps32 max_k cond(B_k) of their largest entry;
  'fast' and 'mixed' gradients rtol 5e-4, atol 1e-7.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import likelihood as JLik
from lcgp_tpu.models import params as JP
from lcgp_tpu.ops import gram as JG
from lcgp_tpu.ops import matern52 as JM5
from lcgp_tpu.ops import rbf as JR
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.models import likelihood as TLik
from lcgp_tpu_torch.models import params as TP
from lcgp_tpu_torch.ops import gram as TG
from lcgp_tpu_torch.ops import matern52 as TM5
from lcgp_tpu_torch.ops import rbf as TR
from lcgp_tpu_torch.ops.launch import fused_cotangent

torch.set_num_threads(1)  # pytest -n workers share the host's cores

KINDS = ['matern52', 'rbf']
GRAM_TOL = {torch.float64: dict(rtol=1e-12, atol=1e-14),
            torch.float32: dict(rtol=1e-5, atol=1e-6)}
VJP_BOUND = 1e-10
EPS32 = float(np.finfo(np.float32).eps)
LOSS_RTOL = 1e-9
GRAD_RTOL = 1e-8
PRED_TOL = {'high': dict(rtol=1e-7, atol=1e-12),
            'mixed': dict(rtol=1e-7, atol=1e-9)}
F32_GRAD_TOL = dict(rtol=5e-4, atol=1e-7)
JAX_DTYPE = {'high': None, 'mixed': 'mixed', 'fast': jnp.float32}
TORCH_DTYPE = {'high': None, 'mixed': 'mixed', 'fast': torch.float32}

# kind -> (plain Gram, plain VJP, plain fused VJP, VJP scale) of the port,
# and (Gram, VJP) of lcgp_tpu
PORT = {'matern52': (TM5.matern52_gram_plain, TM5.matern52_gram_vjp_plain,
                     TM5.matern52_gram_vjp_fused_plain,
                     TM5.matern52_gram_vjp_scale),
        'rbf': (TR.rbf_gram_plain, TR.rbf_gram_vjp_plain,
                TR.rbf_gram_vjp_fused_plain, TR.rbf_gram_vjp_scale)}
JAX = {'matern52': (JM5.matern52_gram, JM5.matern52_gram_vjp),
       'rbf': (JR.rbf_gram, JR.rbf_gram_vjp)}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a, dtype=np.float64)).to(dtype)


def _inputs(seed, n1=23, n2=17, d=3, q=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n1, d)), rng.uniform(0, 1, (n2, d)),
            rng.uniform(0.3, 2.0, (q, d)), rng.uniform(0.5, 3.0, q),
            rng.uniform(1e-6, 0.1, q))


def _assert_vjp_close(got, ref, scale):
    for name, g, r, s in zip(('glens', 'gamp', 'gnug'), got, ref, scale):
        err = np.abs(_np(g) - _np(r))
        assert np.all(err <= VJP_BOUND * _np(s)), (
            f'{name}: max err/magnitude {np.max(err / _np(s)):.3e}')


# ---------------------------------------------------------------------------
# the plain versions against the JAX package's functions
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same', [True, False])
@pytest.mark.parametrize('kind', KINDS)
def test_gram_plain_matches_jax(kind, same, dtype):
    x1, x2, ls, amp, nug = _inputs(0)
    if same:
        x2 = x1
    np_dt = np.float64 if dtype == torch.float64 else np.float32
    got = PORT[kind][0](*(_t(a, dtype) for a in (x1, x2, ls, amp, nug)),
                        same=same, want_c0=True)
    ref = JAX[kind][0](*(jnp.asarray(a, dtype=np_dt)
                         for a in (x1, x2, ls, amp, nug)),
                       same=same, want_c0=True)
    for a, b in zip(got, ref):
        assert a.dtype == dtype
        np.testing.assert_allclose(_np(a), np.asarray(b), **GRAM_TOL[dtype])


@pytest.mark.parametrize('with_c0', [False, True])
@pytest.mark.parametrize('same', [True, False])
@pytest.mark.parametrize('kind', KINDS)
def test_vjp_plain_matches_jax(kind, same, with_c0):
    x1, x2, ls, amp, nug = _inputs(1)
    if same:
        x2 = x1
    cbar = np.random.default_rng(2).standard_normal((4, 23, x2.shape[0]))
    c0 = None
    if with_c0:     # the forward's C0, which the VJP then does not rebuild
        c0 = PORT[kind][0](*(_t(a) for a in (x1, x2, ls, amp, nug)),
                           same=same, want_c0=True)[1]
    args = [_t(a) for a in (x1, x2, ls, amp, nug)]
    got = PORT[kind][1](*args, same=same, cbar=_t(cbar), c0=c0)
    ref = JAX[kind][1](*(jnp.asarray(a) for a in (x1, x2, ls, amp, nug)),
                       same=same, cbar=jnp.asarray(cbar),
                       c0=None if c0 is None else jnp.asarray(_np(c0)))
    scale = PORT[kind][3](*args, same=same, cbar=_t(cbar))
    _assert_vjp_close(got, ref, scale)


@pytest.mark.parametrize('kind', KINDS)
def test_vjp_fused_matches_jax(kind):
    x, _, ls, amp, nug = _inputs(3, n1=31)
    rng = np.random.default_rng(3)
    M = rng.standard_normal((4, 31, 31))
    w, alpha = rng.standard_normal((4, 31)), rng.uniform(0.1, 5.0, 4)
    cbar = _np(fused_cotangent(_t(M), _t(alpha), -0.5, _t(w)))
    args = [_t(a) for a in (x, ls, amp, nug)]
    ref = JG.gram_vjp(*(jnp.asarray(a) for a in (x, x, ls, amp, nug)),
                      same=True, cbar=jnp.asarray(cbar), kind=kind)
    scale = PORT[kind][3](args[0], *args, same=True, cbar=_t(cbar))
    for got in (PORT[kind][2](*args, M=_t(M), alpha=_t(alpha), beta=-0.5,
                              w=_t(w)),
                TG.gram_vjp_fused(*args, M=_t(M), alpha=_t(alpha),
                                  beta=-0.5, w=_t(w), kind=kind)):
        _assert_vjp_close(got, ref, scale)


@pytest.mark.parametrize('same', [False, True])
@pytest.mark.parametrize('kind', KINDS)
def test_gram_ops_dispatch_on_the_kind(kind, same):
    x1, x2, ls, amp, nug = _inputs(4)
    if same:
        x2 = x1
    t = [_t(a) for a in (x1, x2, ls, amp, nug)]
    j = [jnp.asarray(a) for a in (x1, x2, ls, amp, nug)]
    got = TG.gram_stack(*t, same=same, kind=kind)
    np.testing.assert_allclose(
        _np(got), np.asarray(JG.gram_stack(*j, same=same, kind=kind)),
        **GRAM_TOL[torch.float64])
    # the kind's own Gram, not Matern 3/2's
    assert not np.allclose(_np(got), _np(TG.gram_stack(*t, same=same)))
    if same:
        return
    rng = np.random.default_rng(5)
    rs, dv = rng.uniform(0.1, 10, 4), rng.uniform(0.5, 2, (4, 23))
    for want_c0 in (False, True):
        got = TG.gram_factor_target(t[0], *t[2:], row_scale=_t(rs),
                                    diag_vec=_t(dv), kind=kind,
                                    want_c0=want_c0)
        ref = JG.gram_factor_target(j[0], *j[2:], row_scale=jnp.asarray(rs),
                                    diag_vec=jnp.asarray(dv), kind=kind,
                                    want_c0=want_c0)
        for a, b in zip(got if want_c0 else (got,),
                        ref if want_c0 else (ref,)):
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       **GRAM_TOL[torch.float64])
    # compute_dtype f32 builds the kind's f32 stack
    got = TG.gram_stack(*t, same=False, kind=kind,
                        compute_dtype=torch.float32)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(
        _np(got), np.asarray(JG.gram_stack(*j, same=False, kind=kind,
                                           compute_dtype=jnp.float32)),
        **GRAM_TOL[torch.float32])
    cbar = rng.standard_normal((4, 23, 17))
    got = TG.gram_vjp(*t, same=False, cbar=_t(cbar), kind=kind)
    ref = JG.gram_vjp(*j, same=False, cbar=jnp.asarray(cbar), kind=kind)
    _assert_vjp_close(got, ref, PORT[kind][3](*t, same=False, cbar=_t(cbar)))


@pytest.mark.parametrize('kind', ['matern32', 'matern52', 'rbf'])
def test_family_table_holds_each_kinds_functions(kind):
    """ops/launch.py's FAMILIES is the one table of the kernel families:
    each kind's module exports the family's own functions, so one pair of
    counters counts every launch of a kind, whatever name the caller
    used."""
    from lcgp_tpu_torch.ops import launch, matern
    fam = launch.family(kind)
    mod = {'matern32': matern, 'matern52': TM5, 'rbf': TR}[kind]
    assert fam.name == kind
    assert getattr(mod, f'{kind}_gram') is fam.gram
    assert getattr(mod, f'{kind}_gram_vjp') is fam.vjp
    for f in (fam.gram, fam.vjp):
        assert isinstance(f.launches, int)
        assert isinstance(f.launches_f32, int)


def test_unknown_kind_raises_value_error():
    x1, x2, ls, amp, nug = (_t(a) for a in _inputs(6))
    with pytest.raises(ValueError, match='unknown kernel kind'):
        TG.gram_stack(x1, x2, ls, amp, nug, same=False, kind='laplace')
    with pytest.raises(ValueError, match='unknown kernel kind'):
        TG.gram_factor_target(x1, ls, amp, nug, row_scale=amp,
                              diag_vec=torch.ones(4, 23, dtype=x1.dtype),
                              kind='laplace')
    with pytest.raises(ValueError, match='unknown kernel kind'):
        TG.gram_vjp(x1, x2, ls, amp, nug, same=False,
                    cbar=torch.ones(4, 23, 17, dtype=x1.dtype),
                    kind='laplace')
    with pytest.raises(ValueError, match='unknown kernel kind'):
        TG.gram_vjp_fused(x1, ls, amp, nug,
                          M=torch.ones(4, 23, 23, dtype=x1.dtype),
                          alpha=amp, beta=-0.5, w=torch.ones(4, 23),
                          kind='laplace')


@pytest.mark.parametrize('kind', KINDS)
def test_cpu_dispatch_never_launches_and_launcher_refuses_cpu(kind):
    mod = TM5 if kind == 'matern52' else TR
    gram, vjp = getattr(mod, f'{kind}_gram'), getattr(mod, f'{kind}_gram_vjp')
    x1, x2, ls, amp, nug = (_t(a) for a in _inputs(7))
    before = (gram.launches, vjp.launches, gram.launches_f32,
              vjp.launches_f32)
    gram(x1, x1, ls, amp, nug, same=True)
    vjp(x1, x2, ls, amp, nug, same=False,
        cbar=torch.ones(4, 23, 17, dtype=x1.dtype))
    assert (gram.launches, vjp.launches, gram.launches_f32,
            vjp.launches_f32) == before
    with pytest.raises(ValueError, match='expected CUDA tensors'):
        getattr(mod, f'launch_{kind}')(x1, x1, ls, amp, nug, same=True)
    with pytest.raises(ValueError, match='expected CUDA tensors'):
        getattr(mod, f'launch_{kind}_vjp')(
            x1, x2, ls, amp, nug, same=False,
            M=torch.ones(4, 23, 17, dtype=x1.dtype))


# ---------------------------------------------------------------------------
# the model with each kind
# ---------------------------------------------------------------------------


def _problem(seed, submethod, n=40, d=2, p=3, n0=6):
    rng = np.random.default_rng(seed)
    if submethod == 'full':
        x = rng.uniform(0, 1, (n + n0, d))
        t = np.linspace(0, 1, p)[:, None]
        y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
             + np.cos(np.pi * t * x[:, -1:].T)
             + 0.05 * rng.standard_normal((p, n + n0)))
        return x[:n], y[:, :n], x[n:]
    xu = rng.uniform(0, 1, (n + n0, d))
    f = np.vstack([np.sin(3 * xu[:, 0]) + xu[:, 1], np.cos(2 * xu[:, 1]),
                   xu[:, 0] * xu[:, 1]])[:p]
    reps = rng.integers(1, 4, n)
    x = np.repeat(xu[:n], reps, axis=0)
    y = np.repeat(f[:, :n], reps, axis=1) + 0.1 * rng.standard_normal(
        (p, int(reps.sum())))
    return x, y, xu[n:]


def _pair(kind, submethod, precision, seed):
    """(JAX model, port model, held-out x) at the same moderate free
    parameters, carried across with ``convert``."""
    x, y, x0 = _problem(seed, submethod)
    jm = lcgp_tpu.LCGP(y, x, q=2, kernel=kind, submethod=submethod,
                       precision=precision)
    rng = np.random.default_rng(seed + 100)
    jm.set_params(lLmb=rng.uniform(0.3, 1.2, (2, 2)),
                  lLmb0=rng.uniform(0.5, 3.0, 2),
                  lnugGPs=rng.uniform(1e-5, 1e-3, 2))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, kernel=kind, submethod=submethod,
                             precision=precision, device='cpu')
    tm.free = convert.free_params_from_numpy(
        *(np.asarray(v) for v in jm._free), 'cpu')
    return jm, tm, x0


def _conds(tm):
    """cond(B_k) of the f64 factorization targets at tm's parameters."""
    ls, amp, _, nug = TP.constrain(tm.free)
    d = tm._data
    if tm.submethod == 'full':
        rs = d.diag_D
        dv = torch.ones((int(tm.q), tm.n), dtype=torch.float64)
    else:
        rs = torch.ones_like(d.diag_D)
        dv = 1.0 / (d.diag_D[:, None] * d.r[None, :])
    return np.linalg.cond(_np(TG.gram_factor_target(
        d.xs, ls, amp, nug, row_scale=rs, diag_vec=dv, kind=tm.kernel)))


@pytest.mark.parametrize('precision', ['high', 'mixed', 'fast'])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('kind', KINDS)
def test_model_matches_jax(kind, submethod, precision):
    """loss(), its gradient against jax.grad of lcgp_tpu's loss, the aux
    and predict with return_fullcov, per kind, submethod and precision."""
    jm, tm, x0 = _pair(kind, submethod, precision, seed=10)
    assert tm.kernel == jm.kernel == kind
    # lcgp_tpu's loss and gradient in one pass (its loss() is this function
    # at the model's compute dtype and jitter)
    t_fn = TLik.neglpost_full if submethod == 'full' else TLik.neglpost_rep
    j_fn = JLik.neglpost_full if submethod == 'full' else JLik.neglpost_rep
    ref_l, g_ref = jax.value_and_grad(
        lambda fr: j_fn(fr, jm._data, compute_dtype=JAX_DTYPE[precision],
                        jitter=jm._jitter, kernel=kind))(jm._free)
    got_l, ref_l = float(tm.loss()), float(ref_l)
    conds = _conds(tm) if precision == 'fast' else None
    if precision == 'fast':
        scale = 1.0 if submethod == 'full' else 1.0 / tm.n
        assert abs(got_l - ref_l) <= scale * np.sum(tm.n * EPS32 * conds)
    else:
        np.testing.assert_allclose(got_l, ref_l, rtol=LOSS_RTOL)

    free = TP.FreeParams(*(v.clone().requires_grad_(True) for v in tm.free))
    g = torch.autograd.grad(
        t_fn(free, tm._data, compute_dtype=TORCH_DTYPE[precision],
             jitter=tm._jitter, kernel=kind), free)
    tol = (dict(rtol=GRAD_RTOL, atol=1e-12) if precision == 'high'
           else F32_GRAD_TOL)
    for name, a, b in zip(JP.FreeParams._fields, g, g_ref):
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name, **tol)

    got = tm.predict(x0, return_fullcov=True)
    ref = jm.predict(x0, return_fullcov=True)
    if submethod == 'rep':
        assert got[3] is None and ref[3] is None
        got, ref = got[:3], ref[:3]
    for a, b in zip(got, ref):
        if precision == 'fast':
            err = np.max(np.abs(_np(a) - np.asarray(b)))
            assert err <= tm.n * EPS32 * np.max(conds) * np.max(np.abs(b))
        else:
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       **PRED_TOL[precision])
    if precision != 'fast':
        names = (('CinvMs', 'LBs') if submethod == 'full'
                 else ('CinvMs', 'LTs', 'mks'))
        for name in names:
            np.testing.assert_allclose(_np(getattr(tm, name)),
                                       np.asarray(getattr(jm, name)),
                                       err_msg=name, **PRED_TOL[precision])


@pytest.mark.parametrize('kind', KINDS)
def test_convert_carries_free_params_for_every_kind(kind):
    """The free parameters have no kernel-specific part: a model of either
    kind has Matern 3/2's free-parameter layout and init, and
    ``convert.free_params_from_numpy`` carries them across unchanged."""
    x, y, _ = _problem(11, 'full')
    jk = lcgp_tpu.LCGP(y, x, q=2, kernel=kind)
    j32 = lcgp_tpu.LCGP(y, x, q=2)
    for a, b in zip(jk._free, j32._free):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    free = convert.free_params_from_numpy(*(np.asarray(v) for v in jk._free),
                                          'cpu')
    for a, b in zip(free, jk._free):
        np.testing.assert_array_equal(_np(a), np.asarray(b))
    tk = lcgp_tpu_torch.LCGP(y, x, q=2, kernel=kind, device='cpu')
    t32 = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu')
    for a, b, c in zip(tk.free, t32.free, free):
        np.testing.assert_array_equal(_np(a), _np(b))
        # the port's SoftClip inverse matches JAX's to ~1e-14
        np.testing.assert_allclose(_np(a), _np(c), rtol=1e-13, atol=1e-14)


@pytest.mark.parametrize('kind', KINDS)
def test_save_load_across_packages_keeps_kernel(kind, tmp_path):
    jm, tm, x0 = _pair(kind, 'full', 'high', seed=12)
    tm.save(tmp_path / 'port.npz')
    jm.save(tmp_path / 'jax.npz')
    in_jax = lcgp_tpu.LCGP.load(tmp_path / 'port.npz')
    in_port = lcgp_tpu_torch.LCGP.load(tmp_path / 'jax.npz', device='cpu')
    assert in_jax.kernel == in_port.kernel == kind
    np.testing.assert_allclose(float(in_port.loss()), float(tm.loss()),
                               rtol=1e-12)
    np.testing.assert_allclose(float(in_jax.loss()), float(jm.loss()),
                               rtol=1e-12)
    for a, b in zip(in_port.predict(x0), tm.predict(x0)):
        np.testing.assert_array_equal(_np(a), _np(b))
    for a, b in zip(in_jax.predict(x0), tm.predict(x0)):
        np.testing.assert_allclose(_np(b), np.asarray(a),
                                   **PRED_TOL['high'])


@pytest.mark.parametrize('kind', KINDS)
def test_fit_scipy_lowers_the_loss(kind):
    """As tests/test_matern52.py and tests/test_rbf.py do on the JAX side:
    a short fit at n=40 lowers the loss and predicts the smooth truth."""
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (40, 1))
    f = np.vstack([np.sin(5 * x[:, 0]), np.cos(4 * x[:, 0])])
    y = f + rng.normal(0, 0.05, f.shape)
    tm = lcgp_tpu_torch.LCGP(y, x, kernel=kind, device='cpu')
    l0 = float(tm.loss())
    tm.fit(method='scipy', maxiter=20)
    assert float(tm.loss()) < l0
    yp, ypv, _ = tm.predict(x)
    assert bool(torch.isfinite(yp).all()) and bool((ypv > 0).all())
    assert np.sqrt(np.mean((_np(yp) - f) ** 2)) < 0.15
