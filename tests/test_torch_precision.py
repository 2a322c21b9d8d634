"""The port's precision modes ('mixed', 'mixed:N', 'fast', 'auto') against
lcgp_tpu's, on both submethods, on the CPU.

Same (y, x) from a seed with NumPy and the same free parameters through
both packages.  Stated tolerances:

- 'mixed' losses: rtol 1e-9 against lcgp_tpu's 'mixed' and against the
  port's own 'high' (the refined factor is f64-grade; lcgp_tpu holds
  itself to rtol 1e-8 against 'high', ``tests/test_likelihood.py:404``);
  'mixed' predictions: rtol 1e-7, atol 1e-9 (the oracle bar of
  ``RESULTS.md:579-586``);
- 'fast' losses and predictions against lcgp_tpu's 'fast': two f32
  factorizations of one f64 target differ by up to ~n eps32 cond(B) in
  their logdets and solves, so the loss within sum_k n eps32 cond(B_k)
  (absolute) and the predictions within n eps32 max_k cond(B_k) of their
  largest entry, with cond(B_k) computed from the f64 target;
- gradients under 'mixed' and 'fast' against ``jax.grad`` of the same
  mode: rtol 5e-4, atol 1e-7, the f32-grade bar of
  ``tests/test_likelihood.py:424-426``.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import likelihood as JLik
from lcgp_tpu.models import params as JP
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.models import likelihood as TLik
from lcgp_tpu_torch.models import params as TP
from lcgp_tpu_torch.ops.gram import gram_factor_target

torch.set_num_threads(1)  # pytest -n workers share the host's cores

EPS32 = float(np.finfo(np.float32).eps)
MIXED_LOSS_RTOL = 1e-9
MIXED_PRED_TOL = dict(rtol=1e-7, atol=1e-9)
GRAD_TOL = dict(rtol=5e-4, atol=1e-7)

JAX_DTYPE = {'high': None, 'mixed': 'mixed', 'mixed:3': 'mixed:3',
             'fast': jnp.float32}
TORCH_DTYPE = {'high': None, 'mixed': 'mixed', 'mixed:3': 'mixed:3',
               'fast': torch.float32}


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _problem(seed, n=80, d=2, p=3, n0=9):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, -1:].T)
         + 0.05 * rng.standard_normal((p, n + n0)))
    return x[:n], y[:, :n], x[n:]


def _rep_problem(seed, n_unique=70, d=2, p=3, n0=9):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n_unique + n0, d))
    f = np.vstack([np.sin(3 * xu[:, 0]) + xu[:, 1], np.cos(2 * xu[:, 1]),
                   xu[:, 0] * xu[:, 1]])[:p]
    reps = rng.integers(1, 4, n_unique)
    x = np.repeat(xu[:n_unique], reps, axis=0)
    y = np.repeat(f[:, :n_unique], reps, axis=1)
    y = y + 0.1 * rng.standard_normal(y.shape)
    return x, y, xu[n_unique:]


def _pair(submethod, precision, seed=0, amp=None, n=80):
    """(JAX model, port model, held-out x) at the same free parameters,
    moderate ones unless ``amp`` sets every amplitude (below the 1e4
    ceiling of its SoftClip)."""
    x, y, x0 = (_problem(seed, n=n) if submethod == 'full'
                else _rep_problem(seed))
    jm = lcgp_tpu.LCGP(y, x, q=2, precision=precision, submethod=submethod)
    rng = np.random.default_rng(seed + 100)
    jm.set_params(lLmb=rng.uniform(0.3, 1.2, (2, 2)),
                  lLmb0=(rng.uniform(0.5, 3.0, 2) if amp is None
                         else np.full(2, amp)),
                  lnugGPs=rng.uniform(1e-5, 1e-3, 2))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, precision=precision,
                             submethod=submethod, device='cpu')
    tm.free = convert.free_params_from_numpy(
        *(np.asarray(v) for v in jm._free), 'cpu')
    return jm, tm, x0


def _conds(tm):
    """cond(B_k) of the f64 factorization targets at tm's parameters:
    D_k C_k + I (full) or C_k + diag(1/(D_k r)) (rep)."""
    ls, amp, _, nug = TP.constrain(tm.free)
    d = tm._data
    if tm.submethod == 'full':
        B = gram_factor_target(d.xs, ls, amp, nug, row_scale=d.diag_D,
                               diag_vec=torch.ones((int(tm.q), tm.n),
                                                   dtype=torch.float64))
    else:
        B = gram_factor_target(
            d.xs, ls, amp, nug, row_scale=torch.ones_like(d.diag_D),
            diag_vec=1.0 / (d.diag_D[:, None] * d.r[None, :]))
    return np.linalg.cond(_np(B))


def _grad(model_free, data, fn, **kw):
    free = TP.FreeParams(*(t.clone().requires_grad_(True)
                           for t in model_free))
    v = fn(free, data, **kw)
    return v, torch.autograd.grad(v, free)


# ---------------------------------------------------------------------------
# losses and gradients
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('mode', ['mixed', 'mixed:3'])
def test_mixed_loss_matches_jax_and_high(submethod, mode):
    jm, tm, _ = _pair(submethod, 'high', seed=1)
    t_fn = TLik.neglpost_full if submethod == 'full' else TLik.neglpost_rep
    j_fn = JLik.neglpost_full if submethod == 'full' else JLik.neglpost_rep
    with torch.no_grad():
        got = float(t_fn(tm.free, tm._data, compute_dtype=mode))
        high = float(t_fn(tm.free, tm._data))
    ref = float(j_fn(jm._free, jm._data, compute_dtype=mode))
    np.testing.assert_allclose(got, ref, rtol=MIXED_LOSS_RTOL)
    np.testing.assert_allclose(got, high, rtol=MIXED_LOSS_RTOL)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_fast_loss_matches_jax(submethod):
    jm, tm, _ = _pair(submethod, 'fast', seed=2)
    got, ref = float(tm.loss()), float(jm.loss())
    scale = 1.0 if submethod == 'full' else 1.0 / tm.n   # rep divides by n
    atol = scale * float(np.sum(tm.n * EPS32 * _conds(tm)))
    assert abs(got - ref) <= atol, (got, ref, atol)
    # and it really ran in f32
    with torch.no_grad():
        fn = TLik.neglpost_full if submethod == 'full' else TLik.neglpost_rep
        assert got != float(fn(tm.free, tm._data))


@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('mode', ['mixed', 'fast'])
def test_gradient_matches_jax_grad(submethod, mode):
    jm, tm, _ = _pair(submethod, 'high', seed=3)
    jitter = 1e-6 if mode == 'fast' else 0.0
    t_fn = TLik.neglpost_full if submethod == 'full' else TLik.neglpost_rep
    j_fn = JLik.neglpost_full if submethod == 'full' else JLik.neglpost_rep
    _, g = _grad(tm.free, tm._data, t_fn, compute_dtype=TORCH_DTYPE[mode],
                 jitter=jitter)
    g_ref = jax.grad(lambda fr: j_fn(fr, jm._data,
                                     compute_dtype=JAX_DTYPE[mode],
                                     jitter=jitter))(jm._free)
    for name, a, b in zip(JP.FreeParams._fields, g, g_ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(_np(a), np.asarray(b), err_msg=name,
                                   **GRAD_TOL)


@pytest.mark.parametrize('q_chunk', [None, 1])
def test_fast_gradient_runs_the_vjp_in_f32(q_chunk, monkeypatch):
    """Under 'fast' and 'mixed' the Gram VJP gets an f32 cotangent (K2's
    f32 instantiation on CUDA) and hands back f64 gradients."""
    _, tm, _ = _pair('full', 'high', seed=4)
    seen = []
    real = TLik.gram_vjp_fused

    def spy(*a, **k):
        seen.append(k['M'].dtype)
        return real(*a, **k)
    monkeypatch.setattr(TLik, 'gram_vjp_fused', spy)
    for mode in ('mixed', 'fast'):
        _grad(tm.free, tm._data, TLik.neglpost_full,
              compute_dtype=TORCH_DTYPE[mode], q_chunk=q_chunk)
    _grad(tm.free, tm._data, TLik.neglpost_full, q_chunk=q_chunk)
    per = 1 if q_chunk is None else 2
    assert seen == ([torch.float32] * (2 * per) + [torch.float64] * per)


# ---------------------------------------------------------------------------
# the LCGP surface per mode and submethod
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('precision', ['mixed', 'fast'])
def test_model_loss_and_predictions_match_jax(submethod, precision):
    jm, tm, x0 = _pair(submethod, precision, seed=5)
    assert tm.precision == jm.precision == precision
    got_l, ref_l = float(tm.loss()), float(jm.loss())
    got = tm.predict(x0)
    ref = jm.predict(x0)
    if precision == 'mixed':
        np.testing.assert_allclose(got_l, ref_l, rtol=MIXED_LOSS_RTOL)
        for a, b in zip(got, ref):
            assert a.dtype == torch.float64
            np.testing.assert_allclose(_np(a), np.asarray(b),
                                       **MIXED_PRED_TOL)
        return
    conds = _conds(tm)
    scale = 1.0 if submethod == 'full' else 1.0 / tm.n
    assert abs(got_l - ref_l) <= scale * np.sum(tm.n * EPS32 * conds)
    for a, b in zip(got, ref):
        err = np.max(np.abs(_np(a) - np.asarray(b)))
        assert err <= tm.n * EPS32 * np.max(conds) * np.max(np.abs(b))
    # the latents are f32, promoted in the recombination as jnp does
    assert tm.ghat.dtype == tm.gvar.dtype == torch.float32
    assert str(jm.ghat.dtype) == 'float32'


def test_fast_aux_and_accessors_are_f32():
    jm, tm, x0 = _pair('full', 'fast', seed=6)
    assert tm.LBs.dtype == tm.CinvMs.dtype == torch.float32
    np.testing.assert_allclose(_np(tm.LBs), np.asarray(jm.LBs), rtol=1e-4,
                               atol=1e-5)
    assert tm.Ths.dtype == torch.float32
    fc = tm.predict(x0[:3], return_fullcov=True)
    assert fc[3].dtype == torch.float64
    np.testing.assert_allclose(
        np.diagonal(_np(fc[3]), axis1=-2, axis2=-1).T, _np(fc[1]), rtol=1e-6)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('amp', [None, 9e3])
def test_recommended_refine_steps_match_jax(submethod, amp):
    jm, tm, _ = _pair(submethod, 'mixed', seed=7, amp=amp)
    assert tm.recommended_refine_steps() == jm.recommended_refine_steps()


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_loss_ratchets_refinement_up_only(submethod):
    # cond bound 1 + D amp n past 3e5 at n=150: 3 steps
    jm, tm, _ = _pair(submethod, 'mixed', seed=8, amp=9e3, n=150)
    rec = tm.recommended_refine_steps()
    assert rec > 2
    lt, lj = float(tm.loss()), float(jm.loss())
    assert tm._compute_dtype == jm._compute_dtype == f'mixed:{rec}'
    np.testing.assert_allclose(lt, lj, rtol=MIXED_LOSS_RTOL)
    # it never ratchets down
    _, _, lsig, lnug = TP.constrain(tm.free)
    lLmb = TP.constrain(tm.free)[0]
    tm.free = TP.unconstrain(lLmb, torch.ones(2, dtype=torch.float64), lsig,
                             lnug)
    float(tm.loss())
    assert tm._compute_dtype == f'mixed:{rec}'


def test_auto_precision_resolves_like_jax():
    rng = np.random.default_rng(9)
    x, y = rng.uniform(0, 1, (50, 2)), rng.standard_normal((3, 50))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, precision='auto', device='cpu')
    assert tm.precision == 'high' and tm._compute_dtype is None
    n = lcgp_tpu_torch.LCGP._AUTO_MIXED_N
    assert n == lcgp_tpu.LCGP._AUTO_MIXED_N == 2048
    x, y = rng.uniform(0, 1, (n, 2)), rng.standard_normal((3, n))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, precision='auto', device='cpu')
    jm = lcgp_tpu.LCGP(y, x, q=2, precision='auto')
    assert tm.precision == jm.precision == 'mixed'
    assert tm._compute_dtype == 'mixed' and tm._jitter == jm._jitter
    x, y = x[:n - 1], y[:, :n - 1]
    assert lcgp_tpu_torch.LCGP(y, x, q=2, precision='auto',
                               device='cpu').precision == 'high'


def test_auto_precision_uses_the_rep_collapsed_n():
    # 3000 raw rows but 100 unique sites: resolved on the unique count
    rng = np.random.default_rng(10)
    x = np.repeat(rng.uniform(0, 1, (100, 2)), 30, axis=0)
    y = rng.standard_normal((3, 3000))
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, submethod='rep', precision='auto',
                             device='cpu')
    jm = lcgp_tpu.LCGP(y, x, q=2, submethod='rep', precision='auto')
    assert tm.n == jm.n == 100
    assert tm.precision == jm.precision == 'high'


def test_fast_q_chunk_counts_four_bytes():
    cls, cpu = lcgp_tpu_torch.LCGP, torch.device('cpu')
    for prec in ('high', 'mixed', 'fast'):
        assert cls._auto_q_chunk(20, 4096, cpu, prec) == \
            lcgp_tpu.LCGP._auto_q_chunk(20, 4096, prec)
    # (8 qc + q) n^2 itemsize against the 10 GB CPU budget
    assert cls._auto_q_chunk(20, 4096, cpu, 'fast') == 10
    assert cls._auto_q_chunk(20, 4096, cpu, 'high') == 5


@pytest.mark.parametrize('submethod', ['full', 'rep'])
@pytest.mark.parametrize('precision', ['mixed', 'fast'])
def test_save_load_keeps_precision_across_packages(submethod, precision,
                                                   tmp_path):
    jm, tm, x0 = _pair(submethod, precision, seed=11)
    tm.save(tmp_path / 'port.npz')
    jm.save(tmp_path / 'jax.npz')
    in_jax = lcgp_tpu.LCGP.load(tmp_path / 'port.npz')
    in_port = lcgp_tpu_torch.LCGP.load(tmp_path / 'jax.npz', device='cpu')
    assert in_jax.precision == in_port.precision == precision
    assert in_port._compute_dtype == TORCH_DTYPE[precision]
    np.testing.assert_allclose(float(in_port.loss()), float(tm.loss()),
                               rtol=1e-12)
    np.testing.assert_allclose(float(in_jax.loss()), float(jm.loss()),
                               rtol=1e-12)
    for a, b in zip(in_port.predict(x0), tm.predict(x0)):
        np.testing.assert_array_equal(_np(a), _np(b))


def test_mixed_hint_prints_once_without_the_tpu_ratio(monkeypatch, capsys):
    monkeypatch.setattr(lcgp_tpu_torch.LCGP, '_AUTO_ONDEVICE_N', 50)
    monkeypatch.setattr(lcgp_tpu_torch.LCGP, '_AUTO_MIXED_N', 50)
    _, tm, _ = _pair('full', 'high', seed=12)
    tm.fit(verbose=True, maxiter=1)
    tm.fit(verbose=True, maxiter=1)
    out = capsys.readouterr().out
    assert out.count('hint:') == 1
    assert 'H100' in out and '0.47' not in out
