"""The port's full serving path against lcgp_tpu and the NumPy oracle.

Same (y, x) and the same free parameters (carried over with
``lcgp_tpu_torch.convert``) through both packages, on the CPU in float64.
Stated tolerances: ``neglpost_full`` rtol 1e-10; predictions (mean,
predvar, confvar, fullcov) rtol 1e-9, atol 1e-12; against the oracle the
bar of RESULTS.md:579-586, rtol 1e-7."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import likelihood as JLik
from lcgp_tpu.models import predict as JPred
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.models import likelihood as TLik
from lcgp_tpu_torch.models import predict as TPred
from lcgp_tpu_torch.ops import matern as TM
import oracle

torch.set_num_threads(1)  # pytest -n workers share the host's cores

LOSS_RTOL = 1e-10
PRED_TOL = dict(rtol=1e-9, atol=1e-12)


def _problem(seed, n=120, d=3, p=10, n0=15):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, -1:].T)
         + 0.05 * rng.standard_normal((p, n + n0)))
    return x[:n], y[:, :n], x[n:]


def _fitted_like(jm, seed):
    """Move the JAX model off its init to parameters a fit could reach."""
    rng = np.random.default_rng(seed)
    q, d = int(jm.q), int(jm.d)
    jm.set_params(lLmb=rng.uniform(0.2, 1.5, (q, d)),
                  lLmb0=rng.uniform(0.5, 3.0, q),
                  lnugGPs=rng.uniform(1e-6, 1e-3, q),
                  lsigma2s=np.asarray(jm.lsigma2s) - 1.0)


def _free_np(jm):
    return [np.asarray(v) for v in jm._free]


def _port_of(jm, **kw):
    tm = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                             q=int(jm.q), device='cpu', **kw)
    tm.free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    return tm


def _close(got, ref, **tol):
    got = got.numpy() if isinstance(got, torch.Tensor) else got
    np.testing.assert_allclose(got, np.asarray(ref), **tol)


@pytest.fixture(scope='module')
def pair():
    """(jax model, port model, held-out x) at n=120, d=3, p=10, q=4."""
    x, y, x0 = _problem(0)
    jm = lcgp_tpu.LCGP(y, x, q=4)
    _fitted_like(jm, 1)
    return jm, _port_of(jm), x0


# ---------------------------------------------------------------------------
# functions of (free, data), fed the JAX model's own data
# ---------------------------------------------------------------------------


def _data_of(jm):
    d = jm._data
    return convert.full_data_from_numpy(d.xs, d.ys, d.phi, d.diag_D,
                                        d.sigma_map, 'cpu')


@pytest.mark.parametrize('q_chunk', [None, 2])
def test_neglpost_full_matches_jax(pair, q_chunk):
    jm, _, _ = pair
    free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    got = TLik.neglpost_full(free, _data_of(jm), q_chunk=q_chunk)
    ref = JLik.neglpost_full(jm._free, jm._data, q_chunk=q_chunk)
    assert got.dtype == torch.float64
    _close(got, ref, rtol=LOSS_RTOL)


@pytest.mark.parametrize('q_chunk', [None, 2])
def test_aux_predict_core_recombine_match_jax(pair, q_chunk):
    jm, _, x0 = pair
    free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
    data = _data_of(jm)
    aux = TPred.compute_aux_full(free, data, q_chunk=q_chunk)
    aux_j = JPred.compute_aux_full(jm._free, jm._data, q_chunk=q_chunk)
    _close(aux.CinvM, aux_j.CinvM, **PRED_TOL)
    _close(aux.LB, aux_j.LB, **PRED_TOL)
    x0s = (x0 - np.asarray(jm.x_min)) / (np.asarray(jm.x_max)
                                         - np.asarray(jm.x_min))
    ghat, gvar = TPred.predict_full_core(free, data, aux, torch.as_tensor(x0s),
                                         q_chunk=q_chunk)
    ghat_j, gvar_j = JPred.predict_full_core(jm._free, jm._data, aux_j,
                                             jnp.asarray(x0s),
                                             q_chunk=q_chunk)
    _close(ghat, ghat_j, **PRED_TOL)
    _close(gvar, gvar_j, **PRED_TOL)
    ymean, ystd = np.array(jm.ymean), np.array(jm.ystd)
    got = TPred.recombine_full(free, data, ghat, gvar, torch.as_tensor(ymean),
                               torch.as_tensor(ystd))
    ref = JPred.recombine_full(jm._free, jm._data, ghat_j, gvar_j,
                               jnp.asarray(ymean), jnp.asarray(ystd))
    for a, b in zip(got, ref):
        _close(a, b, **PRED_TOL)
    _close(TPred.fullcov_full(free, data, gvar, torch.as_tensor(ystd)),
           JPred.fullcov_full(jm._free, jm._data, gvar_j, jnp.asarray(ystd)),
           **PRED_TOL)


def test_aux_and_predict_at_n1100_match_jax():
    """n >= 1024 sends the JAX side through its blocked f64 Cholesky
    (lcgp_tpu/ops/linalg.py:71-82)."""
    x, y, x0 = _problem(2, n=1100, d=2, p=3, n0=9)
    jm = lcgp_tpu.LCGP(y, x, q=2)
    _fitted_like(jm, 3)
    tm = _port_of(jm)
    for a, b in zip(tm.predict(x0), jm.predict(x0)):
        _close(a, b, **PRED_TOL)
    _close(tm._ensure_aux().LB, jm.LBs, **PRED_TOL)


# ---------------------------------------------------------------------------
# the slice as a whole: both LCGPs built from the same (y, x)
# ---------------------------------------------------------------------------


def test_construction_matches_jax(pair):
    jm, tm, _ = pair
    for name in ('x', 'y', 'x_min', 'x_max', 'ymean', 'ystd'):
        _close(getattr(tm, name), getattr(jm, name), rtol=1e-15, atol=1e-15)
    for name in ('phi', 'diag_D', 'g'):
        _close(getattr(tm, name), getattr(jm, name), rtol=1e-12, atol=1e-13)
    assert (tm.n, tm.d, tm.p, tm.q) == (jm.n, jm.d, jm.p, jm.q)
    init = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                               q=4, device='cpu')
    fresh = lcgp_tpu.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig), q=4)
    for a, b in zip(init.free, fresh._free):
        _close(a, b, rtol=1e-13, atol=1e-15)


def test_get_param_matches_jax(pair):
    jm, tm, _ = pair
    for a, b in zip(tm.get_param(), jm.get_param()):
        _close(a, b, rtol=1e-15, atol=1e-15)
    for name in ('lLmb', 'lLmb0', 'lsigma2s', 'lnugGPs'):
        _close(getattr(tm, name), getattr(jm, name), rtol=1e-15, atol=1e-15)


def test_loss_matches_jax(pair):
    jm, tm, _ = pair
    _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)


def test_predict_fullcov_matches_jax(pair):
    jm, tm, x0 = pair
    got = tm.predict(x0, return_fullcov=True)
    ref = jm.predict(x0, return_fullcov=True)
    assert len(got) == 4 and all(g.dtype == torch.float64 for g in got)
    for a, b in zip(got, ref):
        _close(a, b, **PRED_TOL)
    np.testing.assert_allclose(
        np.diagonal(got[3].numpy(), axis1=1, axis2=2).T, got[1].numpy(),
        rtol=1e-12)


@pytest.mark.parametrize('batch_size', [4, 16, 64])
def test_batched_predict_equals_one_shot(pair, batch_size):
    _, tm, x0 = pair
    one = tm.predict(x0)
    for a, b in zip(tm.predict(x0, batch_size=batch_size), one):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-13,
                                   atol=1e-14)


def test_batch_with_fullcov_raises(pair):
    _, tm, x0 = pair
    with pytest.raises(ValueError, match='batch_size'):
        tm.predict(x0, return_fullcov=True, batch_size=4)


def test_matches_oracle(pair):
    _, tm, x0 = pair

    def h(t):
        return t.numpy()
    lLmb, lLmb0, lsig, lnug = (h(v) for v in
                               lcgp_tpu_torch.models.params.constrain(tm.free))
    args = (lLmb, lLmb0, lsig, lnug, h(tm.x), h(tm.y), h(tm.phi),
            h(tm.diag_D), tm.diag_error_structure)
    _close(tm.loss(), oracle.neglpost_full_np(*args), rtol=1e-9)
    ref = oracle.predict_full_np(*args, h(tm.ymean), h(tm.ystd),
                                 h(tm._standardize_x0(x0)),
                                 return_fullcov=True)
    for a, b in zip(tm.predict(x0, return_fullcov=True), ref):
        _close(a, b, rtol=1e-7, atol=1e-12)


def test_q_chunk_matches_unchunked(pair):
    jm, tm, x0 = pair
    chunked = _port_of(jm, q_chunk=2)
    assert chunked.q_chunk == 2 and tm.q_chunk is None
    _close(chunked.loss(), tm.loss().numpy(), rtol=1e-13)
    for a, b in zip(chunked.predict(x0), tm.predict(x0)):
        _close(a, b.numpy(), rtol=1e-13, atol=1e-14)


def test_set_params_and_aux_refresh(pair):
    jm, _, x0 = pair
    tm = _port_of(jm)
    before = tm.predict(x0)[0].clone()
    cur = tm.get_param()
    tm.set_params(lLmb=cur[0] * 1.1)
    _close(tm.lLmb, cur[0].numpy() * 1.1, rtol=1e-12)
    assert not torch.allclose(tm.predict(x0)[0], before)
    jm2 = lcgp_tpu.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig), q=4)
    jm2._free = jm._free
    jm2.set_params(lLmb=np.asarray(cur[0]) * 1.1)
    for a, b in zip(tm.predict(x0), jm2.predict(x0)):
        _close(a, b, **PRED_TOL)


def test_tx_roundtrip_and_repr(pair):
    _, tm, _ = pair
    _close(tm.tx_x(tm.x), tm.x_orig.numpy(), rtol=1e-14, atol=1e-15)
    _close(tm.tx_y(tm.y), tm.y_orig.numpy(), rtol=1e-13, atol=1e-14)
    text = repr(tm)
    assert 'number of latent components:\t4' in text and 'LCGP(' in text


# ---------------------------------------------------------------------------
# save/load across packages (the npz format of lcgp_tpu.LCGP.save)
# ---------------------------------------------------------------------------


def test_jax_saved_model_loads_in_port(pair, tmp_path):
    jm, _, x0 = pair
    path = tmp_path / 'jax_model.npz'
    jm.save(path)
    tm = lcgp_tpu_torch.LCGP.load(path, device='cpu')
    for a, b in zip(tm.free, jm._free):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(tm.predict(x0, return_fullcov=True),
                    jm.predict(x0, return_fullcov=True)):
        _close(a, b, **PRED_TOL)


def test_port_saved_model_loads_in_jax(pair, tmp_path):
    jm, tm, x0 = pair
    path = tmp_path / 'port_model.npz'
    tm.save(path)
    jm2 = lcgp_tpu.LCGP.load(path)
    for a, b in zip(jm2._free, tm.free):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    for a, b in zip(tm.predict(x0), jm2.predict(x0)):
        _close(a, b, **PRED_TOL)
    back = lcgp_tpu_torch.LCGP.load(path, device='cpu')
    for a, b in zip(back.predict(x0), tm.predict(x0)):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


# ---------------------------------------------------------------------------
# no silent fallback, and what is not ported yet
# ---------------------------------------------------------------------------


def test_cuda_default_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    x, y, _ = _problem(4, n=20, p=3)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        lcgp_tpu_torch.LCGP(y, x, q=2)


def test_cpu_model_never_launches_the_kernel(pair):
    _, tm, x0 = pair
    before = TM.matern32_gram.launches
    tm.loss()
    tm.compute_aux_predictive_quantities()
    tm.predict(x0, batch_size=8)
    assert TM.matern32_gram.launches == before


@pytest.mark.parametrize('kind', ['matern52', 'rbf'])
def test_cpu_model_never_launches_the_kind_kernels(kind):
    """On the CPU a matern52 or rbf model runs the plain versions: neither
    K3/K4 nor its VJP counts a launch, in f64 or f32."""
    from lcgp_tpu_torch.ops import matern52, rbf
    mod = matern52 if kind == 'matern52' else rbf
    counters = (getattr(mod, f'{kind}_gram'), getattr(mod, f'{kind}_gram_vjp'))
    before = [(c.launches, c.launches_f32) for c in counters]
    x, y, x0 = _problem(7, n=30, p=3)
    for precision in ('high', 'fast'):
        tm = lcgp_tpu_torch.LCGP(y, x, q=2, kernel=kind, precision=precision,
                                 device='cpu')
        tm.fit(method='scipy', maxiter=2)
        tm.predict(x0, batch_size=8)
    assert [(c.launches, c.launches_f32) for c in counters] == before


@pytest.mark.parametrize('kind', ['rbf', 'matern52'])
def test_kernel_kinds_are_ported(kind):
    """kernel='matern52' and 'rbf' construct on both submethods and give
    lcgp_tpu's loss (tests/test_torch_matern52_rbf.py holds the rest)."""
    x, y, _ = _problem(5, n=20, p=3)
    for submethod, xx, yy in (('full', x, y),
                              ('rep', np.repeat(x, 2, axis=0),
                               np.repeat(y, 2, axis=1))):
        tm = lcgp_tpu_torch.LCGP(yy, xx, q=2, kernel=kind, device='cpu',
                                 submethod=submethod)
        jm = lcgp_tpu.LCGP(yy, xx, q=2, kernel=kind, submethod=submethod)
        assert tm.kernel == jm.kernel == kind
        tm.free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
        _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)


def test_inducing_option_is_ported():
    """inducing= (FITC) constructs on both submethods and gives lcgp_tpu's
    loss (tests/test_torch_sparse.py holds the rest of the path)."""
    x, y, _ = _problem(5, n=20, p=3)
    for submethod in ('full', 'rep'):
        tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu', inducing=5,
                                 submethod=submethod)
        jm = lcgp_tpu.LCGP(y, x, q=2, inducing=5, submethod=submethod)
        np.testing.assert_array_equal(tm._z.numpy(), np.asarray(jm._z))
        tm.free = convert.free_params_from_numpy(*_free_np(jm), 'cpu')
        _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)


def test_rep_submethod_is_ported():
    """submethod='rep' constructs and gives lcgp_tpu's loss and
    predictions (tests/test_torch_rep.py holds the rest of the path)."""
    x, y, x0 = _problem(5, n=20, p=3)
    x, y = np.repeat(x, 2, axis=0), np.repeat(y, 2, axis=1)
    tm = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu', submethod='rep')
    jm = lcgp_tpu.LCGP(y, x, q=2, submethod='rep')
    assert tm.submethod == 'rep' and tm.n == jm.n == 20
    _close(tm.loss(), jm.loss(), rtol=LOSS_RTOL)
    for a, b in zip(tm.predict(x0), jm.predict(x0)):
        _close(a, b, **PRED_TOL)


@pytest.mark.parametrize('kw', [dict(submethod='nope'), dict(precision='x'),
                                dict(kernel='nope')])
def test_invalid_options_raise_value_error(kw):
    x, y, _ = _problem(6, n=20, p=3)
    with pytest.raises(ValueError):
        lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu', **kw)


def test_full_path_aux_accessors_match_jax(pair):
    """LBs and Ths (one batched eigh) on the full path; the rep-path
    accessors are None there, as in lcgp_tpu."""
    jm, tm, _ = pair
    _close(tm.CinvMs, jm.CinvMs, **PRED_TOL)
    _close(tm.LBs, jm.LBs, **PRED_TOL)
    _close(tm.Ths, jm.Ths, rtol=1e-9, atol=1e-11)
    for name in ('LTs', 'Tks', 'mks', 'psi_c'):
        assert getattr(tm, name) is None and getattr(jm, name) is None


def test_auto_q_chunk_model():
    cls = lcgp_tpu_torch.LCGP
    cpu = torch.device('cpu')
    assert cls._auto_q_chunk(4, 120, cpu) is None
    # (8 qc + q) n^2 8 bytes against the 10 GB CPU budget: q=20, n=4096
    # needs 24 GB unchunked, so it chunks to a divisor of q that fits
    qc = cls._auto_q_chunk(20, 4096, cpu)
    assert qc is not None and 20 % qc == 0
    assert (8 * qc + 20) * 4096 ** 2 * 8 <= cls._MEM_BUDGET_DEFAULT
