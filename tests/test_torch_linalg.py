"""lcgp_tpu_torch.ops.linalg against lcgp_tpu.ops.linalg.

torch.linalg and XLA reach LAPACK through different call sequences (and
the JAX package blocks its f64 Cholesky at n >= 1024), so the tolerance is
rtol 1e-11 on well-conditioned inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lcgp_tpu.ops import linalg as JL
from lcgp_tpu_torch.ops import linalg as TL

torch.set_num_threads(1)  # pytest -n workers share the host's cores

TOL = dict(rtol=1e-11, atol=1e-13)


def _spd(seed, q=3, n=40):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((q, n, n))
    return a @ np.swapaxes(a, -1, -2) / n + np.eye(n)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


@pytest.mark.parametrize('vals', ['scalar', 'vector', 'batched'])
def test_add_diag_matches_jax(vals):
    m = _spd(0)
    v = {'scalar': 1.5, 'vector': np.linspace(1, 2, 40),
         'batched': np.random.default_rng(1).uniform(0, 1, (3, 40))}[vals]
    got = TL.add_diag(_t(m), v if vals == 'scalar' else _t(v))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JL.add_diag(jnp.asarray(m), v)))


@pytest.mark.parametrize('n', [40, 1100])   # 1100: JAX's blocked branch
def test_cholesky_and_logdet_match_jax(n):
    m = _spd(2, q=2, n=n)
    L = TL.cholesky(_t(m))
    L_ref = JL.cholesky(jnp.asarray(m))
    np.testing.assert_allclose(L.numpy(), np.asarray(L_ref), **TOL)
    np.testing.assert_allclose(TL.chol_logdet(L).numpy(),
                               np.asarray(JL.chol_logdet(L_ref)), **TOL)


def test_cholesky_nan_for_non_pd_like_jax():
    m = _spd(3)
    m[1] = -m[1]                      # not positive definite
    L = TL.cholesky(_t(m))            # no raise
    L_ref = np.asarray(JL.cholesky(jnp.asarray(m)))
    # JAX: NaN on and below the diagonal, zeros above
    np.testing.assert_array_equal(np.isnan(L.numpy()), np.isnan(L_ref))
    assert np.isnan(L[1].numpy()[np.tril_indices(40)]).all()
    np.testing.assert_allclose(L.numpy(), L_ref, **TOL)


def test_solves_match_jax():
    m = _spd(4)
    rng = np.random.default_rng(5)
    rhs, vec = rng.standard_normal((3, 40, 6)), rng.standard_normal((3, 40))
    L = TL.cholesky(_t(m))
    Lj = JL.cholesky(jnp.asarray(m))
    np.testing.assert_allclose(TL.solve_tri_lower(L, _t(rhs)).numpy(),
                               np.asarray(JL.solve_tri_lower(Lj, rhs)), **TOL)
    np.testing.assert_allclose(TL.cho_solve(L, _t(rhs)).numpy(),
                               np.asarray(JL.cho_solve(Lj, rhs)), **TOL)
    np.testing.assert_allclose(TL.cho_solve_vec(L, _t(vec)).numpy(),
                               np.asarray(JL.cho_solve_vec(Lj, vec)), **TOL)
    # and they solve the system
    np.testing.assert_allclose(
        m @ TL.cho_solve_vec(L, _t(vec)).numpy()[..., None],
        vec[..., None], rtol=1e-10, atol=1e-12)
