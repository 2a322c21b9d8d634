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


# ---------------------------------------------------------------------------
# The blocked factor (n >= _BLOCKED_MIN_N, outside autograd)
# ---------------------------------------------------------------------------

_DT = {'f64': (torch.float64, np.float64, TOL),
       'f32': (torch.float32, np.float32, dict(rtol=2e-4, atol=2e-5))}


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
@pytest.mark.parametrize('n', [1100, 2048])   # 1100: a narrower last block
def test_cholesky_blocked_matches_jax_and_cholesky_ex(n, dtype):
    tdt, ndt, tol = _DT[dtype]
    m = _spd(6, q=2, n=n).astype(ndt)
    before = (TL.cholesky.blocked, TL.cholesky.dense)
    L = TL.cholesky(torch.as_tensor(m))
    assert (TL.cholesky.blocked, TL.cholesky.dense) == (before[0] + 1,
                                                        before[1])
    assert L.dtype == tdt and L.is_contiguous()
    assert not torch.triu(L, 1).any()
    ref_ex = torch.linalg.cholesky_ex(torch.as_tensor(m))[0]
    torch.testing.assert_close(L, ref_ex, **tol)
    np.testing.assert_allclose(L.numpy(), np.asarray(JL.cholesky(
        jnp.asarray(m))), **tol)


@pytest.mark.parametrize('where', ['first', 'last'])
def test_cholesky_blocked_nan_for_non_pd(where):
    """A matrix that fails in the first or the last block: its whole lower
    triangle NaN and zeros above, the others as cholesky_ex has them."""
    n = 1100
    m = _spd(7, q=3, n=n)
    i = 0 if where == 'first' else n - 1
    m[1, i, i] = -1.0
    L = TL.cholesky(_t(m))
    ref, info = torch.linalg.cholesky_ex(_t(m))
    assert info.tolist()[1] > 0 and info.tolist()[::2] == [0, 0]
    lower = np.tril_indices(n)
    assert np.isnan(L[1].numpy()[lower]).all()
    assert not torch.triu(L[1], 1).any()
    torch.testing.assert_close(L[::2], ref[::2], **TOL)


@pytest.mark.parametrize('dtype', ['f64', 'f32'])
def test_cholesky_overwrite_works_in_the_input(dtype):
    tdt, ndt, _ = _DT[dtype]
    A = torch.as_tensor(_spd(8, q=2, n=1100).astype(ndt))
    A0 = A.clone()
    L = TL.cholesky(A)
    assert torch.equal(A, A0)
    mine = TL.cholesky(A, overwrite=True)
    assert mine.untyped_storage().data_ptr() == A.untyped_storage().data_ptr()
    assert torch.equal(mine, L)
    # a strided input is factored on a copy all the same
    S = A0.mT.contiguous().mT
    got = TL.cholesky(S, overwrite=True)
    assert got.untyped_storage().data_ptr() != S.untyped_storage().data_ptr()
    assert torch.equal(got, L) and torch.equal(S, A0)


def test_cholesky_under_autograd_takes_cholesky_ex_and_its_gradient():
    n = 1100
    m = _spd(9, q=2, n=n)
    A = _t(m).requires_grad_(True)
    before = (TL.cholesky.blocked, TL.cholesky.dense)
    L = TL.cholesky(A)
    assert (TL.cholesky.blocked, TL.cholesky.dense) == (before[0],
                                                        before[1] + 1)
    (g,) = torch.autograd.grad(TL.chol_logdet(L).sum(), A)

    def f(a):
        return jnp.sum(JL.chol_logdet(JL.cholesky(a)))
    import jax
    ref = np.asarray(jax.grad(f)(jnp.asarray(m)))
    # d logdet / dA = A^{-1}: torch hands it back symmetric, JAX's blocked
    # factor on the lower triangle that its panels read, so compare the
    # derivatives along symmetric directions, G + G^T - diag(G)
    def sym(G):
        return G + np.swapaxes(G, -1, -2) - G * np.eye(n)
    np.testing.assert_allclose(sym(g.numpy()), sym(ref), rtol=1e-9,
                               atol=1e-12)


@pytest.mark.parametrize('case', ['small', 'blocked', 'no_grad', 'grad'])
def test_cholesky_counts_its_path(case):
    n = 40 if case == 'small' else 1024
    A = _t(_spd(10, q=2, n=n)).requires_grad_(case in ('no_grad', 'grad'))
    before = (TL.cholesky.blocked, TL.cholesky.dense)
    with torch.set_grad_enabled(case != 'no_grad'):
        TL.cholesky(A)
    blocked = case in ('blocked', 'no_grad')
    assert (TL.cholesky.blocked - before[0],
            TL.cholesky.dense - before[1]) == ((1, 0) if blocked else (0, 1))
