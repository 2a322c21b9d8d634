"""lcgp_tpu_torch.ops.mixed and the structured triangular products of
lcgp_tpu_torch.ops.linalg against lcgp_tpu's, on the CPU.

Tolerances, stated per comparison:

- the structured products (syrk, Gram, trmm, block-lower, lower x lower)
  sum the same products in another order than XLA: each result within
  n eps of its largest entry (eps of the dtype; n = 1100 gives 2.4e-13 in
  f64, 1.3e-4 in f32), far inside which a wrong block or a lost pad would
  fall;
- ``cholesky_mixed`` at 1 step: within 10 eps32^2 cond(B) of the f64
  Cholesky (the one-step contraction), both packages; at 2 and 3 steps
  within 1e-12 of it, the f64 floor at these conditionings, and of
  lcgp_tpu's refined factor;
- the refined solve: rtol 1e-12 (f64 floor); the inverses' f32 seed
  (newton_steps=0): n eps32 cond of the largest entry; after 2 Newton
  steps the seed's error squared twice, within 1e-11 of the f64 inverse.

n = 1100, q = 1 takes the 512-blocked, zero-padded branch in both packages
(n >= 1024, n % 512 != 0): the products in f64 and f32 and a 2-step
``cholesky_mixed``; the port's triangular inverse is blocked there with a
narrower last block (the JAX package's is its solve), and at n = 1024 both
are blocked.  n = 300 (the dense fallback) covers every refinement and
inverse variant.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lcgp_tpu.ops import linalg as JL
from lcgp_tpu.ops import mixed as JM
from lcgp_tpu_torch.ops import linalg as TL
from lcgp_tpu_torch.ops import mixed as TM

torch.set_num_threads(1)  # pytest -n workers share the host's cores

EPS32 = float(np.finfo(np.float32).eps)
EPS64 = float(np.finfo(np.float64).eps)


def _spd_target(seed, q, n):
    """B = D C + I with C a Matérn-like PSD Gram (exp(-|x_i - x_j|) on
    random 1-d points), the shape of the loss's factorization target."""
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (q, n))
    C = np.exp(-np.abs(x[:, :, None] - x[:, None, :]) / 0.3)
    D = rng.uniform(0.5, 3.0, q)
    return D[:, None, None] * C + np.eye(n)


def _lower(seed, q, n):
    """A well-conditioned lower-triangular factor."""
    return np.linalg.cholesky(_spd_target(seed, q, n))


def _cond(B):
    ev = np.linalg.eigvalsh(B)
    return float(np.max(ev[..., -1] / ev[..., 0]))


def _normwise(got, ref, tol):
    got, ref = np.asarray(got, dtype=np.float64), np.asarray(ref,
                                                            dtype=np.float64)
    err = np.max(np.abs(got - ref))
    assert err <= tol * np.max(np.abs(ref)), (err, tol * np.max(np.abs(ref)))


def _t(a, dtype=torch.float64):
    return torch.as_tensor(np.asarray(a)).to(dtype)


def _j(a, dtype=jnp.float64):
    return jnp.asarray(np.asarray(a), dtype=dtype)


# ---------------------------------------------------------------------------
# the structured products
# ---------------------------------------------------------------------------

SHAPES = [(2, 300), (1, 1100)]
DTYPES = [(torch.float64, jnp.float64, EPS64),
          (torch.float32, jnp.float32, EPS32)]


@pytest.mark.parametrize('q,n', SHAPES)
@pytest.mark.parametrize('tdt,jdt,eps', DTYPES)
@pytest.mark.parametrize('name', ['syrk_tri_lower', 'gram_tri_lower'])
def test_symmetric_products_match_jax(name, q, n, tdt, jdt, eps):
    L = _lower(1, q, n)
    got = getattr(TL, name)(_t(L, tdt))
    ref = getattr(JL, name)(_j(L, jdt))
    assert got.dtype == tdt and got.shape == (q, n, n)
    _normwise(got.numpy(), ref, n * eps)
    # exactly symmetric, as the JAX assembly is
    assert torch.equal(got, got.mT)


@pytest.mark.parametrize('q,n', SHAPES)
@pytest.mark.parametrize('tdt,jdt,eps', DTYPES)
def test_trmm_lower_matches_jax(q, n, tdt, jdt, eps):
    L = _lower(2, q, n)
    X = np.random.default_rng(3).standard_normal((q, n, n))
    got = TL.trmm_lower(_t(L, tdt), _t(X, tdt))
    _normwise(got.numpy(), JL.trmm_lower(_j(L, jdt), _j(X, jdt)), n * eps)


@pytest.mark.parametrize('q,n', SHAPES)
@pytest.mark.parametrize('tdt,jdt,eps', DTYPES)
def test_mul_t_block_lower_matches_jax_on_its_lower_triangle(q, n, tdt, jdt,
                                                             eps):
    M = _lower(4, q, n)
    Y = np.random.default_rng(5).standard_normal((q, n, n))
    got = TL.mul_t_block_lower(_t(Y, tdt), _t(M, tdt)).numpy()
    ref = np.asarray(JL.mul_t_block_lower(_j(Y, jdt), _j(M, jdt)))
    # the contract: only the lower triangle is specified
    il = np.tril_indices(n)
    _normwise(got[:, il[0], il[1]], ref[:, il[0], il[1]], n * eps)
    _normwise(np.tril(got), np.tril(Y @ np.swapaxes(M, -1, -2)), n * eps)
    if n > 1024:
        # the blocked path leaves the strict block-upper region zero
        assert not got[:, :512, 512:].any()


@pytest.mark.parametrize('q,n', SHAPES)
@pytest.mark.parametrize('tdt,jdt,eps', DTYPES)
def test_mul_lower_lower_matches_jax(q, n, tdt, jdt, eps):
    A, B = _lower(6, q, n), _lower(7, q, n)
    got = TL.mul_lower_lower(_t(A, tdt), _t(B, tdt)).numpy()
    _normwise(got, JL.mul_lower_lower(_j(A, jdt), _j(B, jdt)), n * eps)
    assert not np.triu(got, 1).any()


@pytest.mark.parametrize('q,n,tdt,jdt,eps', [
    (2, 300, torch.float64, jnp.float64, EPS64),
    (1, 1100, torch.float64, jnp.float64, EPS64),
    (2, 1024, torch.float64, jnp.float64, EPS64),
    (2, 1024, torch.float32, jnp.float32, EPS32),
    (1, 1100, torch.float32, jnp.float32, EPS32)],
    ids=['2-300', '1-1100', '2-1024', '2-1024-f32', '1-1100-f32'])
def test_tri_inverse_lower_matches_jax(q, n, tdt, jdt, eps):
    # the port's blocked inverse from n = 1024 (a narrower last block at
    # 1100), its solve below; the JAX package's blocked inverse
    # (n % 512 == 0) or its solve
    L = _lower(8, q, n)
    got = TL.tri_inverse_lower(_t(L, tdt))
    assert got.dtype == tdt and not torch.triu(got, 1).any()
    _normwise(got.numpy(), JL.tri_inverse_lower(_j(L, jdt)), n * eps)
    _normwise((got.double() @ _t(L)).numpy(),
              np.broadcast_to(np.eye(n), (q, n, n)), n * eps)


def test_pad_helpers_match_jax():
    A = np.random.default_rng(9).standard_normal((2, 5, 5))
    np.testing.assert_array_equal(TL._pad_nn(_t(A), 8).numpy(),
                                  np.asarray(JL._pad_nn(_j(A), 8)))
    assert [TL._next_mult(n, 512) for n in (1, 512, 513, 1100)] == \
        [JL._next_mult(n, 512) for n in (1, 512, 513, 1100)]
    S = np.tril(np.random.default_rng(10).standard_normal((1, 8, 8)))
    S[:, 0:4, 0:4] = S[:, 0:4, 0:4] + np.swapaxes(S[:, 0:4, 0:4], -1, -2)
    S[:, 4:8, 4:8] = S[:, 4:8, 4:8] + np.swapaxes(S[:, 4:8, 4:8], -1, -2)
    S[:, 0:4, 4:8] = 0.0
    np.testing.assert_array_equal(
        TL._sym_from_block_lower(_t(S), 2, 4).numpy(),
        np.asarray(JL._sym_from_block_lower(_j(S), 2, 4)))


# ---------------------------------------------------------------------------
# ops/mixed
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('cd', [None, 'mixed', 'mixed:3', 'mixed:5',
                                'fast', torch.float32])
def test_parse_refine_matches_jax(cd):
    jcd = jnp.float32 if cd is torch.float32 else cd
    assert TM.parse_refine(cd) == JM.parse_refine(jcd)
    assert TM.is_mixed(cd) == JM.is_mixed(jcd)
    assert TM.DEFAULT_REFINE_STEPS == JM.DEFAULT_REFINE_STEPS


def test_phi_lower_matches_jax():
    X = np.random.default_rng(11).standard_normal((3, 7, 7))
    np.testing.assert_array_equal(TM._phi_lower(_t(X)).numpy(),
                                  np.asarray(JM._phi_lower(_j(X))))


@pytest.mark.parametrize('q,n,steps', [(2, 300, 1), (2, 300, 2),
                                        (2, 300, 3), (1, 1100, 2)])
def test_cholesky_mixed_matches_jax(q, n, steps):
    B = _spd_target(12, q, n)
    got = TM.cholesky_mixed(_t(B), refine_steps=steps, seed_jitter=1e-6)
    ref = JM.cholesky_mixed(_j(B), refine_steps=steps, seed_jitter=1e-6)
    L64 = np.linalg.cholesky(B)
    assert got.dtype == torch.float64
    tol = 10 * EPS32 ** 2 * _cond(B) if steps == 1 else 1e-12
    _normwise(got.numpy(), L64, tol)
    _normwise(ref, L64, tol)
    _normwise(got.numpy(), ref, 2 * tol)


@pytest.mark.parametrize('q,n,steps', [(2, 300, 1), (2, 300, 2),
                                        (2, 300, 3)])
def test_cho_solve_vec_refined_matches_jax(q, n, steps):
    B = _spd_target(13, q, n)
    v = np.random.default_rng(14).standard_normal((q, n))
    L = TM.cholesky_mixed(_t(B), refine_steps=2)
    got = TM.cho_solve_vec_refined(L, _t(B), _t(v), refine_steps=steps)
    ref = JM.cho_solve_vec_refined(_j(L.numpy()), _j(B), _j(v),
                                   refine_steps=steps)
    exact = np.linalg.solve(B, v[..., None])[..., 0]
    # each step contracts the error by ~eps32 cond from the f32 solve's
    tol = max((EPS32 * _cond(B)) ** (steps + 1), 1e-12)
    _normwise(got.numpy(), exact, tol)
    _normwise(got.numpy(), ref, 2 * tol)


@pytest.mark.parametrize('newton_steps', [0, 2])
@pytest.mark.parametrize('q,n', [(2, 300)])
def test_inverses_match_jax(q, n, newton_steps):
    B = _spd_target(15, q, n)
    L = TM.cholesky_mixed(_t(B), refine_steps=2)
    exact = np.linalg.inv(B)
    tol = n * EPS32 * _cond(B) if newton_steps == 0 else 1e-11
    got = TM.chol_inverse_from_factor_mixed(L, newton_steps=newton_steps)
    ref = JM.chol_inverse_from_factor_mixed(_j(L.numpy()),
                                            newton_steps=newton_steps)
    assert got.dtype == torch.float64
    _normwise(got.numpy(), exact, tol)
    _normwise(got.numpy(), ref, 2 * tol)
    got = TM.chol_inverse_mixed(_t(B), newton_steps=newton_steps)
    ref = JM.chol_inverse_mixed(_j(B), newton_steps=newton_steps)
    _normwise(got.numpy(), exact, tol)
    _normwise(got.numpy(), ref, 2 * tol)
    # the seed from a given factor equals the f32 potri of its cast
    if newton_steps == 0:
        seed = TL.chol_inverse(L.to(torch.float32))
        np.testing.assert_array_equal(
            TM.chol_inverse_from_factor_mixed(L, newton_steps=0).numpy(),
            seed.double().numpy())
