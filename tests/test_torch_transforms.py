"""lcgp_tpu_torch transforms and basis against lcgp_tpu's.

Same NumPy inputs through both; the arithmetic is the same, so the
tolerance is 1e-15."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lcgp_tpu.models import basis as JB
from lcgp_tpu.models import transforms as JT
from lcgp_tpu_torch.models import basis as TB
from lcgp_tpu_torch.models import transforms as TT

torch.set_num_threads(1)  # pytest -n workers share the host's cores

TOL = dict(rtol=1e-15, atol=1e-15)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def test_standardize_x_matches_jax():
    x = np.random.default_rng(0).uniform(-3, 5, (40, 3))
    for a, b in zip(TT.standardize_x(_t(x)), JT.standardize_x(jnp.asarray(x))):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize('robust', [True, False])
@pytest.mark.parametrize('n', [40, 41])      # even n: median interpolates
@pytest.mark.parametrize('floor', [True, False])
def test_center_spread_matches_jax(robust, n, floor):
    y = np.random.default_rng(n).normal(2.0, 3.0, (5, n))
    y[2] = 1.5      # a constant row: zero spread, floored or not
    got = TT.center_spread(_t(y), robust, floor_zero_spread=floor)
    ref = JT.center_spread(jnp.asarray(y), robust, floor_zero_spread=floor)
    for a, b in zip(got, ref):
        assert a.shape == (5, 1)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_median_is_interpolated_not_lower():
    # torch.median returns the lower middle element of an even-length row;
    # jnp.percentile(50) (and the port) interpolate
    y = _t([[1.0, 2.0, 3.0, 10.0]])
    c, _ = TT.center_spread(y, robust=True)
    assert float(c) == 2.5
    assert float(torch.median(y)) == 2.0


@pytest.mark.parametrize('robust', [True, False])
def test_standardize_y_matches_jax(robust):
    y = np.random.default_rng(1).normal(0, 2, (6, 64))
    got = TT.standardize_y(_t(y), robust)
    ref = JT.standardize_y(jnp.asarray(y), robust)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_xnorm_matches_jax():
    x = np.random.default_rng(2).uniform(0, 1, (30, 2))
    np.testing.assert_allclose(TT.xnorm(x, block=7), JT.xnorm(x, block=7),
                               **TOL)


@pytest.mark.parametrize('q,thr', [(3, None), (None, 0.9), (None, None)])
def test_basis_matches_jax(q, thr):
    y = np.random.default_rng(3).normal(0, 1, (6, 50))
    got = TB.init_phi(y, q=q, var_threshold=thr)
    ref = JB.init_phi(y, q=q, var_threshold=thr)
    assert got.q == ref.q
    for name in ('phi', 'diag_D', 'g', 'g_var'):
        np.testing.assert_allclose(getattr(got, name), getattr(ref, name),
                                   **TOL)
