"""lcgp_tpu_torch.models.params against lcgp_tpu.models.params.

Same inputs (NumPy, from a seed) through both; the arithmetic is the same,
so the tolerance is 1e-15 (relative, with an equal absolute floor for
values near zero)."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lcgp_tpu.models import params as JP
from lcgp_tpu_torch.models import params as TP

torch.set_num_threads(1)  # pytest -n workers share the host's cores

TOL = dict(rtol=1e-15, atol=1e-15)
# The SoftClip inverse subtracts log1p(-exp(.)) terms that nearly cancel
# near the clip ends; XLA's and PyTorch's exp/log1p differ by an ulp, and
# the cancellation amplifies that to ~1e-14 relative.
INV_TOL = dict(rtol=1e-13, atol=1e-15)
CLIPS = ['LLMB_CLIP', 'LLMB0_CLIP', 'LNUG_CLIP']


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _np(a):
    return a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


@pytest.mark.parametrize('name', CLIPS)
def test_softclip_forward_matches_jax(name):
    # spans the fitted config-4 extremes (free lLmb reaches -1818)
    x = np.concatenate([np.linspace(-2000, 2000, 401),
                        np.random.default_rng(0).normal(0, 10, 200)])
    got = getattr(TP, name).forward(_t(x))
    ref = getattr(JP, name).forward(jnp.asarray(x))
    np.testing.assert_allclose(_np(got), _np(ref), **TOL)


@pytest.mark.parametrize('name', CLIPS)
def test_softclip_inverse_matches_jax(name):
    clip = getattr(TP, name)
    y = clip.low + (clip.high - clip.low) * np.linspace(1e-6, 1 - 1e-6, 301)
    got = clip.inverse(_t(y))
    ref = getattr(JP, name).inverse(jnp.asarray(y))
    np.testing.assert_allclose(_np(got), _np(ref), **INV_TOL)


def test_softplus_exact_across_torch_threshold():
    # torch.nn.functional.softplus switches to x above 20; the port must not
    x = np.linspace(15.0, 40.0, 251)
    got = TP.softplus(_t(x))
    np.testing.assert_allclose(_np(got), _np(jax.nn.softplus(jnp.asarray(x))),
                               **TOL)
    # the threshold's error is real: it is what the port avoids
    thr = torch.nn.functional.softplus(_t([25.0]))
    assert abs(float(thr[0]) - float(jax.nn.softplus(25.0))) > 1e-12


def _free(seed, q=3, d=2, g=4):
    rng = np.random.default_rng(seed)
    return (rng.normal(0, 3, (q, d)), rng.normal(0, 3, q),
            rng.normal(-2, 1, g), rng.normal(-9, 3, q))


@pytest.mark.parametrize('seed', [0, 1])
def test_constrain_matches_jax(seed):
    vals = _free(seed)
    got = TP.constrain(TP.FreeParams(*map(_t, vals)))
    ref = JP.constrain(JP.FreeParams(*map(jnp.asarray, vals)))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(b), **TOL)


def test_unconstrain_matches_jax():
    rng = np.random.default_rng(2)
    vals = (rng.uniform(0.01, 10, (3, 2)), rng.uniform(0.1, 100, 3),
            rng.normal(-2, 1, 4), rng.uniform(1e-6, 0.1, 3))
    got = TP.unconstrain(*map(_t, vals))
    ref = JP.unconstrain(*map(jnp.asarray, vals))
    for a, b in zip(got, ref):
        np.testing.assert_allclose(_np(a), _np(b), **INV_TOL)


@pytest.mark.parametrize('err', [[1, 1, 1], [2, 1, 3]])
def test_sigma_map_and_expand(err):
    idx = TP.sigma_index_map(err, 'cpu')
    assert idx.dtype == torch.int64
    np.testing.assert_array_equal(_np(idx), JP.sigma_index_map(err))
    lsig = np.random.default_rng(3).normal(size=len(err))
    np.testing.assert_array_equal(
        _np(TP.expand_sigma(_t(lsig), idx)),
        _np(JP.expand_sigma(jnp.asarray(lsig), JP.sigma_index_map(err))))


@pytest.mark.parametrize('err', [[1, 1, 1, 1], [2, 2]])
def test_init_values_match_jax(err):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (50, 3))
    y = rng.standard_normal((4, 50)) * 2.0
    got = TP.init_values(x, y, 2, err, 'cpu')
    ref = JP.init_values(x, y, 2, err)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64 and a.is_contiguous()
        np.testing.assert_allclose(_np(a), _np(b), **TOL)
