"""lcgp_tpu_torch.ops.matern / ops.gram against lcgp_tpu's.

On the CPU the port's Gram functions run the plain PyTorch version, so the
same NumPy inputs must give the JAX package's stacks to rtol 1e-13 (the
same arithmetic; the slack covers exp's last-ulp differences).  The K1
kernel itself is held against the plain version on the card by
``tests/test_torch_gpu.py`` and ``chip_smoke.py``."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from lcgp_tpu.ops import gram as JG
from lcgp_tpu.ops import matern as JM
from lcgp_tpu_torch.ops import gram as TG
from lcgp_tpu_torch.ops import matern as TM

torch.set_num_threads(1)  # pytest -n workers share the host's cores

TOL = dict(rtol=1e-13, atol=1e-15)


def _t(a):
    return torch.as_tensor(np.asarray(a, dtype=np.float64))


def _inputs(seed, n1=23, n2=17, d=3, q=4):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 1, (n1, d)), rng.uniform(0, 1, (n2, d)),
            rng.uniform(0.1, 2.0, (q, d)), rng.uniform(0.5, 3.0, q),
            rng.uniform(1e-6, 0.1, q))


@pytest.mark.parametrize('same', [True, False])
@pytest.mark.parametrize('want_c0', [True, False])
def test_gram_matches_jax(same, want_c0):
    x1, x2, ls, amp, nug = _inputs(0)
    if same:
        x2 = x1
    got = TM.matern32_gram(_t(x1), _t(x2), _t(ls), _t(amp), _t(nug),
                           same=same, want_c0=want_c0)
    ref = JM.matern32_gram(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                           jnp.asarray(amp), jnp.asarray(nug), same=same,
                           want_c0=want_c0)
    if not want_c0:
        got, ref = (got,), (ref,)
    for a, b in zip(got, ref):
        assert a.dtype == torch.float64
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


@pytest.mark.parametrize('want_c0', [True, False])
def test_gram_factor_target_matches_jax(want_c0):
    x, _, ls, amp, nug = _inputs(1, n1=31)
    rng = np.random.default_rng(11)
    rs, dv = rng.uniform(0.1, 10, 4), rng.uniform(0.5, 2, (4, 31))
    got = TG.gram_factor_target(_t(x), _t(ls), _t(amp), _t(nug),
                                row_scale=_t(rs), diag_vec=_t(dv),
                                want_c0=want_c0)
    ref = JG.gram_factor_target(jnp.asarray(x), jnp.asarray(ls),
                                jnp.asarray(amp), jnp.asarray(nug),
                                row_scale=jnp.asarray(rs),
                                diag_vec=jnp.asarray(dv), want_c0=want_c0)
    if not want_c0:
        got, ref = (got,), (ref,)
    for a, b in zip(got, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), **TOL)


def test_gram_stack_matches_jax():
    x1, x2, ls, amp, nug = _inputs(2)
    got = TG.gram_stack(_t(x1), _t(x2), _t(ls), _t(amp), _t(nug), same=False)
    ref = JG.gram_stack(jnp.asarray(x1), jnp.asarray(x2), jnp.asarray(ls),
                        jnp.asarray(amp), jnp.asarray(nug), same=False)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)


def test_diag_matches_jax():
    _, _, _, amp, _ = _inputs(4)
    x0 = np.zeros((9, 3))
    np.testing.assert_array_equal(
        TM.matern32_diag(_t(x0), _t(amp)).numpy(),
        np.asarray(JM.matern32_diag(jnp.asarray(x0), jnp.asarray(amp))))


class TestPublicMatern32:
    def _args(self):
        rng = np.random.default_rng(5)
        return rng.uniform(0, 1, (12, 2)), np.array([0.3, 0.7]), 1.7, 0.05

    @pytest.mark.parametrize('mode', ['identity', 'equal_copy', 'cross',
                                      'forced_false'])
    def test_matches_jax(self, mode):
        x, ls, amp, nug = self._args()
        tx = _t(x)
        if mode == 'identity':
            a1, a2, j1, j2, kw = tx, tx, jnp.asarray(x), None, {}
            j2 = j1
        elif mode == 'equal_copy':
            a1, a2, j1, j2, kw = tx, tx.clone(), x, x.copy(), {}
        elif mode == 'cross':
            a1, a2, j1, j2, kw = tx, tx[:7], x, x[:7], {}
        else:
            a1, a2, j1, j2, kw = tx, tx, x, x, dict(same=False)
        got = TM.Matern32(a1, a2, ls, amp, nug, **kw)
        ref = JM.Matern32(j1, j2, ls, amp, nug, **kw)
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    def test_nugget_only_on_same(self):
        x, ls, amp, nug = self._args()
        same = TM.Matern32(_t(x), _t(x), ls, amp, nug)
        cross = TM.Matern32(_t(x), _t(x), ls, amp, nug, same=False)
        np.testing.assert_allclose(torch.diagonal(same).numpy(), amp,
                                   rtol=1e-15)
        np.testing.assert_allclose(torch.diagonal(cross).numpy(),
                                   amp * (1 - nug / (1 + nug)), rtol=1e-15)

    def test_diag_only(self):
        x, ls, amp, nug = self._args()
        out = TM.Matern32(_t(x), _t(x), ls, amp, nug, diag_only=True)
        np.testing.assert_array_equal(out.numpy(), np.full(12, amp))
        with pytest.raises(AssertionError):
            TM.Matern32(_t(x), _t(x) + 0.1, ls, amp, nug, diag_only=True)


@pytest.mark.parametrize('impl', ['jax gram', 'port plain gram',
                                  'port plain C0', 'port factor target'])
def test_same_point_gram_is_exactly_symmetric(impl):
    # K1 computes one triangle of a same-point Gram and mirrors it; that is
    # exact only because every form of the Gram is exactly symmetric
    x, _, ls, amp, nug = _inputs(8, n1=97, d=5, q=3)
    if impl == 'jax gram':
        g = np.asarray(JM.matern32_gram(jnp.asarray(x), jnp.asarray(x),
                                        jnp.asarray(ls), jnp.asarray(amp),
                                        jnp.asarray(nug), same=True))
    elif impl == 'port factor target':
        rng = np.random.default_rng(9)
        g = TG.gram_factor_target(
            _t(x), _t(ls), _t(amp), _t(nug),
            row_scale=_t(rng.uniform(0.1, 10, 3)),
            diag_vec=_t(rng.uniform(0.5, 2, (3, 97)))).numpy()
    else:
        c, c0 = TM.matern32_gram_plain(_t(x), _t(x), _t(ls), _t(amp),
                                       _t(nug), same=True, want_c0=True)
        g = (c if impl == 'port plain gram' else c0).numpy()
    assert g.shape == (3, 97, 97)
    np.testing.assert_array_equal(g, g.transpose(0, 2, 1))


def _vjp_by_pairs(x, ls, amp, nug, cbar):
    """The same-point Gram VJP summed over one triangle: i > j with
    cbar_ij + cbar_ji, and the diagonal once (C0 = 1, no lengthscale
    term), as K2 sums it."""
    i, j = np.tril_indices(x.shape[0], k=-1)
    s = np.abs(x[i] - x[j])[None] / ls[:, None, :]           # (q, pairs, d)
    c0 = np.prod(1 + s, axis=2) * np.exp(-s.sum(axis=2))     # (q, pairs)
    cb = cbar[:, i, j] + cbar[:, j, i]
    diag = np.trace(cbar, axis1=1, axis2=2)
    g0 = (cb * c0).sum(axis=1) + diag
    g2 = np.einsum('qp,qpd->qd', cb * c0, s * s / (1 + s))
    eta = nug / (1 + nug)
    return (amp[:, None] * (1 - eta)[:, None] * g2 / ls,
            (1 - eta) * g0 + eta * diag,
            amp * (diag - g0) / (1 + nug) ** 2)


@pytest.mark.parametrize('cotangent', ['non-symmetric', 'fused'])
def test_vjp_pairwise_triangle_sum_matches_jax(cotangent):
    # K2 sums one triangle with cbar_ij + cbar_ji: exact for any cotangent
    x, _, ls, amp, nug = _inputs(10, n1=97, d=5, q=3)
    rng = np.random.default_rng(10)
    M = rng.standard_normal((3, 97, 97))
    if cotangent == 'fused':
        w = rng.standard_normal((3, 97))
        alpha = rng.uniform(0.1, 5.0, 3)
        cbar = TM.fused_cotangent(_t(M), _t(alpha), -0.5, _t(w)).numpy()
    else:
        cbar = M
    got = _vjp_by_pairs(x, ls, amp, nug, cbar)
    ref = JM.matern32_gram_vjp(jnp.asarray(x), jnp.asarray(x),
                               jnp.asarray(ls), jnp.asarray(amp),
                               jnp.asarray(nug), same=True,
                               cbar=jnp.asarray(cbar))
    scale = TM.matern32_gram_vjp_scale(_t(x), _t(x), _t(ls), _t(amp),
                                       _t(nug), same=True, cbar=_t(cbar))
    for name, g, r, s in zip(('glens', 'gamp', 'gnug'), got, ref, scale):
        err = np.abs(g - np.asarray(r))
        assert np.all(err <= 1e-12 * s.numpy()), (
            f'{name}: max err/magnitude {np.max(err / s.numpy()):.3e}')


@pytest.mark.parametrize('edited', ['gram_common.cuh', 'gram_kernel.cuh',
                                    'gram_vjp_kernel.cuh',
                                    'matern32_gram.cu', 'rbf_gram_vjp.cu',
                                    'matern52_gram_kernel.cuh',
                                    'matern52_gram_vjp_kernel.cuh',
                                    'gram_vjp_x_kernel.cuh',
                                    'async_copy.cuh', 'tensor_map.cuh'])
def test_kernel_build_hash_covers_every_source(tmp_path, monkeypatch,
                                               edited):
    # every kernel is an instantiation of templates in shared headers:
    # editing any source must give a new build directory, so the library
    # is rebuilt
    import shutil
    from lcgp_tpu_torch.ops import _build
    csrc = tmp_path / 'csrc'
    shutil.copytree(_build.CSRC_DIR, csrc)
    assert (csrc / edited).exists()
    monkeypatch.setattr(_build, 'CSRC_DIR', csrc)
    before = _build._source_hash()
    with open(csrc / edited, 'a') as f:
        f.write('\n// edited\n')
    assert _build._source_hash() != before


def test_cpu_call_does_not_launch():
    x, _, ls, amp, nug = _inputs(6)
    before = TM.matern32_gram.launches
    TM.matern32_gram(_t(x), _t(x), _t(ls), _t(amp), _t(nug), same=True)
    TG.gram_factor_target(_t(x), _t(ls), _t(amp), _t(nug),
                          row_scale=_t(amp), diag_vec=torch.ones(4, 23,
                                                                 dtype=torch.float64))
    assert TM.matern32_gram.launches == before


def test_kernel_launcher_refuses_cpu_tensors():
    x, _, ls, amp, nug = _inputs(7)
    with pytest.raises(ValueError, match='expected CUDA tensors'):
        TM.launch_matern32(_t(x), _t(x), _t(ls), _t(amp), _t(nug), same=True)
