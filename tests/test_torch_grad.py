"""The port's loss gradient against lcgp_tpu's ``jax.grad``.

Same inputs (NumPy, from a seed) through both packages, on the CPU in
float64.  Stated tolerances:

- the Gram VJP: the difference in each output is at most 1e-12 times the
  sum of the magnitudes of its terms (``matern32_gram_vjp_scale``), which
  is rtol 1e-12 without the cancellation of a sum of both signs;
- the gradient of ``neglpost_full``: at most 1e-9 of the leaf's max |g|,
  per leaf; the value rtol 1e-10;
- ``chol_inverse`` rtol 1e-10 of the largest entry, ``quad_chol`` rtol
  1e-12.
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
from lcgp_tpu.ops import linalg as JL
from lcgp_tpu.ops import matern as JM
import lcgp_tpu_torch
from lcgp_tpu_torch import convert
from lcgp_tpu_torch.models import likelihood as TLik
from lcgp_tpu_torch.models import params as TP
from lcgp_tpu_torch.ops import linalg as TL
from lcgp_tpu_torch.ops import matern as TM

torch.set_num_threads(1)  # pytest -n workers share the host's cores

VJP_BOUND = 1e-12
GRAD_RTOL = 1e-9
LOSS_RTOL = 1e-10


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _t(a):
    return torch.as_tensor(np.array(a, dtype=np.float64))


def _problem(seed, n=120, d=3, p=10):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, -1:].T)
         + 0.05 * rng.standard_normal((p, n)))
    return x, y


def _fitted_like(jm, seed):
    rng = np.random.default_rng(seed)
    q, d = int(jm.q), int(jm.d)
    jm.set_params(lLmb=rng.uniform(0.2, 1.5, (q, d)),
                  lLmb0=rng.uniform(0.5, 3.0, q),
                  lnugGPs=rng.uniform(1e-6, 1e-3, q),
                  lsigma2s=np.asarray(jm.lsigma2s) - 1.0)


def _data_of(jm):
    d = jm._data
    return convert.full_data_from_numpy(d.xs, d.ys, d.phi, d.diag_D,
                                        d.sigma_map, 'cpu')


def _port_grad(free_np, data, **kw):
    free = TP.FreeParams(*(_t(v).requires_grad_(True) for v in free_np))
    v = TLik.neglpost_full(free, data, **kw)
    return v, torch.autograd.grad(v, free)


def _jax_grad(free_np, data, **kw):
    free = JP.FreeParams(*(jnp.asarray(v) for v in free_np))
    return jax.value_and_grad(JLik.neglpost_full)(free, data, **kw)


def _assert_grads_close(got, ref):
    for name, g, r in zip(JP.FreeParams._fields, got, ref):
        g, r = _np(g), _np(r)
        err = np.max(np.abs(g - r))
        assert err <= GRAD_RTOL * np.max(np.abs(r)), (name, err)


@pytest.fixture(scope='module')
def jm():
    """JAX model at n=120, d=3, p=10, q=4, moved off its init."""
    x, y = _problem(0)
    m = lcgp_tpu.LCGP(y, x, q=4)
    _fitted_like(m, 1)
    return m


# ---------------------------------------------------------------------------
# SoftClip: a value exactly on a bound takes JAX's half gradient
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('name', ['LLMB_CLIP', 'LLMB0_CLIP', 'LNUG_CLIP'])
def test_softclip_tie_gradient_matches_jax(name):
    # -219 (and -240) from the low end round onto the bound exactly while
    # the softplus gradient e^-219 is still a normal number; +40 past the
    # high end of the amplitude clip rounds onto 1e4
    clip = getattr(TP, name)
    x = np.array([clip.low - 219.0, clip.low - 240.0, clip.high + 40.0,
                  0.5 * (clip.low + clip.high), clip.low - 3.0])
    xt = _t(x).requires_grad_(True)
    y = clip.forward(xt)
    (g,) = torch.autograd.grad(y.sum(), xt)
    jclip = getattr(JP, name)
    ref = jax.grad(lambda v: jnp.sum(jclip.forward(v)))(jnp.asarray(x))
    np.testing.assert_array_equal(_np(y), np.asarray(jclip.forward(
        jnp.asarray(x))))
    assert _np(y)[0] == clip.low          # a tie, as at fitted config 4
    np.testing.assert_allclose(_np(g), np.asarray(ref), rtol=1e-13, atol=0)


# ---------------------------------------------------------------------------
# the Gram VJP (the plain side of K2)
# ---------------------------------------------------------------------------


def _vjp_inputs(seed, n1, n2, d, q):
    rng = np.random.default_rng(seed)
    x1 = rng.uniform(0, 1, (n1, d))
    x2 = x1 if n1 == n2 else rng.uniform(0, 1, (n2, d))
    cbar = rng.standard_normal((q, n1, n2))
    if n1 == n2:
        cbar = cbar + cbar.transpose(0, 2, 1)
    return (x1, x2, rng.uniform(0.2, 2.0, (q, d)), rng.uniform(0.5, 3.0, q),
            rng.uniform(1e-6, 0.1, q), cbar)


def _assert_vjp_close(got, ref, scale):
    for name, g, r, s in zip(('glens', 'gamp', 'gnug'), got, ref, scale):
        err = np.abs(_np(g) - _np(r))
        assert np.all(err <= VJP_BOUND * _np(s)), (name, err.max())


@pytest.mark.parametrize('same', [True, False])
@pytest.mark.parametrize('with_c0', [True, False])
def test_matern32_gram_vjp_plain_matches_jax(same, with_c0):
    n2 = 60 if same else 45
    x1, x2, ls, amp, nug, cbar = _vjp_inputs(7, 60, n2, 3, 4)
    tx = [_t(a) for a in (x1, x2, ls, amp, nug)]
    c0 = c0j = None
    if with_c0:
        _, c0 = TM.matern32_gram_plain(*tx, same=same, want_c0=True)
        _, c0j = JM.matern32_gram(x1, x2, ls, amp, nug, same=same,
                                  want_c0=True)
    got = TM.matern32_gram_vjp_plain(*tx, same=same, cbar=_t(cbar), c0=c0)
    ref = JM.matern32_gram_vjp(x1, x2, ls, amp, nug, same=same,
                               cbar=jnp.asarray(cbar), c0=c0j)
    scale = TM.matern32_gram_vjp_scale(*tx, same=same, cbar=_t(cbar))
    _assert_vjp_close(got, ref, scale)
    # the CPU dispatch of the kernel wrapper is the plain version
    before = TM.matern32_gram_vjp.launches
    same_again = TM.matern32_gram_vjp(*tx, same=same, cbar=_t(cbar), c0=c0)
    assert TM.matern32_gram_vjp.launches == before
    for a, b in zip(same_again, got):
        assert torch.equal(a, b)


def test_fused_vjp_matches_jax_cotangent_composition():
    """The loss's cotangent 0.5 D B^{-1} - 0.5 w w^T formed as JAX forms it
    (likelihood.py:231-236) against the port's fused entry."""
    rng = np.random.default_rng(8)
    n, d, q = 50, 2, 3
    x = rng.uniform(0, 1, (n, d))
    ls, amp = rng.uniform(0.2, 1.5, (q, d)), rng.uniform(0.5, 3.0, q)
    nug, D = rng.uniform(1e-6, 1e-3, q), rng.uniform(0.5, 20.0, q)
    a = rng.standard_normal((q, n))
    B = JG.gram_factor_target(x, ls, amp, nug, row_scale=D,
                              diag_vec=np.ones((q, n)))
    Binv = np.asarray(JL.chol_inverse(JL.cholesky(B)))
    w = np.einsum('qij,qj->qi', Binv, a)
    cbar0 = 0.5 * D[:, None, None] * Binv - 0.5 * w[:, :, None] * w[:, None, :]
    ref = JG.gram_vjp(x, x, ls, amp, nug, same=True, cbar=jnp.asarray(cbar0))
    tx = [_t(v) for v in (x, ls, amp, nug)]
    got = TM.matern32_gram_vjp_fused(*tx, M=_t(Binv), alpha=_t(0.5 * D),
                                     beta=-0.5, w=_t(w))
    scale = TM.matern32_gram_vjp_scale(tx[0], *tx, same=True, cbar=_t(cbar0))
    _assert_vjp_close(got, ref, scale)
    np.testing.assert_array_equal(
        _np(TM.fused_cotangent(_t(Binv), _t(0.5 * D), -0.5, _t(w))), cbar0)


@pytest.mark.parametrize('kind,err', [('matern32', None),
                                      ('rbf', None),
                                      ('matern52', None),
                                      ('nope', ValueError)])
def test_gram_vjp_matches_jax(kind, err):
    from lcgp_tpu_torch.ops import gram as TG
    from lcgp_tpu_torch.ops import matern52, rbf
    scale_fn = {'matern32': TM.matern32_gram_vjp_scale,
                'matern52': matern52.matern52_gram_vjp_scale,
                'rbf': rbf.rbf_gram_vjp_scale}.get(kind)
    x1, x2, ls, amp, nug, cbar = _vjp_inputs(13, 30, 21, 2, 3)
    tx = [_t(a) for a in (x1, x2, ls, amp, nug)]
    if err is not None:
        with pytest.raises(err):
            TG.gram_vjp(*tx, same=False, cbar=_t(cbar), kind=kind)
        with pytest.raises(err):
            TG.gram_vjp_fused(tx[0], *tx[2:], M=_t(cbar[:, :, :30]),
                              alpha=tx[3], beta=-0.5, w=tx[3], kind=kind)
        return
    got = TG.gram_vjp(*tx, same=False, cbar=_t(cbar), kind=kind)
    ref = JG.gram_vjp(x1, x2, ls, amp, nug, same=False,
                      cbar=jnp.asarray(cbar), kind=kind)
    _assert_vjp_close(got, ref, scale_fn(*tx, same=False, cbar=_t(cbar)))


@pytest.mark.parametrize('same', [True, False])
def test_vjp_scale_bounds_every_term(same):
    n2 = 40 if same else 33
    x1, x2, ls, amp, nug, cbar = _vjp_inputs(9, 40, n2, 2, 3)
    tx = [_t(a) for a in (x1, x2, ls, amp, nug)]
    scale = TM.matern32_gram_vjp_scale(*tx, same=same, cbar=_t(cbar))
    signed = TM.matern32_gram_vjp_plain(*tx, same=same, cbar=_t(cbar))
    for s, g in zip(scale, signed):
        assert bool((s >= g.abs()).all())
    # with a positive cotangent and no diagonal, nothing cancels in glens
    # and gamp: the scale is the VJP itself
    pos = _t(np.abs(cbar))
    if not same:
        for s, g in zip(TM.matern32_gram_vjp_scale(*tx, same=False, cbar=pos)[:2],
                        TM.matern32_gram_vjp_plain(*tx, same=False,
                                                   cbar=pos)[:2]):
            torch.testing.assert_close(s, g, rtol=1e-15, atol=0)


# ---------------------------------------------------------------------------
# the gradient of neglpost_full
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('q_chunk', [None, 2])
def test_neglpost_full_grad_matches_jax(jm, q_chunk):
    free_np = [np.asarray(v) for v in jm._free]
    v, g = _port_grad(free_np, _data_of(jm), q_chunk=q_chunk)
    vj, gj = _jax_grad(free_np, jm._data, q_chunk=q_chunk)
    np.testing.assert_allclose(_np(v), np.asarray(vj), rtol=LOSS_RTOL)
    _assert_grads_close(g, gj)


def test_neglpost_full_grad_at_n1100_matches_jax():
    """n >= 1024 sends the JAX side through its blocked f64 Cholesky and
    its fused factor+inverse flow (lcgp_tpu/ops/linalg.py)."""
    x, y = _problem(2, n=1100, d=2, p=3)
    m = lcgp_tpu.LCGP(y, x, q=2)
    _fitted_like(m, 3)
    free_np = [np.asarray(v) for v in m._free]
    v, g = _port_grad(free_np, _data_of(m))
    vj, gj = _jax_grad(free_np, m._data)
    np.testing.assert_allclose(_np(v), np.asarray(vj), rtol=LOSS_RTOL)
    _assert_grads_close(g, gj)


def test_neglpost_full_grad_with_softclip_ties_matches_jax(jm):
    """Free values that put one lengthscale, one amplitude and one nugget
    exactly on their SoftClip floors, as fitted config 4 has them.  Beside
    the per-leaf bound, the tied entries must match elementwise: there the
    gradient is JAX's half of torch.clamp's."""
    free_np = [np.array(v) for v in jm._free]
    free_np[0][0, 1] = TP.LLMB_CLIP.low - 219.0
    free_np[1][2] = TP.LLMB0_CLIP.low - 219.0
    free_np[3][1] = TP.LNUG_CLIP.low - 219.0
    lLmb, lLmb0, _, lnug = TP.constrain(TP.FreeParams(*map(_t, free_np)))
    assert float(lLmb[0, 1]) == TP.LLMB_CLIP.low
    assert float(lLmb0[2]) == TP.LLMB0_CLIP.low
    assert float(lnug[1]) == TP.LNUG_CLIP.low
    v, g = _port_grad(free_np, _data_of(jm))
    vj, gj = _jax_grad(free_np, jm._data)
    np.testing.assert_allclose(_np(v), np.asarray(vj), rtol=LOSS_RTOL)
    _assert_grads_close(g, gj)
    for leaf, idx in ((1, (2,)), (3, (1,))):
        got, ref = _np(g[leaf])[idx], np.asarray(gj[leaf])[idx]
        assert ref != 0.0
        np.testing.assert_allclose(got, ref, rtol=1e-9, atol=0)


def test_full_terms_gradcheck():
    """torch.autograd.gradcheck of the autograd.Function at n=12, q=2,
    d=2: its analytic backward against finite differences of its forward,
    in every differentiable input."""
    rng = np.random.default_rng(10)

    def t(a, grad=False):
        return _t(a).requires_grad_(grad)
    xs, D = t(rng.uniform(0, 1, (12, 2))), t(rng.uniform(0.5, 3.0, 2))
    args = (t(rng.uniform(0.3, 1.0, (2, 2)), True),
            t(rng.uniform(0.5, 2.0, 2), True),
            t(rng.uniform(1e-4, 1e-2, 2), True),
            t(rng.standard_normal((2, 12)), True))

    def terms(ls, amp, nug, a):
        return TLik._FullTerms.apply(None, 0.0, 'matern32', xs, ls, amp, nug,
                                     D, a)
    assert torch.autograd.gradcheck(terms, args, eps=1e-6, atol=1e-8,
                                    rtol=1e-6)


@pytest.mark.parametrize('q_chunk', [None, 2])
def test_loss_without_grad_does_no_gradient_work(jm, q_chunk, monkeypatch):
    calls = {'inv': 0, 'vjp': 0}
    real_inv, real_vjp = TL.chol_inverse, TLik.gram_vjp_fused

    def inv(*a, **k):
        calls['inv'] += 1
        return real_inv(*a, **k)

    def vjp(*a, **k):
        calls['vjp'] += 1
        return real_vjp(*a, **k)
    monkeypatch.setattr(TLik.linalg, 'chol_inverse', inv)
    monkeypatch.setattr(TLik, 'gram_vjp_fused', vjp)
    tm = lcgp_tpu_torch.LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig),
                             q=4, q_chunk=q_chunk, device='cpu')
    tm.loss()
    free = TP.FreeParams(*(v.clone().requires_grad_(True) for v in tm.free))
    with torch.no_grad():
        TLik.neglpost_full(free, tm._data, q_chunk=q_chunk)
    # only the noise variances want a gradient: -C w, no B^{-1}, no VJP
    only_sigma = free._replace(lLmb=free.lLmb.detach(),
                               lLmb0=free.lLmb0.detach(),
                               lnugGPs=free.lnugGPs.detach())
    v = TLik.neglpost_full(only_sigma, tm._data, q_chunk=q_chunk)
    (gs,) = torch.autograd.grad(v, only_sigma.lsigma2s)
    assert calls == {'inv': 0, 'vjp': 0}
    v = TLik.neglpost_full(free, tm._data, q_chunk=q_chunk)
    g = torch.autograd.grad(v, free)
    chunks = 2 if q_chunk else 1
    assert calls == {'inv': chunks, 'vjp': chunks}
    torch.testing.assert_close(gs, g[2], rtol=1e-14, atol=0)


# ---------------------------------------------------------------------------
# linalg, and make_loss
# ---------------------------------------------------------------------------


def _spd(seed, q, n):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((q, n, n))
    return a @ a.transpose(0, 2, 1) / n + np.eye(n)


@pytest.mark.parametrize('n,q', [(40, 2), (1100, 2), (1024, 3)],
                         ids=['40', '1100', '1024-q3'])
def test_chol_inverse_matches_jax(n, q):
    # n = 40: the dense form; 1100: the blocked form with a narrower last
    # block; 1024: two whole blocks, each package's blocked form
    A = _spd(11, q, n)
    got = TL.chol_inverse(TL.cholesky(_t(A)))
    ref = JL.chol_inverse(JL.cholesky(jnp.asarray(A)))
    err = np.max(np.abs(_np(got) - np.asarray(ref)))
    assert err <= 1e-10 * np.max(np.abs(np.asarray(ref)))
    assert got.is_contiguous()
    if n >= TL._BLOCKED_MIN_N:
        # the blocked form mirrors one triangle: exactly symmetric
        assert torch.equal(got, got.mT)


@pytest.mark.parametrize('n', [40, 1100])
def test_chol_inverse_keeps_its_input_and_counts_its_path(n):
    """The default call leaves the factor bit for bit; ``overwrite=True``
    gives the same bits, formed in the factor's storage from two blocks
    up; the counters name the path each call took."""
    L = TL.cholesky(_t(_spd(13, 2, n)))
    L0 = L.clone()
    blocked = n >= TL._BLOCKED_MIN_N
    before = (TL.chol_inverse.blocked, TL.chol_inverse.dense,
              TL.tri_inverse_lower.blocked, TL.tri_inverse_lower.dense)
    got = TL.chol_inverse(L)
    assert torch.equal(L, L0)
    assert torch.equal(TL.tri_inverse_lower(L), TL.tri_inverse_lower(L0))
    assert torch.equal(L, L0)
    mine = TL.chol_inverse(L, overwrite=True)
    assert torch.equal(mine, got)
    assert (mine.untyped_storage().data_ptr()
            == L.untyped_storage().data_ptr()) == blocked
    after = (TL.chol_inverse.blocked, TL.chol_inverse.dense,
             TL.tri_inverse_lower.blocked, TL.tri_inverse_lower.dense)
    assert [a - b for a, b in zip(after, before)] == (
        [2, 0, 2, 0] if blocked else [0, 2, 0, 2])


def test_quad_chol_matches_jax():
    A = _spd(12, 3, 50)
    v = np.random.default_rng(12).standard_normal((3, 50))
    got = TL.quad_chol(TL.cholesky(_t(A)), _t(v))
    ref = JL.quad_chol(JL.cholesky(jnp.asarray(A)), jnp.asarray(v))
    np.testing.assert_allclose(_np(got), np.asarray(ref), rtol=1e-12)


@pytest.mark.parametrize('submethod,err', [('full', None),
                                           ('rep', None),
                                           ('nope', ValueError)])
def test_make_loss(jm, submethod, err):
    if err is not None:
        with pytest.raises(err):
            TLik.make_loss(submethod, _data_of(jm))
        return
    if submethod == 'rep':
        # a rep model on the same inputs, two replicates of each site
        x, y = _problem(0, n=40)
        m = lcgp_tpu.LCGP(np.repeat(y, 2, axis=1), np.repeat(x, 2, axis=0),
                          q=4, submethod='rep')
        _fitted_like(m, 1)
        data = convert.rep_data_from_numpy(*m._data, 'cpu')
    else:
        m, data = jm, _data_of(jm)
    free = convert.free_params_from_numpy(*(np.asarray(v) for v in m._free),
                                          'cpu')
    loss = TLik.make_loss(submethod, data, q_chunk=2)
    np.testing.assert_allclose(_np(loss(free)),
                               np.asarray(JLik.make_loss(submethod, m._data)(
                                   m._free)), rtol=LOSS_RTOL)
