"""Tests of the port that need a CUDA card (marker ``gpu``).

K1 (``lcgp_tpu_torch/csrc/matern32_gram.cu``), K2
(``lcgp_tpu_torch/csrc/matern32_gram_vjp.cu``), K3 (``matern52_gram.cu`` and
its VJP), K4 (``rbf_gram.cu`` and its VJP) and K5 (``gram_vjp_x.cu``, the
Gram VJP in the points, and the FITC gradient through ``GramFn``) are CUDA
kernels with no CPU mode, so these skip without a card.  This file imports neither JAX nor
``tests/conftest.py``'s JAX setup, so it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

import lcgp_tpu_torch
from lcgp_tpu_torch.ops import matern as TM
from lcgp_tpu_torch.ops import matern52 as TM5
from lcgp_tpu_torch.ops import rbf as TR

F64_TOL = dict(rtol=1e-12, atol=1e-14)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K1-K4 are CUDA kernels with no '
                    'CPU mode')
    return torch.device('cuda', 0)


def _inputs(dev, seed, n1, n2, d, q, dtype=torch.float64):
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return (t(rng.uniform(0, 1, (n1, d))), t(rng.uniform(0, 1, (n2, d))),
            t(rng.uniform(0.2, 2.0, (q, d))), t(rng.uniform(0.5, 3.0, q)),
            t(rng.uniform(1e-6, 0.1, q)))


@pytest.mark.parametrize('same,epilogue,d', [
    (True, True, 8), (True, False, 3), (False, False, 8), (False, False, 32),
    (True, True, 17)])
def test_kernel_matches_plain(dev, same, epilogue, d):
    x1, x2, ls, amp, nug = _inputs(dev, d, 300, 77, d, 6)
    if same:
        x2 = x1
    rs = torch.linspace(0.5, 3.0, 6, dtype=torch.float64, device=dev) \
        if epilogue else None
    dv = torch.full((6, 300), 1.25, dtype=torch.float64, device=dev) \
        if epilogue else None
    got, c0 = TM.launch_matern32(x1, x2, ls, amp, nug, same=same,
                                 want_c0=True, row_scale=rs, diag_vec=dv)
    C, c0_ref = TM.matern32_gram_plain(x1, x2, ls, amp, nug, same=same,
                                       want_c0=True)
    ref = rs[:, None, None] * C + torch.diag_embed(dv) if epilogue else C
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **F64_TOL)
    torch.testing.assert_close(c0, c0_ref, **F64_TOL)
    if same and not epilogue:
        assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1),
                           amp[:, None].expand(6, 300))


@pytest.mark.parametrize('n', [1, 17, 1000, 4097])
@pytest.mark.parametrize('epilogue,want_c0', [(False, False), (False, True),
                                              (True, False), (True, True)])
def test_kernel_same_point_is_symmetric_at_ragged_n(dev, n, epilogue,
                                                    want_c0):
    # K1 computes one triangle of tiles and mirrors it: the result must be
    # exactly symmetric and match the plain version at sizes below, at and
    # past a tile
    q, d = 2, 8
    x, _, ls, amp, nug = _inputs(dev, 30 + n, n, 1, d, q)
    rs = torch.tensor([0.7, 2.5], dtype=torch.float64, device=dev) \
        if epilogue else None
    dv = torch.linspace(1.0, 2.0, q * n, dtype=torch.float64,
                        device=dev).reshape(q, n) if epilogue else None
    got, c0 = TM.launch_matern32(x, x, ls, amp, nug, same=True,
                                 want_c0=want_c0, row_scale=rs, diag_vec=dv)
    C, c0_ref = TM.matern32_gram_plain(x, x, ls, amp, nug, same=True,
                                       want_c0=True)
    ref = rs[:, None, None] * C + torch.diag_embed(dv) if epilogue else C
    torch.cuda.synchronize()
    assert torch.equal(got, got.mT)
    torch.testing.assert_close(got, ref, **F64_TOL)
    if want_c0:
        assert torch.equal(c0, c0.mT)
        torch.testing.assert_close(c0, c0_ref, **F64_TOL)
        assert bool((torch.diagonal(c0, dim1=-2, dim2=-1) == 1.0).all())
    else:
        assert c0 is None


@pytest.mark.parametrize('n1,n2', [(1, 1), (17, 33), (64, 4096),
                                   (1000, 977)])
def test_kernel_cross_matches_plain_at_ragged_shapes(dev, n1, n2):
    x1, x2, ls, amp, nug = _inputs(dev, 40 + n1, n1, n2, 8, 3)
    got = TM.matern32_gram(x1, x2, ls, amp, nug, same=False)
    ref = TM.matern32_gram_plain(x1, x2, ls, amp, nug, same=False)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **F64_TOL)


def test_kernel_f32_matches_f64_plain(dev):
    x1, _, ls, amp, nug = _inputs(dev, 1, 257, 257, 8, 5)
    got = TM.matern32_gram(x1.float(), x1.float(), ls.float(), amp.float(),
                           nug.float(), same=True)
    ref = TM.matern32_gram_plain(x1, x1, ls, amp, nug, same=True)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-6)


def test_wrapper_counts_launches(dev):
    x1, x2, ls, amp, nug = _inputs(dev, 2, 40, 30, 2, 3)
    before = TM.matern32_gram.launches
    TM.matern32_gram(x1, x2, ls, amp, nug, same=False)
    assert TM.matern32_gram.launches == before + 1


@pytest.mark.parametrize('bad', ['dtype', 'contiguity', 'device', 'd',
                                 'shape'])
def test_wrapper_raises_on_bad_input(dev, bad):
    x1, x2, ls, amp, nug = _inputs(dev, 3, 40, 30, 2, 3)
    if bad == 'dtype':
        x2 = x2.float()
    elif bad == 'contiguity':
        ls = ls.T.contiguous().T
    elif bad == 'device':
        amp = amp.cpu()
    elif bad == 'd':
        x1, x2, ls, amp, nug = _inputs(dev, 3, 40, 30, 33, 3)
    else:
        nug = nug[:2]
    with pytest.raises((TypeError, ValueError)):
        TM.launch_matern32(x1, x2, ls, amp, nug, same=False)


def test_lcgp_on_card_matches_cpu(dev):
    rng = np.random.default_rng(4)
    x = rng.uniform(0, 1, (150, 3))
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 2],
                   x[:, 0] * x[:, 2], np.sin(x.sum(1))])
    y = y + 0.05 * rng.standard_normal(y.shape)
    x0 = rng.uniform(0, 1, (20, 3))
    gpu = lcgp_tpu_torch.LCGP(y, x, q=3, device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=3, device='cpu')
    cpu.free = [v.cpu() for v in gpu.free]
    before = TM.matern32_gram.launches
    torch.testing.assert_close(gpu.loss().cpu(), cpu.loss(), rtol=1e-10,
                               atol=0)
    for a, b in zip(gpu.predict(x0, return_fullcov=True),
                    cpu.predict(x0, return_fullcov=True)):
        assert a.device.type == 'cuda'
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)
    # loss 1 + aux 1 + the predict cross-covariance 1
    assert TM.matern32_gram.launches == before + 3


# ---------------------------------------------------------------------------
# K2 (csrc/matern32_gram_vjp.cu), the VJP of K1, and the loss gradient
# ---------------------------------------------------------------------------

# K2's rounding in a sum is judged against the sum of the magnitudes of its
# terms (matern32_gram_vjp_scale), since the sums cancel: f64 1e-12 of
# that, f32 (per-entry arithmetic in f32, sums in f64) 1e-5.
VJP_BOUND = {torch.float64: 1e-12, torch.float32: 1e-5}


def _assert_vjp_close(got, ref, scale, bound):
    for name, g, r, s in zip(('glens', 'gamp', 'gnug'), got, ref, scale):
        err = (g.double() - r.double()).abs()
        assert bool(torch.isfinite(g).all()), name
        assert bool((err <= bound * s.double()).all()), (
            f'{name}: max err {float(err.max()):.3e}, max scale '
            f'{float(s.max()):.3e}')


def _sym(rng, q, n, dev, dtype):
    c = rng.standard_normal((q, n, n))
    return torch.as_tensor(c + c.transpose(0, 2, 1), dtype=dtype, device=dev)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same,d', [(True, 8), (False, 8), (True, 3),
                                    (False, 17), (True, 32)])
def test_vjp_kernel_generic_matches_plain(dev, dtype, same, d):
    x1, x2, ls, amp, nug = _inputs(dev, 10 + d, 200, 77, d, 5)
    rng = np.random.default_rng(d)
    if same:
        x2 = x1
        cbar = _sym(rng, 5, 200, dev, torch.float64)
    else:
        cbar = torch.as_tensor(rng.standard_normal((5, 200, 77)),
                               device=dev)
    got = TM.launch_matern32_vjp(*(t.to(dtype) for t in (x1, x2, ls, amp,
                                                          nug)),
                                 same=same, M=cbar.to(dtype).contiguous())
    ref = TM.matern32_gram_vjp_plain(x1, x2, ls, amp, nug, same=same,
                                     cbar=cbar)
    scale = TM.matern32_gram_vjp_scale(x1, x2, ls, amp, nug, same=same,
                                       cbar=cbar)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype for g in got)
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_vjp_kernel_fused_matches_plain(dev, dtype):
    x, _, ls, amp, nug = _inputs(dev, 20, 300, 300, 8, 6)
    rng = np.random.default_rng(20)
    M = _sym(rng, 6, 300, dev, torch.float64)
    w = torch.as_tensor(rng.standard_normal((6, 300)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, 6), device=dev)
    got = TM.matern32_gram_vjp_fused(
        *(t.to(dtype) for t in (x, ls, amp, nug)), M=M.to(dtype),
        alpha=alpha.to(dtype), beta=-0.5, w=w.to(dtype))
    ref = TM.matern32_gram_vjp_fused_plain(x, ls, amp, nug, M=M, alpha=alpha,
                                           beta=-0.5, w=w)
    scale = TM.matern32_gram_vjp_scale(
        x, x, ls, amp, nug, same=True,
        cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [1, 17, 65, 300])
def test_vjp_kernel_pairs_a_nonsymmetric_cotangent(dev, dtype, n):
    # same=True sums one triangle with cbar_ij + cbar_ji: exact for any
    # cotangent, which a non-symmetric one pins
    x, _, ls, amp, nug = _inputs(dev, 50 + n, n, 1, 8, 3)
    cbar = torch.as_tensor(np.random.default_rng(n).standard_normal((3, n, n)),
                           device=dev)
    got = TM.launch_matern32_vjp(*(t.to(dtype) for t in (x, x, ls, amp, nug)),
                                 same=True, M=cbar.to(dtype))
    ref = TM.matern32_gram_vjp_plain(x, x, ls, amp, nug, same=True, cbar=cbar)
    scale = TM.matern32_gram_vjp_scale(x, x, ls, amp, nug, same=True,
                                       cbar=cbar)
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('n', [17, 1000])
def test_vjp_kernel_fused_at_ragged_n(dev, n):
    x, _, ls, amp, nug = _inputs(dev, 60 + n, n, 1, 8, 4)
    rng = np.random.default_rng(60 + n)
    M = torch.as_tensor(rng.standard_normal((4, n, n)), device=dev)
    w = torch.as_tensor(rng.standard_normal((4, n)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, 4), device=dev)
    got = TM.matern32_gram_vjp_fused(x, ls, amp, nug, M=M, alpha=alpha,
                                     beta=-0.5, w=w)
    ref = TM.matern32_gram_vjp_fused_plain(x, ls, amp, nug, M=M, alpha=alpha,
                                           beta=-0.5, w=w)
    scale = TM.matern32_gram_vjp_scale(
        x, x, ls, amp, nug, same=True,
        cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[torch.float64])


def test_vjp_kernel_is_deterministic_and_counts(dev):
    x, _, ls, amp, nug = _inputs(dev, 21, 260, 260, 4, 3)
    cbar = _sym(np.random.default_rng(21), 3, 260, dev, torch.float64)
    before = TM.matern32_gram_vjp.launches
    a = TM.matern32_gram_vjp(x, x, ls, amp, nug, same=True, cbar=cbar)
    b = TM.matern32_gram_vjp(x, x, ls, amp, nug, same=True, cbar=cbar)
    assert TM.matern32_gram_vjp.launches == before + 2
    for u, v in zip(a, b):
        assert torch.equal(u, v)


def test_vjp_kernel_nan_cotangent_gives_nan(dev):
    x, _, ls, amp, nug = _inputs(dev, 22, 64, 64, 3, 2)
    cbar = torch.full((2, 64, 64), float('nan'), dtype=torch.float64,
                      device=dev)
    out = TM.matern32_gram_vjp(x, x, ls, amp, nug, same=True, cbar=cbar)
    torch.cuda.synchronize()
    assert all(bool(torch.isnan(g).all()) for g in out)


@pytest.mark.parametrize('bad', ['M shape', 'M dtype', 'M contiguity',
                                 'w without same', 'beta without w',
                                 'alpha shape', 'M device'])
def test_vjp_wrapper_raises_on_bad_input(dev, bad):
    x1, x2, ls, amp, nug = _inputs(dev, 23, 40, 30, 2, 3)
    M = torch.zeros((3, 40, 30), dtype=torch.float64, device=dev)
    kw = dict(same=False, M=M)
    if bad == 'M shape':
        kw['M'] = M[:, :, :29].contiguous()
    elif bad == 'M dtype':
        kw['M'] = M.float()
    elif bad == 'M contiguity':
        kw['M'] = torch.zeros((3, 30, 40), dtype=torch.float64,
                              device=dev).transpose(1, 2)
    elif bad == 'w without same':
        kw['w'] = torch.zeros((3, 40), dtype=torch.float64, device=dev)
    elif bad == 'beta without w':
        kw['beta'] = -0.5
    elif bad == 'alpha shape':
        kw['alpha'] = torch.ones(2, dtype=torch.float64, device=dev)
    else:
        kw['M'] = M.cpu()
    with pytest.raises((TypeError, ValueError)):
        TM.launch_matern32_vjp(x1, x2, ls, amp, nug, **kw)


@pytest.mark.parametrize('q_chunk', [None, 2])
def test_lcgp_gradient_on_card_matches_cpu(dev, q_chunk):
    from lcgp_tpu_torch.models import likelihood as TLik
    from lcgp_tpu_torch.models import params as TP
    rng = np.random.default_rng(5)
    x = rng.uniform(0, 1, (150, 3))
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 2],
                   x[:, 0] * x[:, 2], np.sin(x.sum(1))])
    y = y + 0.05 * rng.standard_normal(y.shape)
    gpu = lcgp_tpu_torch.LCGP(y, x, q=4, q_chunk=q_chunk, device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=4, q_chunk=q_chunk, device='cpu')

    def grad(m):
        free = TP.FreeParams(*(t.clone().requires_grad_(True)
                               for t in m.free))
        v = TLik.neglpost_full(free, m._data, q_chunk=m.q_chunk)
        return v, torch.autograd.grad(v, free)
    before = TM.matern32_gram_vjp.launches
    vg, gg = grad(gpu)
    vc, gc = grad(cpu)
    assert TM.matern32_gram_vjp.launches == before + (2 if q_chunk else 1)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-10, atol=0)
    for a, b in zip(gg, gc):
        assert a.device.type == 'cuda'
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-9 * float(b.abs().max()), err


def test_lcgp_fit_on_card_matches_cpu(dev):
    rng = np.random.default_rng(6)
    x = rng.uniform(0, 1, (120, 2))
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]),
                   x[:, 0] * x[:, 1]]) + 0.05 * rng.standard_normal((3, 120))
    gpu = lcgp_tpu_torch.LCGP(y, x, q=2, device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=2, device='cpu')
    before = TM.matern32_gram_vjp.launches
    gpu.fit(method='scipy', maxiter=5)
    cpu.fit(method='scipy', maxiter=5)
    res = gpu._fit_result
    assert TM.matern32_gram_vjp.launches == before + res.nfev
    assert res.nit == cpu._fit_result.nit
    assert abs(res.fun - cpu._fit_result.fun) <= 1e-8 * abs(res.fun)
    assert all(t.device.type == 'cuda' for t in gpu.free)


# ---------------------------------------------------------------------------
# the replication path (submethod='rep'): K1 with a diagonal that varies per
# entry, K2 at alpha = 1/2, and the model on the card
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('n', [17, 300, 977])
def test_kernel_rep_epilogue_matches_plain_and_is_symmetric(dev, n):
    # row scale 1 and diag_vec = 1/(D_k r_i), r_i replicate counts 1-10
    q = 3
    x, _, ls, amp, nug = _inputs(dev, 70 + n, n, 1, 8, q)
    rng = np.random.default_rng(70 + n)
    D = torch.as_tensor(rng.uniform(0.1, 50.0, q), device=dev)
    r = torch.as_tensor(rng.integers(1, 11, n), dtype=torch.float64,
                        device=dev)
    dv = (1.0 / (D[:, None] * r[None, :])).contiguous()
    got, _ = TM.launch_matern32(x, x, ls, amp, nug, same=True,
                                row_scale=torch.ones_like(D), diag_vec=dv)
    ref = (TM.matern32_gram_plain(x, x, ls, amp, nug, same=True)
           + torch.diag_embed(dv))
    torch.cuda.synchronize()
    assert torch.equal(got, got.mT)
    torch.testing.assert_close(got, ref, **F64_TOL)


def test_vjp_kernel_fused_at_the_rep_operating_point(dev):
    # alpha = 1/2, M = (C + Lam)^{-1}, w = u = M Lam b
    from lcgp_tpu_torch.ops import linalg
    q, n = 4, 300
    x, _, ls, amp, nug = _inputs(dev, 80, n, 1, 8, q)
    rng = np.random.default_rng(80)
    D = torch.as_tensor(rng.uniform(0.5, 20.0, q), device=dev)
    r = torch.as_tensor(rng.integers(1, 11, n), dtype=torch.float64,
                        device=dev)
    lam = 1.0 / (D[:, None] * r[None, :])
    C = TM.matern32_gram_plain(x, x, ls, amp, nug, same=True)
    L = linalg.cholesky(C + torch.diag_embed(lam))
    M = linalg.chol_inverse(L)
    b = torch.as_tensor(rng.standard_normal((q, n)), device=dev)
    u = linalg.cho_solve_vec(L, lam * b).contiguous()
    half = torch.full_like(D, 0.5)
    got = TM.matern32_gram_vjp_fused(x, ls, amp, nug, M=M, alpha=half,
                                     beta=-0.5, w=u)
    ref = TM.matern32_gram_vjp_fused_plain(x, ls, amp, nug, M=M, alpha=half,
                                           beta=-0.5, w=u)
    scale = TM.matern32_gram_vjp_scale(
        x, x, ls, amp, nug, same=True,
        cbar=TM.fused_cotangent(M, half, -0.5, u))
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[torch.float64])


def test_lcgp_rep_on_card_matches_cpu(dev):
    from lcgp_tpu_torch.models import likelihood as TLik
    from lcgp_tpu_torch.models import params as TP
    rng = np.random.default_rng(7)
    xu = rng.uniform(0, 1, (120, 3))
    reps = rng.integers(1, 6, 120)
    x = np.repeat(xu, reps, axis=0)
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 2],
                   x[:, 0] * x[:, 2], np.sin(x.sum(1))])
    y = y + 0.05 * rng.standard_normal(y.shape)
    x0 = rng.uniform(0, 1, (20, 3))
    gpu = lcgp_tpu_torch.LCGP(y, x, q=3, submethod='rep', device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=3, submethod='rep', device='cpu')
    assert gpu.n == cpu.n == 120

    def grad(m):
        free = TP.FreeParams(*(t.clone().requires_grad_(True)
                               for t in m.free))
        v = TLik.neglpost_rep(free, m._data)
        return v, torch.autograd.grad(v, free)
    k1, k2 = TM.matern32_gram.launches, TM.matern32_gram_vjp.launches
    vg, gg = grad(gpu)
    assert (TM.matern32_gram.launches, TM.matern32_gram_vjp.launches) == (
        k1 + 1, k2 + 1)
    vc, gc = grad(cpu)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-10, atol=0)
    for a, b in zip(gg, gc):
        assert a.device.type == 'cuda'
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-9 * float(b.abs().max()), err
    torch.testing.assert_close(gpu.loss().cpu(), cpu.loss(), rtol=1e-10,
                               atol=0)
    for name in ('CinvMs', 'LTs', 'mks', 'psi_c'):
        torch.testing.assert_close(getattr(gpu, name).cpu(),
                                   getattr(cpu, name), rtol=1e-9, atol=1e-12)
    out = gpu.predict(x0, return_fullcov=True)
    assert out[3] is None
    for a, b in zip(out[:3], cpu.predict(x0)):
        assert a.device.type == 'cuda'
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# the precision modes: K1 and K2 in f32 on the 'fast' and 'mixed' paths
# ---------------------------------------------------------------------------

EPS32 = float(np.finfo(np.float32).eps)


def test_kernel_f32_at_the_fast_loss_shape_with_its_epilogue(dev):
    # B = D C + (1 + jitter) I, all in f32, against the plain version on
    # the same f32 inputs (rtol 1e-4, atol 1e-6: each S subtracts first in
    # K1 and scales first in the plain version, eps32 |x| / l apart)
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    q, n = 4, 600
    x, _, ls, amp, nug = _inputs(dev, 90, n, 1, 8, q)
    D = torch.linspace(0.5, 20.0, q, dtype=torch.float64, device=dev)
    dv = torch.full((q, n), 1.0 + 1e-6, dtype=torch.float32, device=dev)
    before = (TM.matern32_gram.launches, TM.matern32_gram.launches_f32)
    got = gram_factor_target(x, ls, amp, nug, row_scale=D, diag_vec=dv,
                             compute_dtype=torch.float32)
    assert (TM.matern32_gram.launches, TM.matern32_gram.launches_f32) == (
        before[0] + 1, before[1] + 1)
    f32 = [t.float() for t in (x, ls, amp, nug)]
    C = TM.matern32_gram_plain(f32[0], f32[0], *f32[1:], same=True)
    ref = D.float()[:, None, None] * C + torch.diag_embed(dv)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, got.mT)
    torch.testing.assert_close(got, ref, rtol=1e-4, atol=1e-6)


def _dense_chol_inverse(L):
    """The dense form of B^{-1}: a triangular solve against I, then
    L^{-T} L^{-1} as one matmul (``chol_inverse`` below two blocks)."""
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    return linv.mT @ linv


def test_chol_inverse_blocked_at_the_fit_shape(dev):
    """B^{-1} at (10, 4096, 4096) f64, the loss's chunk at config 4, with
    B = D C + I of a Matern 3/2 field on 8 inputs (K1's epilogue): the
    blocked form within 1e-12 of the dense form's max |B^{-1}|, exactly
    symmetric and row-major.  Across the call the device holds at most the
    input, one (10, n, n) buffer and 5% of those two; with
    ``overwrite=True`` no such buffer, only block-sized temporaries (the
    diagonal blocks' solves take a 16th of one)."""
    from lcgp_tpu_torch.ops import linalg
    q, n = 10, 4096
    x, _, ls, amp, nug = _inputs(dev, 91, n, 1, 8, q)
    D = torch.linspace(0.5, 20.0, q, dtype=torch.float64, device=dev)
    B, _ = TM.launch_matern32(x, x, ls, amp, nug, same=True, row_scale=D,
                              diag_vec=torch.ones((q, n), dtype=torch.float64,
                                                  device=dev))
    L = linalg.cholesky(B)
    del B
    ref = _dense_chol_inverse(L)
    buffer = L.numel() * L.element_size()
    blocked = linalg.chol_inverse.blocked

    def peak_over(fn):
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = fn()
        torch.cuda.synchronize()
        return out, torch.cuda.max_memory_allocated() - base

    got, extra = peak_over(lambda: linalg.chol_inverse(L))
    # the memory before the call holds the input
    assert extra <= buffer + 0.05 * 2 * buffer, extra / buffer
    assert torch.equal(got, got.mT) and got.is_contiguous()
    err = float((got - ref).abs().max() / ref.abs().max())
    assert err <= 1e-12, err
    del ref
    mine, extra = peak_over(lambda: linalg.chol_inverse(L, overwrite=True))
    assert extra <= buffer / 8, extra / buffer
    assert torch.equal(mine, got)
    assert linalg.chol_inverse.blocked == blocked + 2


def test_cholesky_blocked_at_the_fit_shape(dev):
    """The factor of B at (10, 4096, 4096) f64, the loss's chunk at config
    4, blocked: within 1e-12 of ``cholesky_ex``'s max |L|, zeros above the
    diagonal, its normwise residual within 10x of ``cholesky_ex``'s; with
    ``overwrite=True`` in B's own storage, holding beyond B only the
    panel (a ninth of B at its largest) and block-sized temporaries."""
    from lcgp_tpu_torch.ops import linalg
    q, n = 10, 4096
    x, _, ls, amp, nug = _inputs(dev, 92, n, 1, 8, q)
    D = torch.linspace(0.5, 20.0, q, dtype=torch.float64, device=dev)
    B, _ = TM.launch_matern32(x, x, ls, amp, nug, same=True, row_scale=D,
                              diag_vec=torch.ones((q, n), dtype=torch.float64,
                                                  device=dev))
    ref = torch.linalg.cholesky_ex(B)[0]
    buffer = B.numel() * B.element_size()
    paths = (linalg.cholesky.blocked, linalg.cholesky.dense)
    L = linalg.cholesky(B)
    err = float((L - ref).abs().max() / ref.abs().max())
    assert err <= 1e-12, err
    assert not torch.triu(L, 1).any()

    def residual(F):
        Bs = torch.tril(B) + torch.tril(B, -1).mT
        return float((torch.linalg.matrix_norm(F @ F.mT - Bs)
                      / torch.linalg.matrix_norm(Bs)).max())
    assert residual(L) <= 10 * residual(ref)
    del ref
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    mine = linalg.cholesky(B, overwrite=True)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - base
    assert extra <= buffer / 5, extra / buffer
    assert mine.data_ptr() == B.data_ptr() and torch.equal(mine, L)
    assert (linalg.cholesky.blocked, linalg.cholesky.dense) == (
        paths[0] + 2, paths[1])


def test_vjp_kernel_f32_at_the_mixed_operating_point(dev):
    # M = the f32 potri seed of a refined factor, alpha = D/2 in f32 and
    # w = B^{-1} a refined in f64, cast to f32: what 'mixed' hands K2
    from lcgp_tpu_torch.ops import mixed
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    q, n = 4, 300
    x, _, ls, amp, nug = _inputs(dev, 91, n, 1, 8, q)
    D = torch.linspace(0.5, 20.0, q, dtype=torch.float64, device=dev)
    a = torch.as_tensor(np.random.default_rng(91).standard_normal((q, n)),
                        device=dev)
    B = gram_factor_target(x, ls, amp, nug, row_scale=D,
                           diag_vec=torch.ones((q, n), dtype=torch.float64,
                                               device=dev))
    L = mixed.cholesky_mixed(B, refine_steps=2, seed_jitter=1e-6)
    w = mixed.cho_solve_vec_refined(L, B, a).float()
    M = mixed.chol_inverse_from_factor_mixed(L.float(), newton_steps=0)
    alpha = (0.5 * D).float()
    before = TM.matern32_gram_vjp.launches_f32
    got = TM.matern32_gram_vjp_fused(x, ls, amp, nug, M=M, alpha=alpha,
                                     beta=-0.5, w=w)
    assert TM.matern32_gram_vjp.launches_f32 == before + 1
    f32 = [t.float() for t in (x, ls, amp, nug)]
    ref = TM.matern32_gram_vjp_fused_plain(*f32, M=M, alpha=alpha, beta=-0.5,
                                           w=w)
    scale = TM.matern32_gram_vjp_scale(
        x, x, ls, amp, nug, same=True,
        cbar=TM.fused_cotangent(M.double(), alpha.double(), -0.5, w.double()))
    torch.cuda.synchronize()
    # the results come back in the parameters' dtype
    assert all(g.dtype == torch.float64 for g in got)
    _assert_vjp_close(got, ref, scale, VJP_BOUND[torch.float32])


def _model_pair(dev, precision, seed):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (300, 3))
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 2],
                   x[:, 0] * x[:, 2], np.sin(x.sum(1))])
    y = y + 0.05 * rng.standard_normal(y.shape)
    gpu = lcgp_tpu_torch.LCGP(y, x, q=3, precision=precision, device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=3, precision=precision, device='cpu')
    assert gpu.precision == cpu.precision == precision
    return gpu, cpu, rng.uniform(0, 1, (20, 3))


def _loss_and_grad(m):
    from lcgp_tpu_torch.models import likelihood as TLik
    from lcgp_tpu_torch.models import params as TP
    free = TP.FreeParams(*(t.clone().requires_grad_(True) for t in m.free))
    v = TLik.neglpost_full(free, m._data, compute_dtype=m._compute_dtype,
                           jitter=m._jitter)
    return v, torch.autograd.grad(v, free)


@pytest.mark.parametrize('precision', ['mixed', 'fast'])
def test_lcgp_precision_on_card_matches_cpu(dev, precision):
    """A 'mixed' and a 'fast' model at n=300 on the card against the same
    model on the CPU.  'mixed': loss rtol 1e-9, predictions rtol 1e-7
    (atol 1e-9), gradients within 5e-4 of each leaf's max |g| (f32-grade
    by design).  'fast': two f32 factorizations, so the loss within
    sum_k n eps32 cond(B_k) and the predictions and gradients within
    n eps32 max_k cond(B_k) of their largest entry."""
    from lcgp_tpu_torch.models import params as TP
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    gpu, cpu, x0 = _model_pair(dev, precision, 8)
    k1, k2 = TM.matern32_gram.launches_f32, TM.matern32_gram_vjp.launches_f32
    vg, gg = _loss_and_grad(gpu)
    # one K2 launch in f32 in both modes; K1 in f32 under 'fast' only
    assert TM.matern32_gram_vjp.launches_f32 == k2 + 1
    assert TM.matern32_gram.launches_f32 == k1 + (precision == 'fast')
    vc, gc = _loss_and_grad(cpu)
    ls, amp, _, nug = TP.constrain(cpu.free)
    B = gram_factor_target(cpu.x, ls, amp, nug, row_scale=cpu.diag_D,
                           diag_vec=torch.ones((3, 300), dtype=torch.float64))
    conds = np.linalg.cond(B.numpy())
    f32_tol = 300 * EPS32 * float(np.max(conds))
    if precision == 'mixed':
        torch.testing.assert_close(vg.cpu(), vc, rtol=1e-9, atol=0)
        grad_tol = 5e-4
    else:
        assert abs(float(vg.detach()) - float(vc.detach())) <= np.sum(
            300 * EPS32 * conds)
        grad_tol = f32_tol
    for a, b in zip(gg, gc):
        assert a.device.type == 'cuda' and a.dtype == torch.float64
        err = float((a.cpu() - b).abs().max())
        assert err <= grad_tol * float(b.abs().max()), err
    for a, b in zip(gpu.predict(x0), cpu.predict(x0)):
        assert a.device.type == 'cuda'
        if precision == 'mixed':
            torch.testing.assert_close(a.cpu(), b, rtol=1e-7, atol=1e-9)
        else:
            err = float((a.cpu() - b).abs().max())
            assert err <= f32_tol * float(b.abs().max()), err


# ---------------------------------------------------------------------------
# K3 (kernel='matern52') and K4 (kernel='rbf'): the Gram kernel and its VJP
# of each kind against their plain versions, and the model on the card
# ---------------------------------------------------------------------------

KINDS = {'matern52': TM5, 'rbf': TR}


def _kind(kind):
    """(launch, plain Gram, VJP launch, plain VJP, plain fused VJP, VJP
    scale, Gram counter, VJP counter) of a kind."""
    m = KINDS[kind]
    return (getattr(m, f'launch_{kind}'), getattr(m, f'{kind}_gram_plain'),
            getattr(m, f'launch_{kind}_vjp'),
            getattr(m, f'{kind}_gram_vjp_plain'),
            getattr(m, f'{kind}_gram_vjp_fused_plain'),
            getattr(m, f'{kind}_gram_vjp_scale'), getattr(m, f'{kind}_gram'),
            getattr(m, f'{kind}_gram_vjp'))


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('d', [1, 3, 8, 17])
@pytest.mark.parametrize('same', [True, False])
def test_kind_kernel_matches_plain(dev, kind, d, same):
    """Same-point with the factor target's epilogue (exactly symmetric, C0
    exactly 1 on the diagonal) and cross at a ragged shape, f64."""
    launch, plain = _kind(kind)[:2]
    x1, x2, ls, amp, nug = _inputs(dev, 90 + d, 300, 77, d, 5)
    rs = dv = None
    if same:
        x2 = x1
        rs = torch.linspace(0.5, 3.0, 5, dtype=torch.float64, device=dev)
        dv = torch.linspace(1.0, 2.0, 5 * 300, dtype=torch.float64,
                            device=dev).reshape(5, 300)
    got, c0 = launch(x1, x2, ls, amp, nug, same=same, want_c0=True,
                     row_scale=rs, diag_vec=dv)
    C, c0_ref = plain(x1, x2, ls, amp, nug, same=same, want_c0=True)
    ref = rs[:, None, None] * C + torch.diag_embed(dv) if same else C
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **F64_TOL)
    torch.testing.assert_close(c0, c0_ref, **F64_TOL)
    if same:
        assert torch.equal(got, got.mT) and torch.equal(c0, c0.mT)
        assert bool((torch.diagonal(c0, dim1=-2, dim2=-1) == 1.0).all())


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('n', [1, 17, 1000, 4097])
def test_kind_kernel_same_point_is_symmetric_at_ragged_n(dev, kind, n):
    launch, plain = _kind(kind)[:2]
    x, _, ls, amp, nug = _inputs(dev, 95 + n, n, 1, 8, 2)
    got = launch(x, x, ls, amp, nug, same=True)[0]
    ref = plain(x, x, ls, amp, nug, same=True)
    torch.cuda.synchronize()
    assert torch.equal(got, got.mT)
    assert torch.equal(torch.diagonal(got, dim1=-2, dim2=-1),
                       amp[:, None].expand(2, n))
    torch.testing.assert_close(got, ref, **F64_TOL)


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('same', [True, False])
def test_kind_kernel_f32_matches_f64_plain(dev, kind, same):
    launch, plain, *_, gram, _ = _kind(kind)
    x1, x2, ls, amp, nug = _inputs(dev, 4, 257, 64, 8, 5)
    if same:
        x2 = x1
    before = (gram.launches, gram.launches_f32)
    got = gram(*(t.float() for t in (x1, x2, ls, amp, nug)), same=same)
    assert (gram.launches, gram.launches_f32) == (before[0] + 1,
                                                  before[1] + 1)
    ref = plain(x1, x2, ls, amp, nug, same=same)
    assert got.dtype == torch.float32
    torch.testing.assert_close(got.double(), ref, rtol=1e-4, atol=1e-6)
    if same:
        assert torch.equal(got, got.mT)


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same,d', [(True, 8), (False, 8), (True, 1),
                                    (True, 3), (False, 17)])
def test_kind_vjp_kernel_generic_matches_plain(dev, kind, dtype, same, d):
    """Any cotangent, a non-symmetric one when same (which pins the pairing
    of the two triangles), against the f64 plain VJP."""
    *_, launch_vjp, vjp_plain, _, scale_fn, _, _ = _kind(kind)
    x1, x2, ls, amp, nug = _inputs(dev, 100 + d, 200, 77, d, 5)
    if same:
        x2 = x1
    cbar = torch.as_tensor(np.random.default_rng(d).standard_normal(
        (5, 200, x2.shape[0])), device=dev)
    got = launch_vjp(*(t.to(dtype) for t in (x1, x2, ls, amp, nug)),
                     same=same, M=cbar.to(dtype).contiguous())
    ref = vjp_plain(x1, x2, ls, amp, nug, same=same, cbar=cbar)
    scale = scale_fn(x1, x2, ls, amp, nug, same=same, cbar=cbar)
    torch.cuda.synchronize()
    assert all(g.dtype == dtype for g in got)
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [17, 300])
def test_kind_vjp_kernel_fused_is_deterministic(dev, kind, dtype, n):
    """The fused cotangent alpha M + beta w w^T, never formed: against the
    f64 plain VJP, and two launches give the same bits."""
    (*_, launch_vjp, _, fused_plain, scale_fn, _, vjp) = _kind(kind)
    x, _, ls, amp, nug = _inputs(dev, 110 + n, n, 1, 8, 4)
    rng = np.random.default_rng(110 + n)
    M = _sym(rng, 4, n, dev, torch.float64)
    w = torch.as_tensor(rng.standard_normal((4, n)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, 4), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x, ls, amp, nug, M, alpha, w)]
    before = vjp.launches
    runs = [launch_vjp(cast[0], cast[0], *cast[1:4], same=True, M=cast[4],
                       alpha=cast[5], beta=-0.5, w=cast[6]) for _ in range(2)]
    assert vjp.launches == before + 2
    ref = fused_plain(x, ls, amp, nug, M=M, alpha=alpha, beta=-0.5, w=w)
    scale = scale_fn(x, x, ls, amp, nug, same=True,
                     cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(*runs))
    _assert_vjp_close(runs[0], ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('kind', list(KINDS))
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_lcgp_kind_on_card_matches_cpu(dev, kind, submethod):
    """A matern52 or rbf model on the card against the same model on the
    CPU: loss rtol 1e-10, gradient within 1e-9 of each leaf's max |g|,
    predictions (with the full covariance on the full path) rtol 1e-9,
    and one Gram and one VJP launch per loss+grad evaluation."""
    from lcgp_tpu_torch.models import likelihood as TLik
    from lcgp_tpu_torch.models import params as TP
    *_, gram, vjp = _kind(kind)
    rng = np.random.default_rng(12)
    x = rng.uniform(0, 1, (150, 3))
    if submethod == 'rep':
        x = np.repeat(x, rng.integers(1, 4, 150), axis=0)
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]) * x[:, 2],
                   x[:, 0] * x[:, 2], np.sin(x.sum(1))])
    y = y + 0.05 * rng.standard_normal(y.shape)
    x0 = rng.uniform(0, 1, (20, 3))
    gpu = lcgp_tpu_torch.LCGP(y, x, q=3, kernel=kind, submethod=submethod,
                              device=dev)
    cpu = lcgp_tpu_torch.LCGP(y, x, q=3, kernel=kind, submethod=submethod,
                              device='cpu')
    fn = TLik.neglpost_full if submethod == 'full' else TLik.neglpost_rep

    def grad(m):
        free = TP.FreeParams(*(t.clone().requires_grad_(True)
                               for t in m.free))
        v = fn(free, m._data, kernel=kind)
        return v, torch.autograd.grad(v, free)
    before = (gram.launches, vjp.launches)
    vg, gg = grad(gpu)
    assert (gram.launches, vjp.launches) == (before[0] + 1, before[1] + 1)
    vc, gc = grad(cpu)
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-10, atol=0)
    for a, b in zip(gg, gc):
        assert a.device.type == 'cuda'
        err = float((a.cpu() - b).abs().max())
        assert err <= 1e-9 * float(b.abs().max()), err
    full = submethod == 'full'
    for a, b in zip(gpu.predict(x0, return_fullcov=full),
                    cpu.predict(x0, return_fullcov=full)):
        assert a.device.type == 'cuda'
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)


# ---------------------------------------------------------------------------
# The FITC path: GramFn (the Gram kernels inside an autograd.Function whose
# backward is the VJP kernel), K5 (the VJP in the points), and the FITC
# loss's gradient on the card
# ---------------------------------------------------------------------------

FAMILY_KINDS = ['matern32', 'matern52', 'rbf']


@pytest.mark.parametrize('kind', FAMILY_KINDS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('q,n1,n2,d', [(4, 3000, 256, 2), (3, 333, 77, 5),
                                       (2, 130, 65, 17), (4, 256, 256, 2)])
def test_vjp_x_kernel_matches_plain(dev, kind, dtype, q, n1, n2, d):
    """K5 against its plain version at a tall FITC shape, ragged shapes and
    Kmm's square shape, with coincident points (S = 0): each entry within
    VJP_BOUND of the magnitude of its terms; two launches the same bits."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES[kind]
    x1, x2, ls, amp, nug = _inputs(dev, 90 + d, n1, n2, d, q, dtype)
    x2[:5] = x1[:5]
    M = torch.randn((q, n1, n2), generator=torch.Generator(
        device=dev).manual_seed(d), dtype=dtype, device=dev)
    before = fam.vjp_x.launches
    got = fam.vjp_x(x1, x2, ls, amp, nug, M=M)
    again = fam.vjp_x(x1, x2, ls, amp, nug, M=M)
    ref = fam.vjp_x_plain(*(t.double() for t in (x1, x2, ls, amp, nug)),
                          M=M.double())
    torch.cuda.synchronize()
    assert fam.vjp_x.launches == before + 2
    assert got.shape == (n2, d) and got.dtype == dtype
    assert torch.equal(got, again)
    scale = fam.scale_x(*(t.double() for t in (x1, x2, ls, amp, nug)),
                        M=M.double())
    err = (got.double() - ref).abs()
    assert bool((err <= VJP_BOUND[dtype] * scale).all()), float(err.max())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_vjp_kernel_at_a_random_fitc_cotangent(dev, dtype):
    """K2 at an arbitrary cross cotangent of Knm's tall shape."""
    x1, x2, ls, amp, nug = _inputs(dev, 95, 3000, 256, 2, 4, dtype)
    M = torch.randn((4, 3000, 256), generator=torch.Generator(
        device=dev).manual_seed(95), dtype=dtype, device=dev)
    got = TM.launch_matern32_vjp(x1, x2, ls, amp, nug, same=False, M=M)
    args = [t.double() for t in (x1, x2, ls, amp, nug)]
    ref = TM.matern32_gram_vjp_plain(*args, same=False, cbar=M.double())
    scale = TM.matern32_gram_vjp_scale(*args, same=False, cbar=M.double())
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


def test_gram_stack_backward_runs_the_kernels(dev, monkeypatch):
    """On CUDA, gram_stack with an operand that requires a gradient
    returns a tensor with a grad_fn whose backward launches the VJP kernel
    and K5, never a plain version."""
    from lcgp_tpu_torch.ops.gram import gram_stack
    from lcgp_tpu_torch.ops.launch import Family, FAMILIES

    def refuse(*args, **kwargs):
        raise AssertionError('a plain version ran on CUDA tensors')
    for name in ('plain', 'vjp_plain', 'vjp_x_plain'):
        monkeypatch.setattr(Family, name, refuse)
    fam = FAMILIES['matern32']
    x1, z, ls, amp, nug = _inputs(dev, 97, 500, 64, 2, 4)
    z.requires_grad_(True)
    amp.requires_grad_(True)
    before = (fam.gram.launches, fam.vjp.launches, fam.vjp_x.launches)
    C = gram_stack(x1, z, ls, amp, nug, same=False)
    K = gram_stack(z, z, ls, amp, nug, same=False)
    assert C.grad_fn is not None and K.grad_fn is not None
    gz, gamp = torch.autograd.grad(C.sum() + K.square().sum(), (z, amp))
    torch.cuda.synchronize()
    # two Grams, two VJPs, and K5 once for C and twice for K (z is both of
    # its operands)
    assert (fam.gram.launches, fam.vjp.launches, fam.vjp_x.launches) == \
        (before[0] + 2, before[1] + 2, before[2] + 3)
    assert bool(torch.isfinite(gz).all()) and float(gz.abs().max()) > 0


def _fitc_problem(seed, n=400, submethod='full'):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, 2))
    if submethod == 'rep':
        x = np.repeat(x, rng.integers(1, 4, n), axis=0)
    y = np.vstack([np.sin(4 * x[:, 0]) + x[:, 1], np.cos(3 * x[:, 1]),
                   x[:, 0] * x[:, 1], np.sin(x.sum(1))])
    return x, y + 0.05 * rng.standard_normal(y.shape), rng.uniform(0, 1,
                                                                  (30, 2))


def _z_grad_rtol(m):
    """1e-9, or 10 eps cond(Kmm + jitter) where that is larger: the z
    gradient is a small residue of terms through Kmm's factor (the
    squared exponential's Kmm reaches cond ~1e9 at these inits, where two
    reduction orders on one CPU part by ~1e-7 of its max |g|)."""
    from lcgp_tpu_torch.models import params as TP
    from lcgp_tpu_torch.models.sparse import KMM_JITTER
    from lcgp_tpu_torch.ops.gram import gram_stack
    with torch.no_grad():
        ls, amp, _, nug = (t.cpu() for t in TP.constrain(m.free))
        K = gram_stack(m._z.cpu(), m._z.cpu(), ls, amp, nug, same=False,
                       kind=m.kernel)
        K = K + KMM_JITTER * amp[:, None, None] * torch.eye(
            K.shape[-1], dtype=K.dtype)
        cond = float(torch.linalg.cond(K).max())
    return max(1e-9, 10 * float(np.finfo(np.float64).eps) * cond)


@pytest.mark.parametrize('kind', FAMILY_KINDS)
@pytest.mark.parametrize('n_chunk', [0, 96])
@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_fitc_gradient_on_card_matches_cpu(dev, submethod, n_chunk, kind):
    """The FITC loss and its gradient in (free, z) on the card against the
    same port on the CPU (loss rtol 1e-10, each leaf within 1e-9 of its max
    |g|, the z leaf within _z_grad_rtol): on CUDA the Gram terms reach the
    gradient only through GramFn.
    Launches per loss+grad: dense K1 2, VJP 2, K5 3 (Kmm's two operands and
    Knm's); streamed over n_blocks, K1 1 + 2 n_blocks (the checkpoint
    recomputes each block), VJP 1 + n_blocks, K5 2 + n_blocks."""
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES[kind]
    x, y, x0 = _fitc_problem(21, submethod=submethod)
    models = [lcgp_tpu_torch.LCGP(y, x, q=3, inducing=40, n_chunk=n_chunk,
                                  kernel=kind, submethod=submethod,
                                  device=d_) for d_ in (dev, 'cpu')]

    def loss_grad(m):
        tree = {'free': m.free, 'z': m._z}
        fl = Flattener(tree)
        flat = fl.ravel(tree).clone().requires_grad_(True)
        t = fl.unravel(flat)
        v = m._fitc_loss(m._compute_dtype)(t['free'], t['z'])
        return v.detach(), torch.autograd.grad(v, flat)[0]
    before = (fam.gram.launches, fam.vjp.launches, fam.vjp_x.launches)
    vg, gg = loss_grad(models[0])
    torch.cuda.synchronize()
    nb = -(-models[0].n // n_chunk) if n_chunk else 0
    expect = (2, 2, 3) if not n_chunk else (1 + 2 * nb, 1 + nb, 2 + nb)
    assert (fam.gram.launches - before[0], fam.vjp.launches - before[1],
            fam.vjp_x.launches - before[2]) == expect
    vc, gc = loss_grad(models[1])
    torch.testing.assert_close(vg.cpu(), vc, rtol=1e-10, atol=0)
    fl = Flattener({'free': models[1].free, 'z': models[1]._z})
    got, ref = fl.unravel(gg.cpu()), fl.unravel(gc)
    for a, b in zip(got['free'], ref['free']):
        err = float((a - b).abs().max())
        assert err <= 1e-9 * float(b.abs().max()), err
    # the z gradient's rounding error grows with cond(Kmm + jitter)
    err = float((got['z'] - ref['z']).abs().max())
    assert err <= _z_grad_rtol(models[1]) * float(ref['z'].abs().max()), err
    for a, b in zip(models[0].predict(x0, batch_size=16),
                    models[1].predict(x0, batch_size=16)):
        assert a.device.type == 'cuda'
        torch.testing.assert_close(a.cpu(), b, rtol=1e-9, atol=1e-12)


@pytest.mark.parametrize('n_chunk', [0, 128])
def test_fitc_fit_launch_counts_and_refine_on_card(dev, n_chunk):
    """A 'fast' Adam fit launches K1 and K2 per step as the loss needs, f64
    for Kmm and f32 for Knm (no K5), and refine_inducing launches K5 on
    every step and moves z as the CPU port does."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES['matern32']
    x, y, _ = _fitc_problem(23, n=500)
    gpu = lcgp_tpu_torch.LCGP(y, x, q=3, inducing=32, n_chunk=n_chunk,
                              precision='fast', device=dev)
    nb = -(-500 // n_chunk) if n_chunk else 0
    # Kmm in f64, Knm in f32 (per block, and again when recomputed)
    per_step = (2, 2) if not n_chunk else (1 + 2 * nb, 1 + nb)
    counters = (fam.gram, fam.vjp, fam.vjp_x)
    before = [(c.launches, c.launches_f32) for c in counters]
    gpu.fit(method='adam', steps=4)
    torch.cuda.synchronize()
    after = [(c.launches, c.launches_f32) for c in counters]
    assert [a[0] - b[0] for a, b in zip(after, before)] == \
        [4 * per_step[0], 4 * per_step[1], 0]
    assert [a[1] - b[1] for a, b in zip(after, before)] == \
        [4 * (per_step[0] - 1), 4 * (per_step[1] - 1), 0]
    hi = [lcgp_tpu_torch.LCGP(y, x, q=3, inducing=32, n_chunk=n_chunk,
                              device=d_) for d_ in (dev, 'cpu')]
    before = fam.vjp_x.launches
    losses = [m.refine_inducing(steps=3, joint=False) for m in hi]
    assert fam.vjp_x.launches - before == 3 * (3 if not n_chunk else 2 + nb)
    assert abs(losses[0] - losses[1]) <= 1e-9 * abs(losses[1])
    torch.testing.assert_close(hi[0]._z.cpu(), hi[1]._z, rtol=0, atol=1e-9)


# ---------------------------------------------------------------------------
# K3's own kernels (csrc/matern52_gram_kernel.cuh: 32 x 32 tiles staged in
# shared memory and written by bulk copies, or by plain stores where a row
# is not 16-byte aligned; csrc/matern52_gram_vjp_kernel.cuh: 64 x 64 tiles
# in 32-row stages loaded by a producer warp with tensor copies, or with
# cp.async where M's rows are not 16-byte aligned): the edges of that design
# ---------------------------------------------------------------------------


def _k3_target(x1, x2, ls, amp, nug, same, rs, dv):
    C, c0 = TM5.matern52_gram_plain(x1, x2, ls, amp, nug, same=same,
                                    want_c0=True)
    if rs is not None:
        C = rs[:, None, None] * C + torch.diag_embed(dv)
    return C, c0


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [31, 32, 33, 63, 64, 65])
@pytest.mark.parametrize('want_c0', [False, True])
def test_k3_gram_at_tile_and_stage_edges(dev, dtype, n, want_c0):
    """The same-point factor target at n one below, at and one past a tile
    of the forward (32) and of the VJP (64; its stages are 32 rows): exactly
    symmetric, C0 exactly 1 on the diagonal, against the f64 plain version.
    Odd n takes the path without bulk copies."""
    x, _, ls, amp, nug = _inputs(dev, 200 + n, n, 1, 8, 3)
    rs = torch.tensor([0.5, 1.0, 2.5], dtype=torch.float64, device=dev)
    dv = torch.linspace(1.0, 2.0, 3 * n, dtype=torch.float64,
                        device=dev).reshape(3, n)
    cast = [t.to(dtype) for t in (x, ls, amp, nug, rs, dv)]
    got, c0 = TM5.launch_matern52(cast[0], cast[0], *cast[1:4], same=True,
                                  want_c0=want_c0, row_scale=cast[4],
                                  diag_vec=cast[5])
    ref, c0_ref = _k3_target(x, x, ls, amp, nug, True, rs, dv)
    torch.cuda.synchronize()
    tol = F64_TOL if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-6)
    assert torch.equal(got, got.mT)
    torch.testing.assert_close(got.double(), ref, **tol)
    if want_c0:
        assert torch.equal(c0, c0.mT)
        assert bool((torch.diagonal(c0, dim1=-2, dim2=-1) == 1.0).all())
        torch.testing.assert_close(c0.double(), c0_ref, **tol)


@pytest.mark.parametrize('d', [1, 4, 5, 8, 9, 16, 17, 32])
@pytest.mark.parametrize('same', [True, False])
def test_k3_kernels_at_every_maxd(dev, d, same):
    """Every MAXD instantiation (4, 8, 16, 32) of K3's Gram and VJP, at d
    on both sides of each bound, against the plain versions."""
    x1, x2, ls, amp, nug = _inputs(dev, 300 + d, 97, 70, d, 3)
    if same:
        x2 = x1
    got, c0 = TM5.launch_matern52(x1, x2, ls, amp, nug, same=same,
                                  want_c0=True)
    ref, c0_ref = _k3_target(x1, x2, ls, amp, nug, same, None, None)
    cbar = torch.as_tensor(np.random.default_rng(d).standard_normal(
        (3, 97, x2.shape[0])), device=dev)
    g = TM5.launch_matern52_vjp(x1, x2, ls, amp, nug, same=same, M=cbar)
    g_ref = TM5.matern52_gram_vjp_plain(x1, x2, ls, amp, nug, same=same,
                                        cbar=cbar)
    scale = TM5.matern52_gram_vjp_scale(x1, x2, ls, amp, nug, same=same,
                                        cbar=cbar)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, ref, **F64_TOL)
    torch.testing.assert_close(c0, c0_ref, **F64_TOL)
    _assert_vjp_close(g, g_ref, scale, VJP_BOUND[torch.float64])


def _k3_raw_gram(x1, x2, ls, amp, nug, same, offset):
    """K3's Gram through its C entry into an output `offset` elements past
    an allocation's start (so not 16-byte aligned for offset 1): the stack
    and its C0."""
    from lcgp_tpu_torch.ops._build import build
    q, n1, n2, d = ls.shape[0], x1.shape[0], x2.shape[0], x1.shape[1]
    size = q * n1 * n2
    raw = torch.full((2, size + offset), float('nan'), dtype=x1.dtype,
                     device=x1.device)
    out = raw[0, offset:].view(q, n1, n2)
    c0 = raw[1, offset:].view(q, n1, n2)
    inv = (1.0 / ls).contiguous()
    tag = 'f64' if x1.dtype == torch.float64 else 'f32'
    fn = getattr(build().lib, f'lcgp_matern52_gram_{tag}')
    err = fn(x1.data_ptr(), x2.data_ptr(), inv.data_ptr(), amp.data_ptr(),
             nug.data_ptr(), None, None, int(same), q, n1, n2, d,
             out.data_ptr(), c0.data_ptr(),
             torch.cuda.current_stream(x1.device).cuda_stream)
    assert err == 0
    return out, c0


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same,n1,n2', [(True, 100, 100), (False, 100, 77),
                                        (False, 70, 130)])
def test_k3_gram_misaligned_output(dev, dtype, same, n1, n2):
    """An output 1 element past an aligned start takes the stores without
    bulk copies: the same bits as the aligned launch."""
    x1, x2, ls, amp, nug = (t.to(dtype) for t in
                            _inputs(dev, 400 + n2, n1, n2, 5, 4))
    if same:
        x2 = x1
    a_out, a_c0 = _k3_raw_gram(x1, x2, ls, amp, nug, same, 0)
    m_out, m_c0 = _k3_raw_gram(x1, x2, ls, amp, nug, same, 1)
    torch.cuda.synchronize()
    assert torch.equal(a_out, m_out) and torch.equal(a_c0, m_c0)
    ref, _ = _k3_target(x1.double(), x2.double(), ls.double(), amp.double(),
                        nug.double(), same, None, None)
    tol = F64_TOL if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(m_out.double(), ref, **tol)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_k3_request_split_over_components(dev, dtype):
    """A request's 64 x n cross-covariance: few tiles, so the components
    are split over a second grid dimension."""
    x1, x2, ls, amp, nug = (t.to(dtype) for t in
                            _inputs(dev, 7, 64, 2050, 8, 20))
    got = TM5.matern52_gram(x1, x2, ls, amp, nug, same=False)
    ref = TM5.matern52_gram_plain(*(t.double() for t in (x1, x2, ls, amp,
                                                         nug)), same=False)
    torch.cuda.synchronize()
    tol = F64_TOL if dtype == torch.float64 else dict(rtol=1e-4, atol=1e-6)
    torch.testing.assert_close(got.double(), ref, **tol)


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [31, 33, 63, 64, 65, 129])
def test_k3_vjp_fused_at_stage_edges_is_deterministic(dev, dtype, n):
    """The fused cotangent at n around K3's VJP stage (32) and tile (64):
    two launches give the same bits, within the bound of the f64 plain VJP.
    Odd n loads M element-wise (the path without tensor copies)."""
    x, _, ls, amp, nug = _inputs(dev, 500 + n, n, 1, 8, 3)
    rng = np.random.default_rng(500 + n)
    M = torch.as_tensor(rng.standard_normal((3, n, n)), device=dev)
    w = torch.as_tensor(rng.standard_normal((3, n)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, 3), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x, ls, amp, nug, M, alpha, w)]
    runs = [TM5.matern52_gram_vjp_fused(*cast[:4], M=cast[4], alpha=cast[5],
                                        beta=-0.5, w=cast[6])
            for _ in range(2)]
    ref = TM5.matern52_gram_vjp_fused_plain(x, ls, amp, nug, M=M,
                                            alpha=alpha, beta=-0.5, w=w)
    scale = TM5.matern52_gram_vjp_scale(
        x, x, ls, amp, nug, same=True,
        cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(*runs))
    _assert_vjp_close(runs[0], ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same,n1,n2', [(True, 130, 130), (False, 130, 77),
                                        (False, 65, 256)])
@pytest.mark.parametrize('misaligned', [False, True])
def test_k3_vjp_generic_cotangent(dev, dtype, same, n1, n2, misaligned):
    """Any cotangent, same-point (non-symmetric) or cross, with M aligned or
    one element past an aligned start (then loaded element-wise): against
    the f64 plain VJP, and a misaligned M gives the aligned M's bits."""
    x1, x2, ls, amp, nug = _inputs(dev, 600 + n2, n1, n2, 6, 4)
    if same:
        x2 = x1
    cbar = torch.as_tensor(np.random.default_rng(n1).standard_normal(
        (4, n1, n2)), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x1, x2, ls, amp, nug)]
    Mc = cbar.to(dtype).contiguous()
    got = TM5.launch_matern52_vjp(*cast, same=same, M=Mc)
    if misaligned:
        buf = torch.empty(Mc.numel() + 1, dtype=dtype, device=dev)
        Mm = buf[1:].view(Mc.shape)
        Mm.copy_(Mc)
        again = TM5.launch_matern52_vjp(*cast, same=same, M=Mm)
        torch.cuda.synchronize()
        assert all(torch.equal(u, v) for u, v in zip(got, again))
    ref = TM5.matern52_gram_vjp_plain(x1, x2, ls, amp, nug, same=same,
                                      cbar=cbar)
    scale = TM5.matern52_gram_vjp_scale(x1, x2, ls, amp, nug, same=same,
                                        cbar=cbar)
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same', [True, False])
def test_k3_vjp_c0_is_the_forwards_bit_for_bit(dev, dtype, same):
    """With nug = 0 and a one-hot cotangent at (i, j), gamp[k] is the single
    term C0[k, i, j] that the VJP recomputed: it must equal the forward's
    C0 exactly, at entries of several tiles and stages."""
    n1, n2 = 150, (150 if same else 97)
    x1, x2, ls, amp, _ = (t.to(dtype) for t in
                          _inputs(dev, 700, n1, n2, 8, 3))
    if same:
        x2 = x1
    nug = torch.zeros(3, dtype=dtype, device=dev)
    _, c0 = TM5.launch_matern52(x1, x2, ls, amp, nug, same=same,
                                want_c0=True)
    for i, j in ((0, 1), (37, 5), (140, 96), (70, 64), (33, 31)):
        M = torch.zeros((3, n1, n2), dtype=dtype, device=dev)
        M[:, i, j] = 1.0
        gamp = TM5.launch_matern52_vjp(x1, x2, ls, amp, nug, same=same,
                                       M=M)[1]
        torch.cuda.synchronize()
        assert torch.equal(gamp, c0[:, i, j]), (i, j)


def test_k3_f32_underflow_gives_zero_c0_and_finite_gradients(dev):
    """f32 distances far past the lengthscales: the decay underflows to 0
    (and the factors' product overflows), so C0 is 0 and the VJP's
    lengthscale terms are 0 by select, never inf * 0."""
    x1, x2, _, amp, nug = _inputs(dev, 800, 96, 80, 8, 2, torch.float32)
    x2 = x2 + 50.0
    ls = torch.full((2, 8), 1e-3, dtype=torch.float32, device=dev)
    _, c0 = TM5.launch_matern52(x1, x2, ls, amp, nug, same=False,
                                want_c0=True)
    M = torch.randn((2, 96, 80), dtype=torch.float32, device=dev)
    glens, gamp, gnug = TM5.launch_matern52_vjp(x1, x2, ls, amp, nug,
                                                same=False, M=M)
    torch.cuda.synchronize()
    assert bool((c0 == 0).all())
    for g in (glens, gamp, gnug):
        assert bool(torch.isfinite(g).all())
    assert bool((glens == 0).all()) and bool((gamp == 0).all())


# ---------------------------------------------------------------------------
# K4's VJP on K3's VJP template (csrc/matern52_gram_vjp_kernel.cuh on the SE
# policy: tensor-copy loads into a ring behind mbarriers, 64-tiles in
# 32-row stages, element-wise cp.async where M's rows are not 16-byte
# aligned), and K5 (csrc/gram_vjp_x_kernel.cuh: a persistent column
# reduction over 32 x 64 panels of M): the edges of those designs
# ---------------------------------------------------------------------------


def _misaligned(t):
    """A copy of ``t`` one element past a 16-byte aligned start."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    return out


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('n', [31, 32, 33, 63, 64, 65, 4097])
def test_k4_vjp_fused_at_tile_and_stage_edges_is_deterministic(dev, dtype,
                                                               n):
    """The fused cotangent at n around K4's VJP stage (32) and tile (64),
    and one past config 4's 4096: two launches give the same bits, within
    the bound of the f64 plain VJP.  Odd n loads M element-wise (the path
    without tensor copies)."""
    x, _, ls, amp, nug = _inputs(dev, 900 + n, n, 1, 8, 3)
    rng = np.random.default_rng(900 + n)
    M = torch.as_tensor(rng.standard_normal((3, n, n)), device=dev)
    w = torch.as_tensor(rng.standard_normal((3, n)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, 3), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x, ls, amp, nug, M, alpha, w)]
    before = TR.rbf_gram_vjp.launches
    runs = [TR.rbf_gram_vjp_fused(*cast[:4], M=cast[4], alpha=cast[5],
                                  beta=-0.5, w=cast[6]) for _ in range(2)]
    assert TR.rbf_gram_vjp.launches == before + 2
    ref = TR.rbf_gram_vjp_fused_plain(x, ls, amp, nug, M=M, alpha=alpha,
                                      beta=-0.5, w=w)
    scale = TR.rbf_gram_vjp_scale(x, x, ls, amp, nug, same=True,
                                  cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(*runs))
    _assert_vjp_close(runs[0], ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('d', [1, 2, 3, 8, 9, 17, 32])
@pytest.mark.parametrize('same', [True, False])
def test_k4_vjp_at_every_maxd(dev, d, same):
    """Every MAXD instantiation (2, 4, 8, 16, 32) of K4's VJP, at d on both
    sides of each bound, at a generic cotangent against the plain VJP."""
    x1, x2, ls, amp, nug = _inputs(dev, 950 + d, 97, 70, d, 3)
    if same:
        x2 = x1
    cbar = torch.as_tensor(np.random.default_rng(d).standard_normal(
        (3, 97, x2.shape[0])), device=dev)
    got = TR.launch_rbf_vjp(x1, x2, ls, amp, nug, same=same, M=cbar)
    ref = TR.rbf_gram_vjp_plain(x1, x2, ls, amp, nug, same=same, cbar=cbar)
    scale = TR.rbf_gram_vjp_scale(x1, x2, ls, amp, nug, same=same,
                                  cbar=cbar)
    torch.cuda.synchronize()
    _assert_vjp_close(got, ref, scale, VJP_BOUND[torch.float64])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('same,n1,n2', [(True, 128, 128), (False, 130, 76),
                                        (False, 64, 256)])
def test_k4_vjp_misaligned_cotangent_gives_the_aligned_bits(dev, dtype,
                                                            same, n1, n2):
    """An M one element past an aligned start takes the path without
    tensor copies: the aligned M's bits, within the plain VJP's bound."""
    x1, x2, ls, amp, nug = _inputs(dev, 960 + n2, n1, n2, 5, 4)
    if same:
        x2 = x1
    cbar = torch.as_tensor(np.random.default_rng(n2).standard_normal(
        (4, n1, n2)), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x1, x2, ls, amp, nug)]
    Mc = cbar.to(dtype).contiguous()
    got = TR.launch_rbf_vjp(*cast, same=same, M=Mc)
    again = TR.launch_rbf_vjp(*cast, same=same, M=_misaligned(Mc))
    ref = TR.rbf_gram_vjp_plain(x1, x2, ls, amp, nug, same=same, cbar=cbar)
    scale = TR.rbf_gram_vjp_scale(x1, x2, ls, amp, nug, same=same,
                                  cbar=cbar)
    torch.cuda.synchronize()
    assert all(torch.equal(u, v) for u, v in zip(got, again))
    _assert_vjp_close(got, ref, scale, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('d', [1, 8])
def test_k4_vjp_where_the_decay_underflows_matches_plain(dev, dtype, d):
    """Lengthscales so short that the decay's argument runs from 0 past
    -745 (most pairs 0, some subnormal): the lean loop's exp (its table,
    its two-step scaling below -708.4 and its 0 below -745.2) and the
    general loop's exp give finite sums within the plain f64 VJP's bound,
    fused and at a random same-point cotangent."""
    n, q = 320, 3
    rng = np.random.default_rng(940 + d)
    x = torch.as_tensor(rng.uniform(0, 1.5, (n, d)), device=dev)
    ls = torch.as_tensor(np.full((q, d), 0.03 * np.sqrt(d)), device=dev)
    amp = torch.as_tensor(rng.uniform(0.5, 3.0, q), device=dev)
    nug = torch.as_tensor(rng.uniform(1e-6, 0.1, q), device=dev)
    M = torch.as_tensor(rng.standard_normal((q, n, n)), device=dev)
    w = torch.as_tensor(rng.standard_normal((q, n)), device=dev)
    alpha = torch.as_tensor(rng.uniform(0.1, 5.0, q), device=dev)
    cast = [t.to(dtype).contiguous() for t in (x, ls, amp, nug, M, alpha, w)]
    fused = TR.rbf_gram_vjp_fused(*cast[:4], M=cast[4], alpha=cast[5],
                                  beta=-0.5, w=cast[6])
    generic = TR.launch_rbf_vjp(cast[0], *cast[:4], same=True, M=cast[4])
    ref_f = TR.rbf_gram_vjp_fused_plain(x, ls, amp, nug, M=M, alpha=alpha,
                                        beta=-0.5, w=w)
    ref_g = TR.rbf_gram_vjp_plain(x, x, ls, amp, nug, same=True, cbar=M)
    sc_f = TR.rbf_gram_vjp_scale(x, x, ls, amp, nug, same=True,
                                 cbar=TM.fused_cotangent(M, alpha, -0.5, w))
    sc_g = TR.rbf_gram_vjp_scale(x, x, ls, amp, nug, same=True, cbar=M)
    torch.cuda.synchronize()
    _assert_vjp_close(fused, ref_f, sc_f, VJP_BOUND[dtype])
    _assert_vjp_close(generic, ref_g, sc_g, VJP_BOUND[dtype])


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_k4_vjp_nan_cotangent_gives_nan(dev, dtype):
    x, _, ls, amp, nug = (t.to(dtype) for t in _inputs(dev, 970, 96, 1, 4, 2))
    M = torch.full((2, 96, 96), float('nan'), dtype=dtype, device=dev)
    out = TR.launch_rbf_vjp(x, x, ls, amp, nug, same=True, M=M)
    torch.cuda.synchronize()
    assert all(bool(torch.isnan(g).all()) for g in out)


def _k5_check(fam, x1, x2, ls, amp, nug, M):
    """K5 twice on (x1, x2, M): the same bits, within VJP_BOUND of the
    magnitude of each entry's terms of the f64 plain version; returns the
    output."""
    dtype = x1.dtype
    before = fam.vjp_x.launches
    got = fam.vjp_x(x1, x2, ls, amp, nug, M=M)
    again = fam.vjp_x(x1, x2, ls, amp, nug, M=M)
    args = [t.double() for t in (x1, x2, ls, amp, nug)]
    ref = fam.vjp_x_plain(*args, M=M.double())
    scale = fam.scale_x(*args, M=M.double())
    torch.cuda.synchronize()
    assert fam.vjp_x.launches == before + 2
    assert got.shape == (x2.shape[0], x1.shape[1]) and got.dtype == dtype
    assert torch.equal(got, again)
    err = (got.double() - ref).abs()
    assert bool((err <= VJP_BOUND[dtype] * scale).all()), float(err.max())
    return got


@pytest.mark.parametrize('kind', FAMILY_KINDS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
@pytest.mark.parametrize('q,n1,n2,d', [(2, 700, 512, 2), (2, 300, 1024, 2),
                                       (3, 20, 256, 2), (2, 5, 77, 3),
                                       (2, 200, 96, 17), (2, 150, 64, 32)])
def test_k5_at_wide_short_and_deep_shapes(dev, kind, dtype, q, n1, n2, d):
    """K5 at m = 512 and 1024 (more columns than a block has threads), at
    n1 below one 32-row panel (20, and 5 with a ragged m), and at d = 17
    and 32, with coincident points."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    x1, x2, ls, amp, nug = _inputs(dev, 980 + d, n1, n2, d, q, dtype)
    x2[:3] = x1[:3]
    M = torch.randn((q, n1, n2), generator=torch.Generator(
        device=dev).manual_seed(n2), dtype=dtype, device=dev)
    _k5_check(FAMILIES[kind], x1, x2, ls, amp, nug, M)


@pytest.mark.parametrize('kind', FAMILY_KINDS)
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_k5_on_kmm_with_coincident_points(dev, kind, dtype):
    """Kmm's square shape, (q, m, m) with x1 = x2 = z and ten repeated
    points, in x2 and (through the transposed cotangent, as GramFn makes
    it) in x1; with a diagonal cotangent every term has S = 0, so K5
    gives exactly 0."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES[kind]
    z, _, ls, amp, nug = _inputs(dev, 990, 256, 1, 2, 4, dtype)
    z[100:110] = z[:10]
    M = torch.randn((4, 256, 256), generator=torch.Generator(
        device=dev).manual_seed(990), dtype=dtype, device=dev)
    _k5_check(fam, z, z, ls, amp, nug, M)
    _k5_check(fam, z, z, ls, amp, nug, M.mT.contiguous())
    eye = torch.eye(256, dtype=dtype, device=dev).expand(4, 256, 256)
    out = fam.vjp_x(z, z, ls, amp, nug, M=eye.contiguous())
    torch.cuda.synchronize()
    assert bool((out == 0).all())


@pytest.mark.parametrize('kind', FAMILY_KINDS)
def test_k5_nan_cotangent_gives_nan(dev, kind):
    from lcgp_tpu_torch.ops.launch import FAMILIES
    x1, x2, ls, amp, nug = _inputs(dev, 995, 300, 128, 2, 3)
    M = torch.full((3, 300, 128), float('nan'), dtype=torch.float64,
                   device=dev)
    out = FAMILIES[kind].vjp_x(x1, x2, ls, amp, nug, M=M)
    torch.cuda.synchronize()
    assert bool(torch.isnan(out).all())


@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_k5_misaligned_cotangent_gives_the_aligned_bits(dev, dtype):
    """An M one element past an aligned start takes the path without
    tensor copies: the same bits as the aligned launch."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES['matern52']
    x1, x2, ls, amp, nug = _inputs(dev, 997, 1000, 256, 2, 4, dtype)
    M = torch.randn((4, 1000, 256), generator=torch.Generator(
        device=dev).manual_seed(997), dtype=dtype, device=dev)
    got = _k5_check(fam, x1, x2, ls, amp, nug, M)
    again = fam.vjp_x(x1, x2, ls, amp, nug, M=_misaligned(M))
    torch.cuda.synchronize()
    assert torch.equal(got, again)


# ---------------------------------------------------------------------------
# the prediction server on captured CUDA graphs (lcgp_tpu_torch/serve.py)
# ---------------------------------------------------------------------------

SERVE_KINDS = ['matern32', 'matern52', 'rbf']
# each kind's Gram kernel in a profiler trace: its template and its policy
GRAM_KERNEL_NAMES = {'matern32': ('gram_kernel', 'Matern32'),
                     'matern52': ('gram_staged_kernel', 'Matern52'),
                     'rbf': ('gram_kernel', 'SE')}


def _serve_model(dev, mode, kind='matern32', seed=0, shift=0.0):
    """A small model of each serving branch on ``dev`` at moderate
    parameters: 'full', 'rep' (1-3 replicates a site) or 'fitc' (m=24)."""
    from lcgp_tpu_torch import convert
    rng = np.random.default_rng(seed)
    n, d, p = 200, 3, 6
    xu = rng.uniform(0, 1, (n, d))
    t = np.linspace(0, 1, p)[:, None]
    f = np.sin(2 * np.pi * (t + xu[:, :1].T)) * xu[:, 1:2].T \
        + np.cos(np.pi * t * xu[:, 2:].T)
    x, y = xu, f
    if mode == 'rep':
        reps = rng.integers(1, 4, n)
        x, y = np.repeat(xu, reps, axis=0), np.repeat(f, reps, axis=1)
    y = y + 0.05 * rng.standard_normal(y.shape)
    m = lcgp_tpu_torch.LCGP(y, x, q=3, kernel=kind,
                            submethod='rep' if mode == 'rep' else 'full',
                            inducing=24 if mode == 'fitc' else None,
                            device=dev)
    free = [np.asarray(v.cpu()) for v in m._free]
    free[0] = rng.uniform(-1.0, 0.5, free[0].shape)
    free[1] = rng.uniform(0.0, 1.0, free[1].shape) + shift
    m.free = convert.free_params_from_numpy(*free, dev)
    return m


def _kernel_names(fn):
    """Names of the CUDA kernels torch.profiler saw in one call of fn."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    return [e.key for e in prof.key_averages()
            if e.device_type == torch.autograd.DeviceType.CUDA]


def _normwise(got, ref, tol):
    for g, r in zip(got, ref):
        r = np.asarray(r)
        np.testing.assert_allclose(g, r, rtol=0,
                                   atol=tol * max(np.abs(r).max(), 1e-300))


@pytest.mark.parametrize('kind', SERVE_KINDS)
@pytest.mark.parametrize('mode', ['full', 'rep', 'fitc'])
def test_served_graph_matches_eager_step_and_model(dev, mode, kind):
    """One replay of the captured predict graph against the eager fused
    step at the same batch shape (within 1e-12 of each output's largest
    entry) and the model's own predict; the kind's Gram kernel was
    launched at capture and runs inside the replay."""
    from lcgp_tpu_torch.ops.launch import family
    from lcgp_tpu_torch.serve import PredictServer
    m = _serve_model(dev, mode, kind)
    counter = family(kind).gram
    before = counter.launches
    srv = PredictServer(m, batch_size=32, warmup=False)
    try:
        assert srv._fn.graph is not None
        assert counter.launches - before >= 2    # the eager call + capture
        x0 = np.random.default_rng(1).uniform(0, 1, (32, 3))
        fn = srv._live
        got = fn(x0)
        _normwise(got, fn.eager(x0), 1e-12)
        ref = [o.cpu().numpy() for o in m.predict(x0)]
        _normwise(srv.predict(x0[:20]), [r[:, :20] for r in ref], 1e-10)
        template, policy = GRAM_KERNEL_NAMES[kind]
        launched = counter.launches
        names = _kernel_names(lambda: fn(x0))
        assert counter.launches == launched       # a replay runs no Python
        assert any(template in k and policy in k for k in names), names
    finally:
        srv.shutdown()


def test_served_fullcov_graph_matches_model(dev):
    from lcgp_tpu_torch.serve import PredictServer
    m = _serve_model(dev, 'full')
    srv = PredictServer(m, batch_size=8, warmup=False)
    try:
        x0 = np.random.default_rng(2).uniform(0, 1, (11, 3))
        got = srv.predict_fullcov(x0)
        assert srv._fn_fullcov.graph is not None
        ref = [o.cpu().numpy() for o in m.predict(x0, return_fullcov=True)]
        _normwise(got, ref, 1e-10)
    finally:
        srv.shutdown()


def test_same_shape_reload_captures_nothing(dev):
    """A same-shape reload copies the new state into the graph's tensors:
    reused, no capture logged, the new model served; a reload of another
    signature logs exactly one capture."""
    from lcgp_tpu_torch.serve import PredictServer
    from lcgp_tpu_torch.utils.profiling import log_compiles
    m1, m2 = _serve_model(dev, 'full'), _serve_model(dev, 'full', shift=0.7)
    with log_compiles() as built:
        srv = PredictServer(m1, batch_size=16, warmup=False)
    try:
        assert len([e for e in built if 'CUDA graph' in e[0]]) == 1
        graph = srv._fn.graph
        x0 = np.random.default_rng(3).uniform(0, 1, (16, 3))
        with log_compiles() as events:
            out = srv.reload(m2)
        assert out['reused_executable'] is True and events == []
        assert srv._fn.graph is graph
        _normwise(srv.predict(x0), [o.cpu().numpy() for o in m2.predict(x0)],
                  1e-10)
        m3 = _serve_model(dev, 'full', kind='rbf')
        with log_compiles() as events:
            assert srv.reload(m3)['reused_executable'] is False
        assert [e for e in events if 'CUDA graph' in e[0]] == events
        assert len(events) == 1
        with log_compiles() as events:          # fullcov's own graph, once
            srv.predict_fullcov(x0[:3])
            srv.predict_fullcov(x0[:5])
        assert len(events) == 1 and 'fullcov' in events[0][0]
    finally:
        srv.shutdown()


def test_reload_under_concurrent_requests_is_atomic(dev):
    """Clients fire multi-chunk requests while the model is swapped back
    and forth on the card: none fails, each answer is wholly one model's."""
    import threading
    from lcgp_tpu_torch.serve import PredictServer
    m1, m2 = _serve_model(dev, 'full'), _serve_model(dev, 'full', shift=0.7)
    x0 = np.random.default_rng(4).uniform(0, 1, (40, 3))     # 3 chunks
    refs = [m.predict(x0)[0].cpu().numpy() for m in (m1, m2)]
    srv = PredictServer(m1, batch_size=16, warmup=True)
    stop = threading.Event()
    answers, errors = [], []

    def client():
        try:
            while not stop.is_set():
                answers.append(srv.predict(x0)[0])
        except Exception as e:            # noqa: BLE001
            errors.append(e)
    threads = [threading.Thread(target=client) for _ in range(4)]
    try:
        for t in threads:
            t.start()
        for m in (m2, m1, m2, m1, m2):
            assert srv.reload(m)['reused_executable'] is True
        stop.set()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        stop.set()
        srv.shutdown()
    assert not errors, errors
    for a in answers:
        assert any(np.allclose(a, r, rtol=1e-10, atol=0) for r in refs)


def test_served_state_survives_a_fit_on_the_model(dev):
    from lcgp_tpu_torch.serve import PredictServer
    m = _serve_model(dev, 'full')
    srv = PredictServer(m, batch_size=16, warmup=False)
    try:
        x0 = np.random.default_rng(5).uniform(0, 1, (16, 3))
        before = srv.predict(x0)
        m.fit(method='adam', steps=5, learning_rate=1e-2)
        fitted = [o.cpu().numpy() for o in m.predict(x0)]
        assert not np.allclose(fitted[0], before[0])
        for g, r in zip(srv.predict(x0), before):
            np.testing.assert_array_equal(g, r)
        assert srv.reload(m)['reused_executable'] is True
        _normwise(srv.predict(x0), fitted, 1e-10)
    finally:
        srv.shutdown()


def test_served_model_built_on_an_unindexed_cuda_device(dev):
    """A model built with device='cuda' (no index, LCGP's default) is
    served: the dispatcher takes its device from the state tensors."""
    import threading
    from lcgp_tpu_torch.serve import PredictServer
    m = _serve_model('cuda', 'full')
    assert m.device.index is None
    srv = PredictServer(m, batch_size=16, warmup=False)
    try:
        x0 = np.random.default_rng(6).uniform(0, 1, (21, 3))
        out = {}
        t = threading.Thread(target=lambda: out.update(r=srv.predict(x0)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive() and srv._dispatcher.is_alive()
        _normwise(out['r'], [o.cpu().numpy() for o in m.predict(x0)], 1e-10)
    finally:
        srv.shutdown()


def test_spans_on_the_cuda_profilers_clock(dev, tmp_path):
    """Under torch.profiler with CUDA activity: every graph replay of the
    server is one lcgp.serve.replay span, ending within 100 us of its
    cudaGraphLaunch, and main-thread spans start and end within 100 us of
    their record_function twins (medians over the replays and over 20
    spans: a record_function call now and then takes ~100-300 us to enter
    or leave, the first of a session always)."""
    import json
    from torch.profiler import ProfilerActivity, profile
    from lcgp_tpu_torch.serve import PredictServer
    from lcgp_tpu_torch.utils import profiling
    m = _serve_model(dev, 'full')
    srv = PredictServer(m, batch_size=16, warmup=True)
    eye = torch.eye(64, dtype=torch.float64, device=dev) * 2.0
    try:
        x0 = np.random.default_rng(7).uniform(0, 1, (40, 3))    # 3 chunks
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            with profiling.span('lcgp.test.first'):
                pass
            for _ in range(20):
                with profiling.span('lcgp.test.main'):
                    torch.linalg.cholesky(eye)
                    torch.cuda.synchronize()
            for _ in range(20):
                srv.predict(x0)
            torch.cuda.synchronize()
        path = tmp_path / 'trace.json'
        prof.export_chrome_trace(str(path))
    finally:
        srv.shutdown()
    spans = profiling.spans()
    chrome = json.loads(path.read_text())
    base = int(chrome.get('baseTimeNanoseconds', 0))
    events = [e for e in chrome['traceEvents'] if e.get('ph') == 'X']
    launches = sorted(e['ts'] + e['dur'] for e in events
                      if e['name'] == 'cudaGraphLaunch')
    replays = sorted((s.end - base) / 1e3 for s in spans
                     if s.name == 'lcgp.serve.replay')
    assert len(replays) == len(launches) == 60
    assert len([s for s in spans if s.name == 'lcgp.serve.dispatch']) == 60
    gaps = [b - a for a, b in zip(replays, launches)]
    print('replay end - graph launch end (us): median', np.median(gaps),
          'range', min(gaps), max(gaps))
    assert abs(np.median(gaps)) < 100.0
    mains = sorted((s for s in spans if s.name == 'lcgp.test.main'),
                   key=lambda s: s.start)
    twins = sorted((e for e in events if e['name'] == 'lcgp.test.main'
                    and e.get('cat') == 'user_annotation'),
                   key=lambda e: e['ts'])
    assert len(mains) == len(twins) == 20
    starts = [(s.start - base) / 1e3 - e['ts'] for s, e in zip(mains, twins)]
    ends = [(s.end - base) / 1e3 - e['ts'] - e['dur']
            for s, e in zip(mains, twins)]
    print('main span - twin (us): start median', np.median(starts), 'range',
          min(starts), max(starts), '; end median', np.median(ends),
          'range', min(ends), max(ends))
    assert abs(np.median(starts)) < 100.0 and abs(np.median(ends)) < 100.0


# ---------------------------------------------------------------------------
# The mesh paths (lcgp_tpu_torch/parallel) on the card
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('kind', ['matern32', 'matern52', 'rbf'])
@pytest.mark.parametrize('dtype', [torch.float64, torch.float32])
def test_block_row_gram_and_cross_vjp_at_a_ragged_block(dev, kind, dtype):
    """The n-sharded path's kernel shapes: a rank's Gram rows (q, nb, n)
    through the Gram kernel's cross mode, and the VJP in cross mode at an
    explicit cotangent of that shape, at a ragged block (nb = 333 of
    n = 999), against the plain versions."""
    from lcgp_tpu_torch.ops.launch import FAMILIES
    fam = FAMILIES[kind]
    x, _, ls, amp, nug = _inputs(dev, 77, 999, 1, 8, 5, dtype)
    xblk = x[333:666].contiguous()
    got = fam.gram(xblk, x, ls, amp, nug, same=False)
    args = [t.double() for t in (xblk, x, ls, amp, nug)]
    ref = fam.plain(*args, same=False)
    M = torch.randn((5, 333, 999), generator=torch.Generator(
        device=dev).manual_seed(7), dtype=dtype, device=dev)
    gv = fam.launch_vjp(xblk, x, ls, amp, nug, same=False, M=M)
    ref_v = fam.vjp_plain(*args, same=False, cbar=M.double())
    scale = fam.scale(*args, same=False, cbar=M.double())
    torch.cuda.synchronize()
    tol = 1e-12 if dtype == torch.float64 else 1e-5
    torch.testing.assert_close(got.double(), ref, rtol=tol, atol=tol)
    _assert_vjp_close(gv, ref_v, scale, VJP_BOUND[dtype])


def _mesh_problem(n=300, p=12, q=3, d=3, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = (np.sin(3 * x[:, :1].T + np.linspace(0, 2, p)[:, None])
         + 0.05 * rng.standard_normal((p, n)))
    return x, y, rng.uniform(0, 1, (16, d))


def _single_device(dev, x, y, x0, **ctor):
    m = lcgp_tpu_torch.LCGP(y=y, x=x, device=dev, **ctor)
    free = [t.cpu().numpy() for t in m.free]
    leaves = type(m.free)(*(t.clone().requires_grad_(True) for t in m.free))
    m_loss = (m.neglpost_rep if m.submethod == 'rep' else m.neglpost)
    m._free = leaves
    v = m_loss()
    grads = [g.cpu().numpy() for g in torch.autograd.grad(v, leaves)]
    m.free = free
    preds = [t.cpu().numpy() for t in m.predict(x0)]
    return free, float(v.detach()), grads, preds


def _mesh_vs_single(group, dev, spec, **ctor):
    from lcgp_tpu_torch.parallel import tasks
    x, y, x0 = _mesh_problem()
    free, v, grads, preds = _single_device(dev, x, y, x0, **ctor)
    results = group.run(tasks.model, spec, x, y, ctor, [
        ('set_free', free), ('set_mesh', None), ('loss', None),
        ('predict', x0)], device=str(dev))
    for r in results:
        _, _, loss, got = r
        np.testing.assert_allclose(loss, v, rtol=1e-9)
        for g, ref in zip(got, preds):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-7 * np.abs(ref).max())
    data = {k: t.cpu().numpy() for k, t in
            lcgp_tpu_torch.LCGP(y=y, x=x, device=dev,
                                **ctor)._data._asdict().items()}
    for r in group.run(tasks.loss_and_grad, spec, data, free,
                       device=str(dev)):
        np.testing.assert_allclose(r[0], v, rtol=1e-9)
        for g, ref in zip(r[1], grads):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_nccl_world_of_one_n_mesh_matches_single_device(dev, submethod):
    """A one-rank NCCL group on the card: the n-mesh loss, gradient and
    predictions against the single-device path on the card."""
    from lcgp_tpu_torch.parallel import WorkerGroup
    with WorkerGroup(1, device=str(dev), backend='nccl', timeout=300) as g:
        _mesh_vs_single(g, dev, ('n', 1), q=3, submethod=submethod)


def test_two_gloo_ranks_sharing_the_card(dev):
    """Two gloo ranks that compute on one card, their collectives staged
    through the host: the ('n',) and the ('comp','n') meshes against the
    single-device path."""
    from lcgp_tpu_torch.parallel import WorkerGroup
    with WorkerGroup(2, device=str(dev), backend='gloo', timeout=300) as g:
        _mesh_vs_single(g, dev, ('n', 2), q=3)
        _mesh_vs_single(g, dev, ('nc', 2, 1), q=3)


def test_worker_group_defaults_to_the_card(dev):
    """WorkerGroup and the dryrun default to this process's card: NCCL
    takes one card per rank, so ranks sharing it must ask for gloo."""
    from lcgp_tpu_torch.parallel import WorkerGroup
    with pytest.raises(ValueError, match="backend='gloo'"):
        WorkerGroup(2)
    with WorkerGroup(1, timeout=300) as g:
        assert g.device == torch.device('cuda', torch.cuda.current_device())


def test_dryrun_multichip_on_the_card(dev):
    """The dryrun's default: two gloo ranks sharing the card, every mesh
    mode against one device on the card."""
    from lcgp_tpu_torch.parallel import dryrun
    got = dryrun.dryrun_multichip(2)
    assert got['modes'] == ['comp_out', 'n', 'fitc_n']


def _fitc_mesh_vs_single(group, dev, spec, **ctor):
    """n-sharded FITC on the card against one device's FITC on the card:
    the loss (rtol 1e-9), the gradient in (free, z) (1e-8 of each leaf's
    largest entry) and the predictions (1e-7 of each output's largest)."""
    from lcgp_tpu_torch.parallel import tasks
    x, y, x0 = _mesh_problem()
    ctor = dict(q=3, inducing=24, **ctor)
    m = lcgp_tpu_torch.LCGP(y=y, x=x, device=dev, **ctor)
    free = [t.cpu().numpy() for t in m.free]
    z = m._z.cpu().numpy()
    leaves = type(m.free)(*(t.clone().requires_grad_(True) for t in m.free))
    zt = m._z.clone().requires_grad_(True)
    v = m._fitc_loss(m._compute_dtype)(leaves, zt)
    grads = [g.cpu().numpy() for g in torch.autograd.grad(v, [*leaves, zt])]
    preds = [t.cpu().numpy() for t in m.predict(x0)]
    for r in group.run(tasks.model, spec, x, y, ctor, [
            ('set_free', free), ('set_mesh', None), ('z', None),
            ('loss', None), ('predict', x0)], device=str(dev)):
        _, _, zr, loss, got = r
        np.testing.assert_array_equal(zr, z)
        np.testing.assert_allclose(loss, float(v.detach()), rtol=1e-9)
        for g, ref in zip(got, preds):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-7 * np.abs(ref).max())
    data = {k: t.cpu().numpy() for k, t in m._data._asdict().items()}
    for r in group.run(tasks.fitc_loss_and_grad, spec, data, free, z,
                       device=str(dev), with_z=True):
        np.testing.assert_allclose(r[0], float(v.detach()), rtol=1e-9)
        for g, ref in zip(r[1], grads):
            np.testing.assert_allclose(g, ref, rtol=0,
                                       atol=1e-8 * np.abs(ref).max())


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_fitc_nccl_world_of_one_n_mesh_matches_single_device(dev,
                                                             submethod):
    """n-sharded FITC on a one-rank NCCL group on the card: the loss, its
    gradient in (free, z) through K1, K2 and K5, and the predictions."""
    from lcgp_tpu_torch.parallel import WorkerGroup
    with WorkerGroup(1, device=str(dev), backend='nccl', timeout=300) as g:
        _fitc_mesh_vs_single(g, dev, ('n', 1), submethod=submethod)


def test_fitc_two_gloo_ranks_sharing_the_card(dev):
    """n-sharded FITC on two gloo ranks computing on one card: the ('n',)
    and the ('comp','n') meshes against one device."""
    from lcgp_tpu_torch.parallel import WorkerGroup
    with WorkerGroup(2, device=str(dev), backend='gloo', timeout=300) as g:
        _fitc_mesh_vs_single(g, dev, ('n', 2))
        _fitc_mesh_vs_single(g, dev, ('nc', 2, 1))


@pytest.mark.parametrize('fitc', [False, True], ids=['exact', 'fitc'])
def test_served_mesh_model_on_the_card(dev, fitc):
    """A mesh model served on two gloo ranks sharing the card: the first
    rank serves (the exact model's step eager, FITC's a captured graph),
    the second follows; the answers equal the mesh ``model.predict``
    (1e-10 of each output's largest entry), concurrent clients share
    dispatches, and a collective reload serves the new parameters."""
    from lcgp_tpu_torch.parallel import WorkerGroup, tasks
    x, y, x0 = _mesh_problem()
    ctor = dict(q=3, inducing=24) if fitc else dict(q=3)
    free = [t.cpu().numpy() for t in lcgp_tpu_torch.LCGP(
        y=y, x=x, device=dev, **ctor).free]
    free2 = [a + 0.1 for a in free]
    with WorkerGroup(2, device=str(dev), backend='gloo', timeout=300) as g:
        lead, follower = g.run(tasks.serve_mesh, ('n', 2), x, y, ctor, free,
                               x0, device=str(dev), reload_free=free2)
    assert follower['followed'] and 'follow()' in follower['follower_predict']
    assert lead['dispatches'] < len(lead['clients'])
    for got, ref in ((lead['served'], lead['ref']),
                     (lead['served_reload'], lead['ref_reload'])):
        for a, b in zip(got, ref):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-10 * np.abs(b).max())


def test_fast_fitc_at_config7s_field_within_the_references_error(dev):
    """One device's 'fast' FITC on the first 100,000 rows of config 7's
    field (config 7's inducing points; the smallest of 100k, 200k and 400k
    rows at which the card's single f32 GEMM for G = W^T Lam~^-1 W showed:
    loss 4.8e-3 off f64) against the card's own f64 at the init: the loss,
    each gradient leaf and the 64-point predictions within
    ``chip_smoke.fitc7_fast_bounds(100_000)``: 4x the reference's own
    'fast' error at these 100,000 rows, capped at FITC7_FAST_BOUNDS."""
    import chip_smoke as cs
    x, y, x0, z = cs.fitc7_inputs()
    n = 100_000
    res = {}
    for precision in ('fast', 'high'):
        m = cs.fitc7_model(dev, x[:n], y[:, :n], z, precision=precision)
        v, g, flat = cs.fitc_loss_grad(m, with_z=False)
        res[precision] = (float(v), g, cs.model_outs(m, x0))
        del m
        torch.cuda.empty_cache()
    bounds = cs.fitc7_fast_bounds(n)
    errs = cs.fast_vs_f64_check("config 7's field, n=100,000",
                                res['fast'], res['high'], flat,
                                bounds=bounds)
    for k, bound in bounds.items():
        assert errs[k] <= bound, (k, errs[k], bound)


def test_fast_fitc_along_a_fit_within_4x_the_references_recipe(dev):
    """Config 7's field at 100,000 rows (``h100_bench``'s data for
    ``configs/fitc_n400k_m512_lbfgsb.json``, rows ordered by one seed), a
    'fast' scipy fit of 4 iterations: at the init and at each iterate the
    model's 'fast' loss is within 4x the error of the benchmark
    reference's recipe (f32 products, f64 block sums; the largest of its
    errors up to that iterate) of the reference's f64 loss, per output
    entry.  Through u (before the one pass) the loss left f64 by 3.4e-4
    after one iteration at config 7 where the recipe stays under 6e-6."""
    import json
    import sys
    from pathlib import Path
    bench = Path(__file__).resolve().parents[1] / 'h100_bench'
    sys.path[:0] = [str(bench)]
    from hb import Context, build_model, data_for, inducing_points
    from hb.manifest import Manifest
    from reference import lcgp_ref as R
    refit = Manifest().kind('refit')
    cfg = {**json.loads((bench / 'configs/fitc_n400k_m512_lbfgsb.json')
                        .read_text()), 'n': 100_000}
    ctx = Context(name='pin', cell={}, cfg=cfg, traffic={}, limits={},
                  kind=refit, seed=3000001899, seconds=0.0, traced=False,
                  device=dev, t_start=0.0)
    ctx.x, ctx.y = data_for(ctx)
    model = build_model(ctx)
    ctx.free0 = tuple(t.detach().clone() for t in model.free)
    fit = refit.run_fit(ctx, model, 4)
    assert fit['nit'] >= 3
    del model
    torch.cuda.empty_cache()
    prob = R.prepare(ctx.x, ctx.y, int(cfg['model']['q']))
    th0 = R.init_free(prob)
    z = inducing_points(ctx, prob)
    per = cfg['n'] * cfg['p']
    ref64 = refit.lossfn(ctx, prob, z)
    ref32 = refit.lossfn(ctx, prob, z, torch.float32, False)
    recipe = 0.0
    for it, (loss, vec) in sorted(fit['iters'].items()):
        free = R.unflat(vec, th0)
        want = ref64(free)[0]
        recipe = max(recipe, abs(ref32(free)[0] - want) / per)
        err = abs(loss - want) / per
        assert err <= 4.0 * recipe, (it, err, recipe)


def test_device_spans_time_the_stream(dev):
    """A device span on the card reads its block's time on the stream
    (CUDA events) when ``spans()`` is read; the host's time of an
    asynchronous launch is far shorter."""
    from torch.profiler import ProfilerActivity, profile
    from lcgp_tpu_torch.utils import profiling
    a = torch.randn((4096, 4096), device=dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU]):
        with profiling.device_span('lcgp.test', dev):
            for _ in range(8):
                a = a @ a.mT / 64.0
    (s,) = profiling.spans()
    host_ns = s.end - s.start
    assert s.device_ns is not None and s.device_ns > 0
    start, end = torch.cuda.Event(True), torch.cuda.Event(True)
    start.record()
    for _ in range(8):
        a = a @ a.mT / 64.0
    end.record()
    end.synchronize()
    alone = start.elapsed_time(end) * 1e6
    assert 0.5 * alone <= s.device_ns <= 2.0 * alone + 1e5, (s.device_ns,
                                                             alone, host_ns)
