"""Tests of the port that need a CUDA card (marker ``gpu``).

K1 (``lcgp_tpu_torch/csrc/matern32_gram.cu``) is a CUDA kernel with no CPU
mode, so these skip without a card.  This file imports neither JAX nor
``tests/conftest.py``'s JAX setup, so it runs on a machine that has only
PyTorch:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py -q
"""
import numpy as np
import pytest
import torch

import lcgp_tpu_torch
from lcgp_tpu_torch.ops import matern as TM

F64_TOL = dict(rtol=1e-12, atol=1e-14)

pytestmark = pytest.mark.gpu


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: K1 is a CUDA kernel with no CPU mode')
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
