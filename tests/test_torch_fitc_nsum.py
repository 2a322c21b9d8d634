"""FITC's sums over the n rows of a panel (``lcgp_tpu_torch/models/
sparse.py``: ``_nsum``, ``_einsum_qnm_qn``, the panel solve's gradient in
Lmm) and the 'fast' quadratic term's one pass, on the CPU.

An f32 sum over n runs a product a block of ``G_BLOCK`` rows with the
partials added in f64; an f64 one stays the single product it was, bit
for bit.  A 'fast' FITC loss and its gradient take no f32 product whose
inner dimension is n.
"""
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from lcgp_tpu_torch import LCGP
from lcgp_tpu_torch.models import sparse

F32, F64 = torch.float32, torch.float64
N_RAGGED = 3 * sparse.G_BLOCK + 17


def _operands(q, m, n, k, dtype, seed=0):
    g = torch.Generator().manual_seed(seed)
    A = torch.randn((q, m, n), generator=g, dtype=F64).to(dtype)
    B = torch.randn((q, n, k), generator=g, dtype=F64).to(dtype)
    return A, B


@pytest.mark.parametrize('q,m,k', [(2, 7, 5), (3, 4, 1), (1, 16, 16)])
def test_blocked_sum_matches_the_f64_product(q, m, k):
    """At a ragged n the blocked f32 sum is the f64 product of the same
    f32 inputs to f32 rounding over a block, not over n."""
    A, B = _operands(q, m, N_RAGGED, k, F32)
    got = sparse._nsum(A, B)
    want = A.double() @ B.double()
    assert got.dtype == F64 and got.shape == (q, m, k)
    scale = float((A.double().abs() @ B.double().abs()).max())
    assert float((got - want).abs().max()) <= 4e-7 * scale


def test_wtv_matches_the_f64_product_and_is_f64():
    A, B = _operands(3, 9, N_RAGGED, 1, F32, seed=1)
    W, v = A.mT, B[..., 0]
    got = sparse._einsum_qnm_qn(W, v)
    want = torch.einsum('qnm,qn->qm', W.double(), v.double())
    assert got.dtype == F64
    scale = float(torch.einsum('qnm,qn->qm', W.double().abs(),
                               v.double().abs()).max())
    assert float((got - want).abs().max()) <= 4e-7 * scale


@pytest.mark.parametrize('which', [0, 1])
def test_blocked_sum_gradient_is_the_plain_products(which):
    A, B = _operands(2, 6, N_RAGGED, 3, F32, seed=2)
    C = torch.randn((2, 6, 3), generator=torch.Generator().manual_seed(3),
                    dtype=F64)
    grads = []
    for fn in (sparse._nsum, lambda a, b: (a @ b).to(F64)):
        a, b = A.clone().requires_grad_(), B.clone().requires_grad_()
        (fn(a, b) * C).sum().backward()
        grads.append((a.grad, b.grad)[which])
    got, want = grads
    assert got.dtype == F32
    torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize('case', ['nsum', 'wtv'])
def test_f64_keeps_the_single_products_bits(case):
    A, B = _operands(2, 6, N_RAGGED, 4, F64, seed=5)
    before = sparse._nsum.blocked
    if case == 'nsum':
        assert torch.equal(sparse._nsum(A, B), A @ B)
    else:
        W, v = A.mT, B[..., 0]
        assert torch.equal(sparse._einsum_qnm_qn(W, v),
                           torch.einsum('qnm,qn->qm', W, v))
    assert sparse._nsum.blocked == before


class _Products(TorchDispatchMode):
    """Records the inner dimension and dtype of every matrix product."""
    OPS = {'mm', 'bmm', 'addmm', 'baddbmm', 'matmul', 'addbmm', 'mv', 'dot'}

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self.OPS:
            a, b = (args[1], args[2]) if name.startswith('add') or \
                name == 'baddbmm' else (args[0], args[1])
            self.seen.append((name, a.shape[-1], a.dtype))
        return func(*args, **(kwargs or {}))


def _fitc_model(precision, n=1100, m=12):
    rng = np.random.default_rng(7)
    x = rng.uniform(0, 1, (n, 2))
    y = (np.sin(2 * np.pi * x[:, :1].T * np.linspace(0.5, 2, 6)[:, None])
         + 0.05 * rng.standard_normal((6, n)))
    return LCGP(y=y, x=x, q=2, inducing=m, n_chunk=0, precision=precision,
                device='cpu')


def _loss_and_grad(model):
    leaves = [t.detach().clone().requires_grad_() for t in model.free]
    model.free = type(model.free)(*leaves)
    model.loss().backward()
    return leaves


def test_fast_loss_and_gradient_sum_over_n_only_through_the_helper():
    model = _fitc_model('fast')
    n = model.n
    counts = (sparse._nsum.blocked, sparse._nsum.backward)
    with _Products() as rec:
        _loss_and_grad(model)
    blocked = sparse._nsum.blocked - counts[0]
    backward = sparse._nsum.backward - counts[1]
    # forward: G and t; backward: theirs, and the panel solve's in Lmm
    assert (blocked, backward) == (3, 2)
    over_n = [s for s in rec.seen if s[1] == n and s[2] == F32]
    assert not over_n, over_n
    # the helper's blocks run: products over G_BLOCK rows and the tail's
    assert any(k == sparse.G_BLOCK for _, k, _ in rec.seen)
    assert any(k == n % sparse.G_BLOCK for _, k, _ in rec.seen)


def test_high_loss_and_gradient_take_no_blocked_sum():
    model = _fitc_model('high')
    counts = (sparse._nsum.blocked, sparse._nsum.backward,
              sparse._nsum.single)
    _loss_and_grad(model)
    assert (sparse._nsum.blocked, sparse._nsum.backward) == counts[:2]
    assert sparse._nsum.single > counts[2]


def test_fast_quadratic_term_is_the_one_pass_of_the_f64_terms():
    """The f32 one pass and the f64 path through u give the same quad and
    ld to f32 rounding at the init."""
    model = _fitc_model('fast')
    free, data, z = model.free, model._data, model._z
    from lcgp_tpu_torch.models import params as P
    lLmb, lLmb0, _, lnug = P.constrain(free)
    lam, b = sparse._full_lam_b(free, data)
    with torch.no_grad():
        got = [sparse._quad_ld(data.xs, z, lLmb, lLmb0, lnug, lam, b, 0,
                               dt, model.kernel) for dt in (F32, None)]
    for a, w in zip(*got):
        torch.testing.assert_close(a, w, rtol=2e-5, atol=0)
