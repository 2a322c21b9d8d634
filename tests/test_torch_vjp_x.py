"""K5's contract, the Gram stack's VJP in the points, against lcgp_tpu.

``FAMILIES[kind].vjp_x_plain`` (the plain PyTorch version that K5,
``lcgp_tpu_torch/csrc/gram_vjp_x.cu``, is held to on the card) against
``jax.vjp`` of ``lcgp_tpu.ops.gram.gram_stack`` in its second operand, at
a random cotangent, float64 on the CPU, for every kernel kind:

- a cross shape (n = 60, m = 17, d = 3), as FITC's Knm;
- Kmm's square shape with coincident points (its diagonal and three
  repeated points), in x2, and in x1 through the transposed call
  ``vjp_x(x2, x1, M^T)`` that ``lcgp_tpu_torch/ops/gram.py`` makes.

Each entry is held to 1e-10 of ``scale_x``, the sum of its terms'
magnitudes (the sums cancel, so an rtol on the result would say nothing;
the JAX side's squared-exponential Gram goes through the GEMM form of the
squared distance, whose cancellation leaves ~eps |u|^2 in C0), and
``|vjp_x_plain| <= scale_x`` holds entry by entry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from lcgp_tpu.ops.gram import gram_stack
from lcgp_tpu_torch.ops.launch import FAMILIES

torch.set_num_threads(1)  # pytest -n workers share the host's cores

BOUND = 1e-10


def _problem(seed, n, m, d, q):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    z = rng.uniform(0, 1, (m, d))
    z[5:8] = z[0:3]                          # coincident points: S = 0
    ls = rng.uniform(0.3, 2.0, (q, d))
    amp = rng.uniform(0.5, 3.0, q)
    nug = rng.uniform(1e-4, 0.1, q)
    return rng, x, z, ls, amp, nug


def _jax_vjp_x(fn, at, cot):
    _, pull = jax.vjp(fn, jnp.asarray(at))
    return np.asarray(pull(jnp.asarray(cot))[0])


@pytest.mark.parametrize('case', ['cross', 'kmm_x2', 'kmm_x1'])
@pytest.mark.parametrize('kind', ['matern32', 'matern52', 'rbf'])
def test_vjp_x_plain_matches_jax(kind, case):
    rng, x, z, ls, amp, nug = _problem(7, 60, 17, 3, 2)
    params = tuple(jnp.asarray(a) for a in (ls, amp, nug))
    fam = FAMILIES[kind]

    def stack(x1, x2):
        return gram_stack(x1, x2, *params, same=False, kind=kind)
    if case == 'cross':
        x1 = x
        M = rng.standard_normal((2, 60, 17))
        ref = _jax_vjp_x(lambda u: stack(jnp.asarray(x), u), z, M)
        Mp = M
    else:
        x1 = z
        M = rng.standard_normal((2, 17, 17))
        if case == 'kmm_x2':
            ref = _jax_vjp_x(lambda u: stack(jnp.asarray(z), u), z, M)
            Mp = M
        else:
            ref = _jax_vjp_x(lambda u: stack(u, jnp.asarray(z)), z, M)
            Mp = np.ascontiguousarray(M.transpose(0, 2, 1))
    args = [torch.tensor(a) for a in (x1, z, ls, amp, nug)]
    Mt = torch.tensor(Mp)
    got = fam.vjp_x_plain(*args, M=Mt)
    scale = fam.scale_x(*args, M=Mt)
    assert got.shape == (17, 3) and got.dtype == torch.float64
    assert bool((scale > 0).all())
    assert bool((got.abs() <= scale).all())
    err = (got - torch.tensor(ref)).abs()
    assert bool((err <= BOUND * scale).all()), float((err / scale).max())
