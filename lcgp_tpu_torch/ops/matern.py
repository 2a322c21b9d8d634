"""Matérn 3/2 separable product kernel, batched over latent components
(counterpart of ``lcgp_tpu/ops/matern.py``).

Behavioral contract of the reference ``Matern32`` (reference
covmat.py:5-55), quirks included:

- per-dimension lengthscales ``llmb`` divide the inputs directly (they are
  constrained positive values, not logs);
- ``C0 = prod_j (1 + S_j) * exp(-sum_j S_j)`` with ``S_j = |u_j - v_j|``;
- nugget ``eta = lnug / (1 + lnug)``; the full matrix is
  ``llmb0 * ((1-eta) C0 + eta I)`` when x1 and x2 are *identical*, and
  ``llmb0 * (1-eta) C0`` (no diagonal) for cross-covariances;
- ``diag_only=True`` returns ``llmb0 * ones`` (amplitude only, no nugget),
  and requires x1 ≈ x2.

The Gram and VJP functions are the ``'matern32'`` family's of
``ops/launch.py``.  :func:`matern32_gram` dispatches on the device of its
inputs: CPU tensors go to the plain version :func:`matern32_gram_plain`;
CUDA tensors go to the hand-written kernel ``csrc/matern32_gram.cu`` (K1),
or the call raises.
Every launch of K1 adds one to ``matern32_gram.launches``, and a launch of
its f32 instantiation also to ``matern32_gram.launches_f32``.

Its VJP is dispatched the same way: :func:`matern32_gram_vjp` (any
cotangent) and :func:`matern32_gram_vjp_fused` (the loss's cotangent
``alpha_k M + beta w w^T``, never formed on CUDA) run the plain versions on
CPU tensors and the kernel ``csrc/matern32_gram_vjp.cu`` (K2) on CUDA
tensors.  Every launch of K2 adds one to ``matern32_gram_vjp.launches``
(and, in f32, to ``matern32_gram_vjp.launches_f32``).
"""
from __future__ import annotations

import numpy as np
import torch

from .launch import FAMILIES, fused_cotangent  # fused_cotangent: re-exported

_F = FAMILIES['matern32']
matern32_gram_plain = _F.plain
launch_matern32 = _F.launch
matern32_gram = _F.gram
matern32_gram_vjp_plain = _F.vjp_plain
matern32_gram_vjp_fused_plain = _F.fused_plain
matern32_gram_vjp_scale = _F.scale
launch_matern32_vjp = _F.launch_vjp
matern32_gram_vjp = _F.vjp
matern32_gram_vjp_fused = _F.vjp_fused


def matern32_diag(x0, amplitudes):
    """Batched prior variance at x0: ``amp * 1`` per point.  Returns (q, n0)."""
    amplitudes = torch.atleast_1d(amplitudes)
    n0 = x0.shape[0]
    return amplitudes[:, None] * torch.ones((amplitudes.shape[0], n0),
                                            dtype=amplitudes.dtype,
                                            device=amplitudes.device)


def Matern32(x1, x2, llmb, llmb0, lnug, diag_only: bool = False,
             same: bool | None = None):
    """Single-component kernel with the reference's public signature and
    validation behavior (reference covmat.py:5-55).

    ``same`` overrides the runtime x1 == x2 check.  With ``same=None`` the
    check short-circuits on object identity and otherwise compares shapes
    and then values.
    """
    if same is None and x1 is x2:
        same = True
    x1 = torch.as_tensor(x1)
    x2 = torch.as_tensor(x2, device=x1.device)
    # AssertionError as the reference's asserts raise, explicitly so that
    # the checks survive python -O
    if x1.ndim != 2:
        raise AssertionError(
            'input x1 should be 2-dimensional, (n_param, dim_param)')
    if x2.ndim != 2:
        raise AssertionError(
            'input x2 should be 2-dimensional, (n_param, dim_param)')
    if x1.shape[1] != x2.shape[1]:
        raise AssertionError(
            'the dim_param of input x1 and x2 should be the same.')

    llmb = torch.as_tensor(llmb, dtype=x1.dtype, device=x1.device)
    llmb0 = torch.as_tensor(llmb0, dtype=x1.dtype, device=x1.device)
    lnug = torch.as_tensor(lnug, dtype=x1.dtype, device=x1.device)
    if llmb.ndim == 0:
        llmb = llmb[None]

    if diag_only:
        # same tolerance rule as the reference's assert (covmat.py:25)
        a1 = x1.cpu().numpy()
        a2 = x2.cpu().numpy()
        if not np.all(np.abs(a1 - a2) <= 1e-6 + 1e-6 * np.abs(a2)):
            raise AssertionError('diag_only should only be called when x1 '
                                 'and x2 are identical.')
        return matern32_diag(x1, llmb0)[0]

    if same is None:
        if x1.shape != x2.shape:
            same = False
        else:
            same = bool(torch.equal(x1, x2))
    return matern32_gram(x1.contiguous(), x2.contiguous(), llmb[None, :],
                         llmb0[None], lnug[None], same=same)[0]
