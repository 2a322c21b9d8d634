"""Gram-stack construction (counterpart of ``lcgp_tpu/ops/gram.py``).

Three kernel kinds, the families of ``ops/launch.py``: ``'matern32'`` (the
reference's), ``'matern52'`` and ``'rbf'``; any other kind raises
``ValueError``.  On CUDA, :func:`gram_factor_target` runs the kind's Gram
kernel (K1, K3 or K4) with its epilogue, so the factorization target
``B = row_scale_k * C_k + diag(diag_vec_k)`` is written in one pass and C is
never written separately.  On the CPU it runs the plain version and the
epilogue as tensor ops.  The VJPs (:func:`gram_vjp`, :func:`gram_vjp_fused`)
run the kind's VJP kernel on CUDA and its plain VJP on the CPU.

:func:`gram_stack` is differentiable.  When autograd is on and an operand
requires a gradient it returns through :class:`GramFn`, whose backward is
the kind's VJP kernel (K2, K3's or K4's) for the parameters and K5 for the
points, or their plain versions on the CPU: the kernels' outputs carry no
autograd history of their own, so without it the Gram terms would drop out
of a gradient on CUDA without an error.  The exact losses form their
gradient inside their own ``autograd.Function`` and never take this path.

``compute_dtype`` selects the precision the Gram is built in, as in
``lcgp_tpu/ops/gram.py:31-96``: None and the 'mixed' sentinel build in the
inputs' dtype (f64), ``torch.float32`` casts the inputs and parameters to
f32 and runs the kernels' f32 instantiations.
"""
from __future__ import annotations

import torch
from torch.autograd.function import once_differentiable

from . import linalg
from .launch import family
from .mixed import is_mixed


def _cast(compute_dtype, *tensors):
    """The tensors in the compute dtype, contiguous (the kernels take dense
    blocks); unchanged for None and the 'mixed' sentinel."""
    if compute_dtype is None or is_mixed(compute_dtype):
        return tensors
    return tuple(t.to(compute_dtype).contiguous() for t in tensors)


class GramFn(torch.autograd.Function):
    """The Gram stack (q, n1, n2) of one kind as a differentiable function
    of (x1, x2, lengthscales (q, d), amplitudes (q,), nuggets (q,)), the
    counterpart of the retired Pallas kernel's ``jax.custom_vjp``
    (``b21a99c^:lcgp_tpu/ops/matern_pallas.py:278-300``).

    Forward: the kind's Gram kernel on CUDA, its plain version on the CPU.
    Backward at the cotangent M: the kind's VJP kernel for the parameters
    (only when one requires a gradient), K5 for x2 and K5 on (x2, x1, M^T)
    for x1 (each only when it requires a gradient), or their plain
    versions on the CPU.  Every operand is in one dtype."""

    @staticmethod
    def forward(ctx, kind, same, x1, x2, lengthscales, amplitudes, nuggets):
        ctx.kind, ctx.same = kind, same
        ctx.save_for_backward(x1, x2, lengthscales, amplitudes, nuggets)
        return family(kind).gram(x1, x2, lengthscales, amplitudes, nuggets,
                                 same=same)

    @staticmethod
    @once_differentiable
    def backward(ctx, cbar):
        fam = family(ctx.kind)
        x1, x2, ls, amp, nug = ctx.saved_tensors
        need = ctx.needs_input_grad
        M = cbar.to(x1.dtype).contiguous()
        glens = gamp = gnug = gx1 = gx2 = None
        if any(need[4:7]):
            glens, gamp, gnug = fam.vjp(x1, x2, ls, amp, nug, same=ctx.same,
                                        cbar=M)
        if need[3]:
            gx2 = fam.vjp_x(x1, x2, ls, amp, nug, M=M)
        if need[2]:
            gx1 = fam.vjp_x(x2, x1, ls, amp, nug, M=M.mT.contiguous())
        return None, None, gx1, gx2, glens, gamp, gnug


def gram_stack(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
               compute_dtype=None, kind: str = 'matern32',
               want_c0: bool = False):
    """Batched (q, n1, n2) Gram stack; ``(stack, c0)`` when ``want_c0``.
    Differentiable through :class:`GramFn` (not with ``want_c0``)."""
    fam = family(kind)
    ops = _cast(compute_dtype, x1, x2, lengthscales, amplitudes, nuggets)
    if (not want_c0 and torch.is_grad_enabled()
            and any(t.requires_grad for t in ops)):
        return GramFn.apply(kind, same, *(t.contiguous() for t in ops))
    return fam.gram(*ops, same=same, want_c0=want_c0)


def gram_factor_target(x, lengthscales, amplitudes, nuggets, *, row_scale,
                       diag_vec, compute_dtype=None, kind: str = 'matern32',
                       want_c0: bool = False):
    """Factorization target B = row_scale_k * C_k(x, x) + diag(diag_vec_k).

    row_scale (q,), diag_vec (q, n).  ``want_c0=True`` returns (B, C0)."""
    fam = family(kind)
    x, lengthscales, amplitudes, nuggets = _cast(
        compute_dtype, x, lengthscales, amplitudes, nuggets)
    if x.device.type != 'cpu':
        row_scale, diag_vec = (t.to(x.dtype).contiguous()
                               for t in (row_scale, diag_vec))
        B, c0 = fam.launch(x, x, lengthscales, amplitudes, nuggets,
                           same=True, want_c0=want_c0, row_scale=row_scale,
                           diag_vec=diag_vec)
        return (B, c0) if want_c0 else B
    C = fam.gram(x, x, lengthscales, amplitudes, nuggets, same=True,
                 want_c0=want_c0)
    c0 = None
    if want_c0:
        C, c0 = C
    B = linalg.add_diag(row_scale.to(C.dtype)[:, None, None] * C,
                        diag_vec.to(C.dtype))
    return (B, c0) if want_c0 else B


def gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
             cbar, kind: str = 'matern32', c0=None):
    """Analytic (glens, gamp, gnug) for a Gram-stack cotangent ``cbar``.
    x carries no gradient (data).  ``c0``: the raw correlation stack from
    ``gram_stack(want_c0=True)``; the plain version then skips its rebuild
    (the kernels recompute C0 either way)."""
    return family(kind).vjp(x1, x2, lengthscales, amplitudes, nuggets,
                            same=same, cbar=cbar, c0=c0)


def gram_vjp_fused(x, lengthscales, amplitudes, nuggets, *, M, alpha,
                   beta: float, w, kind: str = 'matern32'):
    """(glens, gamp, gnug) of the same-point Gram at the cotangent
    ``alpha_k M_k + beta w_k w_k^T``, which the loss gradient needs with
    M = B^{-1}, alpha = D/2 and beta = -1/2.  On CUDA the cotangent is
    never formed.  The VJP runs in M's dtype (the kernel's f32
    instantiation for an f32 M) and returns the parameters' dtypes."""
    return family(kind).vjp_fused(x, lengthscales, amplitudes, nuggets, M=M,
                                  alpha=alpha, beta=beta, w=w)
