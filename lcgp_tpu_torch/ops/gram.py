"""Gram-stack construction (counterpart of ``lcgp_tpu/ops/gram.py``).

Only the Matérn 3/2 kind is ported.  On CUDA, :func:`gram_factor_target`
runs the K1 kernel with its epilogue, so the factorization target
``B = row_scale_k * C_k + diag(diag_vec_k)`` is written in one pass and C is
never written separately.  On the CPU it runs the plain version and the
epilogue as tensor ops.  The VJPs (:func:`gram_vjp`, :func:`gram_vjp_fused`)
run K2 on CUDA and the plain VJP on the CPU.

``compute_dtype`` selects the precision the Gram is built in, as in
``lcgp_tpu/ops/gram.py:31-96``: None and the 'mixed' sentinel build in the
inputs' dtype (f64), ``torch.float32`` casts the inputs and parameters to
f32 and runs K1's f32 instantiation.
"""
from __future__ import annotations

from . import linalg
from .mixed import is_mixed
from .matern import (launch_matern32, matern32_gram, matern32_gram_vjp,
                     matern32_gram_vjp_fused)


def _check_kind(kind: str):
    if kind in ('matern52', 'rbf'):
        raise NotImplementedError(
            f"kernel {kind!r} is not ported yet (ROADMAP.md Queue 1 item 13)")
    if kind != 'matern32':
        raise ValueError(f"unknown kernel kind {kind!r}")


def _cast(compute_dtype, *tensors):
    """The tensors in the compute dtype, contiguous (K1 takes dense
    blocks); unchanged for None and the 'mixed' sentinel."""
    if compute_dtype is None or is_mixed(compute_dtype):
        return tensors
    return tuple(t.to(compute_dtype).contiguous() for t in tensors)


def gram_stack(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
               compute_dtype=None, kind: str = 'matern32',
               want_c0: bool = False):
    """Batched (q, n1, n2) Gram stack; ``(stack, c0)`` when ``want_c0``."""
    _check_kind(kind)
    x1, x2, lengthscales, amplitudes, nuggets = _cast(
        compute_dtype, x1, x2, lengthscales, amplitudes, nuggets)
    return matern32_gram(x1, x2, lengthscales, amplitudes, nuggets, same=same,
                         want_c0=want_c0)


def gram_factor_target(x, lengthscales, amplitudes, nuggets, *, row_scale,
                       diag_vec, compute_dtype=None, kind: str = 'matern32',
                       want_c0: bool = False):
    """Factorization target B = row_scale_k * C_k(x, x) + diag(diag_vec_k).

    row_scale (q,), diag_vec (q, n).  ``want_c0=True`` returns (B, C0)."""
    _check_kind(kind)
    x, lengthscales, amplitudes, nuggets = _cast(
        compute_dtype, x, lengthscales, amplitudes, nuggets)
    if x.device.type != 'cpu':
        row_scale, diag_vec = (t.to(x.dtype).contiguous()
                               for t in (row_scale, diag_vec))
        B, c0 = launch_matern32(x, x, lengthscales, amplitudes, nuggets,
                                same=True, want_c0=want_c0,
                                row_scale=row_scale, diag_vec=diag_vec)
        return (B, c0) if want_c0 else B
    C = matern32_gram(x, x, lengthscales, amplitudes, nuggets, same=True,
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
    (K2 recomputes C0 either way)."""
    _check_kind(kind)
    return matern32_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets,
                             same=same, cbar=cbar, c0=c0)


def gram_vjp_fused(x, lengthscales, amplitudes, nuggets, *, M, alpha,
                   beta: float, w, kind: str = 'matern32'):
    """(glens, gamp, gnug) of the same-point Gram at the cotangent
    ``alpha_k M_k + beta w_k w_k^T``, which the loss gradient needs with
    M = B^{-1}, alpha = D/2 and beta = -1/2.  On CUDA the cotangent is
    never formed.  The VJP runs in M's dtype (K2 f32 for an f32 M) and
    returns the parameters' dtypes."""
    _check_kind(kind)
    return matern32_gram_vjp_fused(x, lengthscales, amplitudes, nuggets, M=M,
                                   alpha=alpha, beta=beta, w=w)
