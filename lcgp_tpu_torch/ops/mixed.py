"""Mixed-precision factorization: an f32 factor refined to f64 grade
(counterpart of ``lcgp_tpu/ops/mixed.py``).

Cholesky refinement (one step):
    L0 = chol_f32(B)
    R  = B - L0 L0^T                       (f64: the exact residual)
    X  = L0^{-1} R L0^{-T}                 (f32: X is O(eps32), so f32
                                            error on it is second-order)
    L  = L0 + L0 Phi(X),  Phi = tril - diag/2
giving ||L L^T - B|| = O(eps32^2 cond) + O(eps64); a second step reaches
the f64 floor.  It needs cond(B) eps32 < 1, true for the loss targets
here, whose factorands have unit-plus diagonals (B = I + D C, C + Lam).

The JAX package chose this on the TPU, where f64 is emulated and the f32
Cholesky was ~48x cheaper than the f64 one.  An H100 runs f64 natively,
so whether it pays there is a measurement (PERF.md); the semantics are
kept either way: ``precision='mixed'`` gives an f64-grade loss and
f32-grade gradients.
"""
from __future__ import annotations

import torch

from . import linalg

DEFAULT_REFINE_STEPS = 2

_F32 = torch.float32


def parse_refine(compute_dtype):
    """Refine-step count from the mixed sentinel, or None if not mixed:
    'mixed' -> DEFAULT_REFINE_STEPS, 'mixed:N' -> N (the model's adaptive
    escalation encodes the step count in the sentinel)."""
    if not isinstance(compute_dtype, str):
        return None
    if compute_dtype == 'mixed':
        return DEFAULT_REFINE_STEPS
    if compute_dtype.startswith('mixed:'):
        return int(compute_dtype.split(':', 1)[1])
    return None


def is_mixed(compute_dtype) -> bool:
    return parse_refine(compute_dtype) is not None


def _phi_lower(X: torch.Tensor) -> torch.Tensor:
    """tril(X) - diag(X)/2: the Cholesky-correction projector."""
    out = torch.tril(X)
    out.diagonal(dim1=-2, dim2=-1).mul_(0.5)
    return out


def cholesky_mixed(B: torch.Tensor, refine_steps: int = 2,
                   seed_jitter: float = 0.0) -> torch.Tensor:
    """f64-grade lower Cholesky of PSD B (f64) from an f32 factor and
    ``refine_steps`` refinement steps.

    seed_jitter: relative diagonal boost for the f32 *seed* factorization
    only (for a target near the f32 conditioning edge); the refinement
    corrects toward the true, un-jittered B."""
    B32 = B.to(_F32)
    if seed_jitter:
        d = B32.diagonal(dim1=-2, dim2=-1)
        d.add_(seed_jitter * d)
    L = linalg.cholesky(B32).to(B.dtype)
    del B32
    for _ in range(refine_steps):
        R = B - linalg.syrk_tri_lower(L)               # the f64 product
        L32 = L.to(_F32)
        # X = L^{-1} R L^{-T} through the triangular inverse and the
        # structured products: M R is a trmm, only tril(X) is read (the
        # block-lower product), and L Phi(X) is lower times lower
        M = linalg.tri_inverse_lower(L32)
        Y = linalg.trmm_lower(M, R.to(_F32))
        del R
        X = linalg.mul_t_block_lower(Y, M)
        del Y, M
        L = L + linalg.mul_lower_lower(L32, _phi_lower(X)).to(B.dtype)
    return L


def chol_inverse_mixed(B: torch.Tensor, L64: torch.Tensor | None = None,
                       newton_steps: int = 1) -> torch.Tensor:
    """f64-grade B^{-1} from an f32 potri seed and Newton steps
    X <- X (2I - B X) (f64 GEMMs).  L64: an optional refined factor, used
    only for its f32 cast as the seed factor."""
    L32 = (linalg.cholesky(B.to(_F32)) if L64 is None else L64.to(_F32))
    X = linalg.chol_inverse(L32).to(B.dtype)
    for _ in range(newton_steps):
        X = 2.0 * X - X @ (B @ X)
        X = 0.5 * (X + X.mT)
    return X


def chol_inverse_from_factor_mixed(L64: torch.Tensor,
                                   newton_steps: int = 1) -> torch.Tensor:
    """(L L^T)^{-1} from a refined factor: the f32 potri inverse of the
    factor's f32 cast, then Newton steps with B applied as L (L^T X).

    The residual contracts quadratically from e0 ~ eps32 cond.
    newton_steps=0 returns the f32 seed cast to the factor's dtype: the
    loss gradient under 'mixed', which is f32-grade by design (the f32
    contraction passes downstream set its error floor anyway)."""
    X = linalg.chol_inverse(L64.to(_F32)).to(L64.dtype)
    for _ in range(newton_steps):
        X = 2.0 * X - X @ (L64 @ (L64.mT @ X))
        X = 0.5 * (X + X.mT)
    return X


def cho_solve_vec_refined(L64: torch.Tensor, B: torch.Tensor,
                          v: torch.Tensor, refine_steps: int = 2
                          ) -> torch.Tensor:
    """B^{-1} v through the f32 cast of the factor and f64 residual
    refinement: f32 triangular vector solves and f64 matvecs."""
    L32 = L64.to(_F32)

    def solve32(r):
        return linalg.cho_solve_vec(L32, r.to(_F32)).to(B.dtype)

    x = solve32(v)
    for _ in range(refine_steps):
        x = x + solve32(v - (B @ x[..., :, None])[..., :, 0])
    return x
