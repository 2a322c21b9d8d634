"""Batched Cholesky primitives (counterpart of ``lcgp_tpu/ops/linalg.py``).

Thin ``torch.linalg`` wrappers over a leading component/batch axis.  The
JAX package's blocked f64 Cholesky and triangular inverse exist only to
route around the TPU's emulated f64; on a GPU these are cuSOLVER/cuBLAS
calls.  The structured triangular products at the end (syrk, trmm, ...)
are ported with their 512-blocking: the mixed-precision refinement
(``ops/mixed.py``) is made of them.
"""
from __future__ import annotations

import torch


def add_diag(mats: torch.Tensor, vals) -> torch.Tensor:
    """mats (..., n, n) plus vals on the diagonal; vals is a scalar or
    broadcastable to (..., n).  Returns a new tensor."""
    out = mats.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(
        torch.as_tensor(vals, dtype=mats.dtype, device=mats.device))
    return out


def cholesky(mats: torch.Tensor) -> torch.Tensor:
    """Batched lower Cholesky.

    Keeps the JAX contract for a matrix that is not positive definite: the
    lower triangle of its factor comes back NaN, and nothing raises.
    ``torch.linalg.cholesky`` would raise instead, and on CUDA would
    synchronise with the host to find out.  The mask is written in place,
    except where autograd records the factor (the FITC losses
    differentiate through their (m, m) factors), which needs it intact."""
    L, info = torch.linalg.cholesky_ex(mats, check_errors=False)
    n = mats.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=mats.device).tril_()
    mask = (info > 0)[..., None, None] & lower
    if L.requires_grad:
        return L.masked_fill(mask, float('nan'))
    return L.masked_fill_(mask, float('nan'))


def chol_logdet(chols: torch.Tensor) -> torch.Tensor:
    """logdet(A) from L with A = L L^T, batched; the n-length sum is taken
    in f64 even for f32 factors."""
    diag = torch.diagonal(chols, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag).to(torch.float64), dim=-1)


def solve_tri_lower(chols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """L^{-1} rhs with lower-triangular L; rhs (..., n, m)."""
    return torch.linalg.solve_triangular(chols, rhs, upper=False, left=True)


def cho_solve(chols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs; rhs (..., n, m)."""
    z = torch.linalg.solve_triangular(chols, rhs, upper=False, left=True)
    return torch.linalg.solve_triangular(chols.mT, z, upper=True, left=True)


def cho_solve_vec(chols: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} v with v (..., n)."""
    return cho_solve(chols, vecs[..., :, None])[..., :, 0]


def tri_inverse_lower(chols: torch.Tensor) -> torch.Tensor:
    """L^{-1} for lower-triangular L, batched: one triangular solve against
    I (cuBLAS trsm on CUDA).  The JAX package's blocked form only routes
    around the TPU's slow substitution; the values agree to rounding."""
    n = chols.shape[-1]
    eye = torch.eye(n, dtype=chols.dtype, device=chols.device)
    return torch.linalg.solve_triangular(chols, eye.expand_as(chols),
                                         upper=False, left=True)


def chol_inverse(chols: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} = L^{-T} L^{-1} from the lower factor L, batched: one
    triangular solve against I (cuBLAS trsm on CUDA) and one matmul.  The
    loss gradient's B^{-1}.

    ``torch.cholesky_inverse`` computes the same; on an H100 (700 W) at
    (20, 4096, 4096) f64 it took 298.5 ms against 95.0 ms for this form
    (PERF.md).  The result is a fresh contiguous tensor."""
    linv = tri_inverse_lower(chols)
    inv = linv.mT @ linv
    # on CUDA the product can come back column-major; the matrix is
    # symmetric, so its transpose is the same inverse with row-major strides
    # (no copy), which the K2 kernel needs
    return inv if inv.is_contiguous() else inv.mT.contiguous()


def quad_chol(chols: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """v^T (L L^T)^{-1} v, batched; v (..., n)."""
    z = solve_tri_lower(chols, vecs[..., :, None])[..., :, 0]
    return torch.sum(z * z, dim=-1)


# ---------------------------------------------------------------------------
# Structured triangular products (counterparts of lcgp_tpu/ops/linalg.py
# :231-412), the GEMMs of the mixed-precision refinement (ops/mixed.py).
# Each works on 512-blocks and does only the block products its operands'
# triangles need; the products inside are torch.matmul, as the JAX package
# left them to XLA.  Non-block-divisible n is zero-padded to the next block
# multiple (see _pad_nn); n below two blocks falls back to the dense matmul.
# ---------------------------------------------------------------------------

_TRI_SYRK_BLOCK = 512


def _pad_nn(A: torch.Tensor, np_: int) -> torch.Tensor:
    """Zero-pad the trailing (n, n) dims to (np_, np_).

    Every structured product below is zero-padding-equivariant: padding a
    lower-triangular operand with zero rows and columns leaves the top-left
    n x n block of the product equal to the unpadded product."""
    return torch.nn.functional.pad(A, (0, np_ - A.shape[-1],
                                       0, np_ - A.shape[-2]))


def _next_mult(n: int, nb: int) -> int:
    return -(-n // nb) * nb


def _sym_from_block_lower(S: torch.Tensor, nd: int, nb: int) -> torch.Tensor:
    """Full symmetric matrix from its block-lower representation S (the
    diagonal blocks included, themselves symmetric; zero block-above).
    S + S^T counts each diagonal block twice, so one copy is taken back."""
    A = S + S.mT
    for j in range(nd):
        cj = slice(j * nb, (j + 1) * nb)
        A[..., cj, cj] -= S[..., cj, cj]
    return A


def syrk_tri_lower(L: torch.Tensor) -> torch.Tensor:
    """L @ L^T for LOWER-TRIANGULAR L (n^3/3 flops against the dense 2n^3):
    block-column j of the lower triangle is one GEMM
    ``L[jb:, :w] @ L[jb:jb+nb, :w]^T`` with w = (j+1) nb, and the symmetric
    matrix is assembled from the strips.  The refinement's exact residual
    ``B - L L^T`` is this product."""
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return L @ L.mT
    if n % nb:
        return syrk_tri_lower(_pad_nn(L, _next_mult(n, nb)))[..., :n, :n]
    return _sym_from_block_lower(mul_t_block_lower(L, L), n // nb, nb)


def gram_tri_lower(M: torch.Tensor) -> torch.Tensor:
    """M^T @ M for LOWER-TRIANGULAR M (n^3/3 flops): block-row i of the
    lower triangle only contracts over rows >= i nb, so it is one GEMM
    ``M[ib:, ib:ib+nb]^T @ M[ib:, :w]``."""
    n = M.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return M.mT @ M
    if n % nb:
        return gram_tri_lower(_pad_nn(M, _next_mult(n, nb)))[..., :n, :n]
    nd = n // nb
    S = torch.zeros_like(M)
    for i in range(nd):
        w = (i + 1) * nb
        S[..., i * nb:w, :w] = (M[..., i * nb:, i * nb:w].mT
                                @ M[..., i * nb:, :w])
    return _sym_from_block_lower(S, nd, nb)


def trmm_lower(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """L @ X with LOWER-TRIANGULAR L and dense X (n^3 flops against 2n^3):
    block-row i is one GEMM ``L[ib:ib+nb, :w] @ X[:w, :]``."""
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return L @ X
    if n % nb:
        np_ = _next_mult(n, nb)
        Xp = torch.nn.functional.pad(X, (0, 0, 0, np_ - n))
        return trmm_lower(_pad_nn(L, np_), Xp)[..., :n, :]
    return torch.cat([L[..., i * nb:(i + 1) * nb, :(i + 1) * nb]
                      @ X[..., :(i + 1) * nb, :] for i in range(n // nb)],
                     dim=-2)


def mul_t_block_lower(Y: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Block-lower triangle of Y @ M^T with LOWER-TRIANGULAR M (n^3/3):
    block-column j is one GEMM ``Y[jb:, :w] @ M[jb:jb+nb, :w]^T``.

    CONTRACT: only entries on or below the diagonal are specified.  The
    blocked path leaves the strict block-upper region ZERO; the small-n
    dense fallback returns the full product (a superset).  Callers read at
    most ``tril`` of the result, as the refinement's projector does."""
    n = M.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return Y @ M.mT
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_t_block_lower(_pad_nn(Y, np_),
                                 _pad_nn(M, np_))[..., :n, :n]
    S = torch.zeros_like(Y)
    for j in range(n // nb):
        w = (j + 1) * nb
        S[..., j * nb:, j * nb:w] = (Y[..., j * nb:, :w]
                                     @ M[..., j * nb:w, :w].mT)
    return S


def mul_lower_lower(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with BOTH operands lower triangular (the product is lower
    triangular): block-row i is one GEMM ``A[ib:ib+nb, :w] @ B[:w, :w]``
    and zeros beyond column w, 2n^3/3 flops."""
    n = A.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return A @ B
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_lower_lower(_pad_nn(A, np_), _pad_nn(B, np_))[..., :n, :n]
    out = torch.zeros_like(A)
    for i in range(n // nb):
        w = (i + 1) * nb
        out[..., i * nb:w, :w] = A[..., i * nb:w, :w] @ B[..., :w, :w]
    return out
