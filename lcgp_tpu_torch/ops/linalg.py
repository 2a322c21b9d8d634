"""Batched Cholesky primitives (counterpart of ``lcgp_tpu/ops/linalg.py``).

Thin ``torch.linalg`` wrappers over a leading component/batch axis.  The
JAX package's blocked f64 variants exist only to route around the TPU's
emulated f64; on a GPU these are cuSOLVER/cuBLAS calls.
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
    synchronise with the host to find out."""
    L, info = torch.linalg.cholesky_ex(mats, check_errors=False)
    n = mats.shape[-1]
    lower = torch.ones((n, n), dtype=torch.bool, device=mats.device).tril_()
    return L.masked_fill_((info > 0)[..., None, None] & lower, float('nan'))


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


def chol_inverse(chols: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} = L^{-T} L^{-1} from the lower factor L, batched: one
    triangular solve against I (cuBLAS trsm on CUDA) and one matmul.  The
    loss gradient's B^{-1}.

    ``torch.cholesky_inverse`` computes the same; on an H100 (700 W) at
    (20, 4096, 4096) f64 it took 298.5 ms against 95.0 ms for this form
    (PERF.md).  The result is a fresh contiguous tensor."""
    n = chols.shape[-1]
    eye = torch.eye(n, dtype=chols.dtype, device=chols.device)
    linv = torch.linalg.solve_triangular(chols, eye.expand_as(chols),
                                         upper=False, left=True)
    inv = linv.mT @ linv
    # on CUDA the product can come back column-major; the matrix is
    # symmetric, so its transpose is the same inverse with row-major strides
    # (no copy), which the K2 kernel needs
    return inv if inv.is_contiguous() else inv.mT.contiguous()


def quad_chol(chols: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """v^T (L L^T)^{-1} v, batched; v (..., n)."""
    z = solve_tri_lower(chols, vecs[..., :, None])[..., :, 0]
    return torch.sum(z * z, dim=-1)
