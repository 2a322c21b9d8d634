"""Negative log marginal posterior, full path, forward value only
(counterpart of ``lcgp_tpu/models/likelihood.py``).

Per component k (C_k the Matérn Gram, D_k = diag_D[k], a_k = Y^T psi_ck):

    t_k = 0.5 logdet(B_k) - 0.5 a_k^T C_k B_k^{-1} a_k,   B_k = D_k C_k + I

C itself is never formed: B is built directly (the K1 epilogue on CUDA) and
``C w = (a - (1+jitter) w) / D`` recovers the quadratic term from ``B w = a``.
The factor is used through substitution (two triangular solves).  The
gradient, and the kernel VJP it needs, come with training.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from ..ops.gram import gram_factor_target
from . import params as P


class FullData(NamedTuple):
    """Static training tensors for submethod='full'."""
    xs: torch.Tensor         # (n, d) standardized inputs
    ys: torch.Tensor         # (p, n) standardized outputs
    phi: torch.Tensor        # (p, q)
    diag_D: torch.Tensor     # (q,)
    sigma_map: torch.Tensor  # (p,) int64 output-dim -> error group


def _bmv(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector: (q,n,m) @ (q,m) -> (q,n)."""
    return torch.matmul(mats, vecs[..., :, None])[..., :, 0]


def _factor(B: torch.Tensor) -> torch.Tensor:
    """Cholesky of the factorization target ('high' precision)."""
    return linalg.cholesky(B)


def _factor_solve_vec(L: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return linalg.cho_solve_vec(L, v)


def _map_components(body, stacks, q_chunk):
    """Apply ``body`` over the q leading axis in chunks of q_chunk
    components and concatenate; q_chunk=None runs one batch.  Bounds the
    per-chunk (q_chunk, n, n) transients."""
    if q_chunk is None:
        return body(stacks)
    q = stacks[0].shape[0]
    if q % q_chunk:
        raise ValueError(f'q_chunk={q_chunk} must divide q={q}')
    return torch.cat([body(tuple(t[s:s + q_chunk] for t in stacks))
                      for s in range(0, q, q_chunk)])


def _full_terms(jitter: float, kernel: str, xs, lLmb, lLmb0, lnug, D, a):
    n = xs.shape[0]
    diag_vec = torch.full((D.shape[0], n), 1.0 + jitter, dtype=xs.dtype,
                          device=xs.device)
    B = gram_factor_target(xs, lLmb, lLmb0, lnug, row_scale=D,
                           diag_vec=diag_vec, kind=kernel)
    LB = _factor(B)
    del B
    w = _factor_solve_vec(LB, a)
    logdet = linalg.chol_logdet(LB)
    Cw = (a - (1.0 + jitter) * w) / D[:, None]
    quad = torch.sum((a * Cw).to(torch.float64), dim=-1)
    return 0.5 * logdet - 0.5 * quad


def neglpost_full(free: P.FreeParams, data: FullData, jitter: float = 0.0,
                  q_chunk: int | None = None, kernel: str = 'matern32'):
    """Full-data integrated negative log marginal posterior (reference
    lcgp.py:635-666): sum_k t_k plus the noise terms
    (n/2) sum_p lsigma2_p + 0.5 ||Y / sigma||_F^2.  Not divided by n."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)          # (p,)
    sigma = torch.exp(lsig)
    n = data.xs.shape[0]

    psi_c = data.phi / torch.sqrt(sigma)[:, None]          # (p, q)
    a = (data.ys.T @ psi_c).T                              # (q, n)

    def body(stacks):
        return _full_terms(jitter, kernel, data.xs, *stacks)  # (qc,)

    terms = _map_components(body, (lLmb, lLmb0, lnug, data.diag_D, a),
                            q_chunk)
    nlp = torch.sum(terms).to(data.ys.dtype)
    nlp = nlp + 0.5 * n * torch.sum(lsig)
    nlp = nlp + 0.5 * torch.sum(torch.square(data.ys / torch.sqrt(sigma)[:, None]))
    return nlp
