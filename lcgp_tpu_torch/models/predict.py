"""Predictive distributions, full path (counterpart of
``lcgp_tpu/models/predict.py``).

``compute_aux_full`` stores L_Bk = chol(I + D_k C_k) and the dual weights
(I + D_k C_k)^{-1} b_k; the posterior variance uses
Th_k^2 = D_k (I + D_k C_k)^{-1}, i.e. one triangular solve per test block.
Components are processed in chunks of ``q_chunk`` by a Python loop, which
bounds the (q_chunk, n, n) transients.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from ..ops.gram import gram_factor_target, gram_stack
from ..ops.matern import matern32_diag
from . import params as P
from .likelihood import FullData, _bmv, _factor, _factor_solve_vec


class FullAux(NamedTuple):
    CinvM: torch.Tensor   # (q, n)
    LB: torch.Tensor      # (q, n, n) chol(I + D_k C_k)


def _chunk_slices(q: int, q_chunk: int | None):
    """[(start, stop)] component chunks; one chunk when q_chunk is None."""
    if q_chunk is None or q_chunk >= q:
        return [(0, q)]
    if q % q_chunk:
        raise ValueError(f'q_chunk={q_chunk} must divide q={q}')
    return [(i, i + q_chunk) for i in range(0, q, q_chunk)]


def _cat(chunks):
    """Concatenate per-chunk output tuples along the component axis."""
    if len(chunks) == 1:
        return chunks[0]
    return tuple(torch.cat([c[i] for c in chunks], dim=0)
                 for i in range(len(chunks[0])))


def _full_b(free: P.FreeParams, data: FullData) -> torch.Tensor:
    """(q, n) weighted-data vectors B_k^T (reference lcgp.py:697)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)
    return ((data.ys.T / torch.sqrt(sigma)[None, :]) @ data.phi).T


def compute_aux_full(free: P.FreeParams, data: FullData, jitter: float = 0.0,
                     kernel: str = 'matern32',
                     q_chunk: int | None = None) -> FullAux:
    lLmb, lLmb0, _, lnug = P.constrain(free)
    b = _full_b(free, data)
    n = data.xs.shape[0]
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        diag_vec = torch.full((e - s, n), 1.0 + jitter, dtype=data.xs.dtype,
                              device=data.xs.device)
        # Bmat = D C + (1 + jitter) I, written by one K1 launch on CUDA
        Bmat = gram_factor_target(data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                                  row_scale=data.diag_D[s:e],
                                  diag_vec=diag_vec, kind=kernel)
        LB = _factor(Bmat)
        del Bmat
        CinvM = _factor_solve_vec(LB, b[s:e])                      # (qc, n)
        chunks.append((CinvM, LB))
    CinvM, LB = _cat(chunks)
    return FullAux(CinvM=CinvM, LB=LB)


def predict_full_core(free: P.FreeParams, data: FullData, aux: FullAux, x0s,
                      jitter: float = 0.0, kernel: str = 'matern32',
                      q_chunk: int | None = None):
    """Latent predictive mean/var at standardized x0s.  Returns (ghat, gvar),
    each (q, n0)."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                                # (q, n0)
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        c0 = gram_stack(x0s, data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                        same=False, kind=kernel)                   # (qc,n0,n)
        ghat = _bmv(c0, aux.CinvM[s:e])
        M = linalg.solve_tri_lower(aux.LB[s:e], c0.mT)
        gvar = c00[s:e] - data.diag_D[s:e, None] * torch.sum(torch.square(M),
                                                              dim=-2)
        chunks.append((ghat, gvar))
    return _cat(chunks)


def recombine_full(free: P.FreeParams, data: FullData, ghat, gvar, ymean, ystd):
    """Latent -> output space (reference predict_full, lcgp.py:840-848)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)

    psi = data.phi.T * torch.sqrt(sigma)[None, :]                 # (q, p)
    predmean = psi.T @ ghat                                       # (p, n0)
    confvar = gvar.T @ torch.square(psi)                          # (n0, p)
    predvar = confvar + sigma[None, :]

    ypred = predmean * ystd + ymean
    yconfvar = confvar.T * torch.square(ystd)
    ypredvar = predvar.T * torch.square(ystd)
    return ypred, ypredvar, yconfvar


def fullcov_full(free: P.FreeParams, data: FullData, gvar, ystd):
    """(n0, p, p) full predictive covariance (reference lcgp.py:850-857)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)
    psi = data.phi.T * torch.sqrt(sigma)[None, :]                 # (q, p)

    CH = torch.einsum('kn,kp->npk', torch.sqrt(gvar), psi)        # (n0, p, q)
    cov = CH @ CH.mT
    cov = cov + torch.diag(sigma)[None, :, :]
    ystd_vec = ystd[:, 0]
    return cov * (ystd_vec[:, None] * ystd_vec[None, :])[None, :, :]
