"""Predictive distributions, full and replication paths (counterpart of
``lcgp_tpu/models/predict.py``).

``compute_aux_full`` stores L_Bk = chol(I + D_k C_k) and the dual weights
(I + D_k C_k)^{-1} b_k; the posterior variance uses
Th_k^2 = D_k (I + D_k C_k)^{-1}, i.e. one triangular solve per test block.
``compute_aux_rep`` stores L_Tk = chol(C_k + diag(1/(D_k r))) and the dual
weights (C_k + Lam_k)^{-1} Lam_k b_k, which equal the reference's
``b - D R m`` without its cancellation; the posterior variance uses
T_k = (C_k + Lam_k)^{-1} through the same factor.
Components are processed in chunks of ``q_chunk`` by a Python loop, which
bounds the (q_chunk, n, n) transients.

``compute_dtype`` follows the loss: 'mixed' builds and keeps everything in
f64 with the refined factor and solve (``ops/mixed.py``); ``torch.float32``
('fast') builds the Gram, the factor, the solves and the latent outputs in
f32, which the recombination casts up to the f64 basis.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from ..ops.gram import gram_factor_target, gram_stack
from ..ops.matern import matern32_diag
from . import params as P
from .likelihood import (FullData, RepData, _bmv, _dtypes, _factor,
                         _factor_solve_vec)


class FullAux(NamedTuple):
    CinvM: torch.Tensor   # (q, n)
    LB: torch.Tensor      # (q, n, n) chol(I + D_k C_k)


class RepAux(NamedTuple):
    CinvM: torch.Tensor   # (q, n)
    LT: torch.Tensor      # (q, n, n) chol(C_k + diag(1/(d_k r)))
    mks: torch.Tensor     # (q, n) training-point latent means (diagnostic,
                          # reference lcgp.py:779,800)
    psi_c: torch.Tensor   # (q, p) Phi^T Sigma_used^{-1/2} (diagnostic)


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


def compute_aux_full(free: P.FreeParams, data: FullData, compute_dtype=None,
                     jitter: float = 0.0, kernel: str = 'matern32',
                     q_chunk: int | None = None) -> FullAux:
    lLmb, lLmb0, _, lnug = P.constrain(free)
    b = _full_b(free, data)
    n = data.xs.shape[0]
    dt, _ = _dtypes(compute_dtype, data.xs)
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        diag_vec = torch.full((e - s, n), 1.0 + jitter, dtype=dt,
                              device=data.xs.device)
        # Bmat = D C + (1 + jitter) I, written by one K1 launch on CUDA
        Bmat = gram_factor_target(data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                                  row_scale=data.diag_D[s:e],
                                  diag_vec=diag_vec,
                                  compute_dtype=compute_dtype, kind=kernel)
        LB = _factor(Bmat, compute_dtype)
        CinvM = _factor_solve_vec(LB, Bmat, b[s:e].to(LB.dtype),
                                  compute_dtype)                   # (qc, n)
        del Bmat
        chunks.append((CinvM, LB))
    CinvM, LB = _cat(chunks)
    return FullAux(CinvM=CinvM, LB=LB)


def predict_full_core(free: P.FreeParams, data: FullData, aux: FullAux, x0s,
                      compute_dtype=None, jitter: float = 0.0,
                      kernel: str = 'matern32', q_chunk: int | None = None):
    """Latent predictive mean/var at standardized x0s.  Returns (ghat, gvar),
    each (q, n0), in the aux's dtype."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                                # (q, n0)
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        c0 = gram_stack(x0s, data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                        same=False, compute_dtype=compute_dtype,
                        kind=kernel)                               # (qc,n0,n)
        ghat = _bmv(c0, aux.CinvM[s:e])
        M = linalg.solve_tri_lower(aux.LB[s:e], c0.mT)
        gvar = (c00[s:e].to(M.dtype) - data.diag_D[s:e, None].to(M.dtype)
                * torch.sum(torch.square(M), dim=-2))
        chunks.append((ghat, gvar))
    return _cat(chunks)


def recombine_full(free: P.FreeParams, data: FullData, ghat, gvar, ymean, ystd):
    """Latent -> output space (reference predict_full, lcgp.py:840-848)."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)

    psi = data.phi.T * torch.sqrt(sigma)[None, :]                 # (q, p)
    # f32 latents under 'fast' are promoted, as jnp promotes them
    ghat, gvar = ghat.to(psi.dtype), gvar.to(psi.dtype)
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

    CH = torch.einsum('kn,kp->npk', torch.sqrt(gvar).to(psi.dtype),
                      psi)                                        # (n0, p, q)
    cov = CH @ CH.mT
    cov = cov + torch.diag(sigma)[None, :, :]
    ystd_vec = ystd[:, 0]
    return cov * (ystd_vec[:, None] * ystd_vec[None, :])[None, :, :]


# ---------------------------------------------------------------------------
# rep path
# ---------------------------------------------------------------------------


def _rep_sigma_inv_sqrt(free: P.FreeParams, data: RepData) -> torch.Tensor:
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    return data.scale / torch.sqrt(torch.exp(lsig))                # (p,)


def _rep_b(free: P.FreeParams, data: RepData) -> torch.Tensor:
    """(q, n) dual data vectors b_k (reference lcgp.py:606-610)."""
    v = data.phi * _rep_sigma_inv_sqrt(free, data)[:, None]        # (p, q)
    return data.r[None, :] * (data.ybar.T @ v).T


def _rep_psi_c(free: P.FreeParams, data: RepData) -> torch.Tensor:
    return data.phi.T * _rep_sigma_inv_sqrt(free, data)[None, :]   # (q, p)


def compute_aux_rep(free: P.FreeParams, data: RepData, compute_dtype=None,
                    jitter: float = 0.0, kernel: str = 'matern32',
                    q_chunk: int | None = None) -> RepAux:
    """Rep-path predictive aux: one factor of C + diag(1/(D r) + jitter)
    shared by the dual weights and the variances, with the training loss's
    jitter formula.

    C is built on its own (one K1 launch on CUDA) and kept until the
    training-point means ``mks = C @ CinvM`` are formed, as lcgp_tpu forms
    them: the identity ``C u = Lam b - (lam + jitter) u`` the loss uses
    cancels where Lam dominates C."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    b = _rep_b(free, data)
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        C = gram_stack(data.xs, data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                       same=True, compute_dtype=compute_dtype, kind=kernel)
        D = data.diag_D[s:e].to(C.dtype)
        # lam in f64 (D r), then rounded into A's dtype, as lcgp_tpu forms it
        lam = 1.0 / (D[:, None] * data.r[None, :])                 # (qc, n)
        A = linalg.add_diag(
            C, lam + jitter * (1.0 + lLmb0[s:e, None].to(C.dtype)))
        LT = _factor(A, compute_dtype)
        CinvM = _factor_solve_vec(LT, A, (lam * b[s:e]).to(LT.dtype),
                                  compute_dtype)                   # (qc, n)
        del A
        chunks.append((CinvM, LT, _bmv(C, CinvM)))
        del C
    CinvM, LT, mks = _cat(chunks)
    return RepAux(CinvM=CinvM, LT=LT, mks=mks, psi_c=_rep_psi_c(free, data))


def predict_rep_core(free: P.FreeParams, data: RepData, aux: RepAux, x0s,
                     compute_dtype=None, jitter: float = 0.0,
                     kernel: str = 'matern32', q_chunk: int | None = None):
    """Latent predictive mean/var at standardized x0s.  Returns (ghat, gvar),
    each (q, n0) in the aux's dtype; unlike the full path the variance has
    no D factor."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                                # (q, n0)
    chunks = []
    for s, e in _chunk_slices(int(data.phi.shape[1]), q_chunk):
        c0 = gram_stack(x0s, data.xs, lLmb[s:e], lLmb0[s:e], lnug[s:e],
                        same=False, compute_dtype=compute_dtype,
                        kind=kernel)                               # (qc,n0,n)
        ghat = _bmv(c0, aux.CinvM[s:e])
        M = linalg.solve_tri_lower(aux.LT[s:e], c0.mT)
        chunks.append((ghat, c00[s:e].to(M.dtype)
                       - torch.sum(torch.square(M), dim=-2)))
    return _cat(chunks)


def recombine_rep(free: P.FreeParams, data: RepData, ghat, gvar,
                  ybar_mean, ybar_std):
    """Latent -> output space, rep variant (reference lcgp.py:902-926).
    The caller passes ybar_mean/ybar_std, or zeros/ones when
    rep_standardize_ybar is off."""
    _, _, lsig_g, _ = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = torch.exp(lsig)

    sigma_sqrt_used = torch.sqrt(sigma_raw) / data.scale
    sigma_var_used = sigma_raw / torch.square(data.scale)

    Psi = data.phi * sigma_sqrt_used[:, None]                     # (p, q)
    ghat, gvar = ghat.to(Psi.dtype), gvar.to(Psi.dtype)
    predmean_used = Psi @ ghat                                    # (p, n0)
    confvar_used = torch.square(Psi) @ gvar
    predvar_used = confvar_used + sigma_var_used[:, None]

    ypred = predmean_used * ybar_std + ybar_mean
    yconfvar = confvar_used * torch.square(ybar_std)
    ypredvar = predvar_used * torch.square(ybar_std)
    return ypred, ypredvar, yconfvar
