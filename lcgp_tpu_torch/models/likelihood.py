"""Negative log marginal posterior, full path, with its gradient
(counterpart of ``lcgp_tpu/models/likelihood.py``).

Per component k (C_k the Matérn Gram, D_k = diag_D[k], a_k = Y^T psi_ck):

    t_k = 0.5 logdet(B_k) - 0.5 a_k^T C_k B_k^{-1} a_k,   B_k = D_k C_k + I

C itself is never formed: B is built directly (the K1 epilogue on CUDA) and
``C w = (a - (1+jitter) w) / D`` recovers the quadratic term from ``B w = a``.
The factor is used through substitution (two triangular solves).

The gradient has a closed form (``lcgp_tpu/models/likelihood.py:142-175``):

    dt/dC = 0.5 D B^{-1} - 0.5 w w^T,   dt/da = -C w,   w = B^{-1} a

and each t_k is a scalar, so its cotangent enters linearly.  The component
terms are therefore a :class:`torch.autograd.Function` whose forward, when a
gradient is asked for, also forms B^{-1} and runs the Gram VJP at that
cotangent (K2 on CUDA, which never forms it), and saves only the
O(q (n + d)) results; the backward scales them.  The rest of the chain
(SoftClip, sigma expansion, a = (Y^T psi_c)^T, the noise terms) is plain
autograd.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from ..ops.gram import gram_factor_target, gram_vjp_fused
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


def _full_terms_impl(jitter: float, kernel: str, xs, lLmb, lLmb0, lnug, D,
                     a, want_kernel_grad: bool = False):
    """The component terms (qc,), -C w (the gradient in a), and, when
    ``want_kernel_grad``, the gradients (glens, gamp, gnug) of the terms in
    the kernel parameters."""
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
    terms = 0.5 * logdet - 0.5 * quad
    if not want_kernel_grad:
        return terms, Cw, None
    Binv = linalg.chol_inverse(LB)
    del LB
    # the cotangent 0.5 D B^{-1} - 0.5 w w^T of the Gram
    kgrad = gram_vjp_fused(xs, lLmb, lLmb0, lnug, M=Binv, alpha=0.5 * D,
                           beta=-0.5, w=w.contiguous(), kind=kernel)
    return terms, Cw, kgrad


class _FullTerms(torch.autograd.Function):
    """Component terms with the gradient formed in the forward.

    The forward does the extra work (B^{-1}, the Gram VJP) only for the
    inputs ``ctx.needs_input_grad`` names, so ``loss()`` without a gradient
    costs what the value alone costs."""

    @staticmethod
    def forward(ctx, jitter, kernel, xs, lLmb, lLmb0, lnug, D, a):
        want = ctx.needs_input_grad
        terms, Cw, kgrad = _full_terms_impl(
            jitter, kernel, xs, lLmb, lLmb0, lnug, D, a,
            want_kernel_grad=any(want[3:6]))
        glens0, gamp0, gnug0 = kgrad if kgrad is not None else (None,) * 3
        ctx.save_for_backward(glens0, gamp0, gnug0,
                              -Cw if want[7] else None)
        return terms

    @staticmethod
    def backward(ctx, tbar):
        glens0, gamp0, gnug0, abar0 = ctx.saved_tensors

        def scale(g, t):
            return None if g is None else t.to(g.dtype) * g
        return (None, None, None, scale(glens0, tbar[:, None]),
                scale(gamp0, tbar), scale(gnug0, tbar), None,
                scale(abar0, tbar[:, None]))


def _full_terms(jitter: float, kernel: str, xs, lLmb, lLmb0, lnug, D, a):
    if not torch.is_grad_enabled():
        # needs_input_grad follows requires_grad even under no_grad
        return _full_terms_impl(jitter, kernel, xs, lLmb, lLmb0, lnug, D,
                                a)[0]
    return _FullTerms.apply(jitter, kernel, xs, lLmb, lLmb0, lnug, D, a)


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


def make_loss(submethod: str, data, jitter: float = 0.0,
              q_chunk: int | None = None, kernel: str = 'matern32'):
    """Return ``loss(free_params)`` for the given submethod."""
    if submethod == 'full':
        def loss(free):
            return neglpost_full(free, data, jitter=jitter, q_chunk=q_chunk,
                                 kernel=kernel)
        return loss
    if submethod == 'rep':
        raise NotImplementedError(
            "submethod='rep' is not ported yet (ROADMAP.md Queue 1 item 10)")
    raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")
