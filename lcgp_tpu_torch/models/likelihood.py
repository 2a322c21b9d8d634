"""Negative log marginal posteriors, full and replication paths, with
their gradients (counterpart of ``lcgp_tpu/models/likelihood.py``).

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

The replication path (``submethod='rep'``, unique sites with r_i
replicates) has, with Lam_k = diag(1/(D_k r)) and A_k = C_k + Lam_k,

    t_k = -0.5 b_k^T C_k u_k + 0.5 (sum_i log(D_k r_i) + logdet A_k),
    u_k = A_k^{-1} Lam_k b_k,
    dt/dC = 0.5 A^{-1} - 0.5 u u^T,   dt/db = -C u

(``lcgp_tpu/models/likelihood.py:152-161``).  A is built directly (the K1
epilogue with row scale 1 and diagonal lam + jitter), ``C u`` recovers as
``Lam b - (lam + jitter) u``, and the gradient runs K2 at alpha = 1/2 and
M = A^{-1}.

``compute_dtype`` is the precision mode (``lcgp_tpu/models/likelihood.py
:25-61``): None for 'high'; the 'mixed' sentinel ('mixed:N' for N
refinement steps) builds the target in f64 (K1 f64), factors and solves it
through ``ops/mixed.py`` and runs the gradient work in f32 (the f32 potri
seed as B^{-1}, K2 f32); ``torch.float32`` ('fast') builds, factors and
solves in f32 (K1 and K2 f32).  Both keep the substitution flow, and the
n-length sums accumulate in f64.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..ops import linalg
from ..ops import mixed as mixed_ops
from ..ops.gram import gram_factor_target, gram_vjp_fused
from . import params as P


class FullData(NamedTuple):
    """Static training tensors for submethod='full'."""
    xs: torch.Tensor         # (n, d) standardized inputs
    ys: torch.Tensor         # (p, n) standardized outputs
    phi: torch.Tensor        # (p, q)
    diag_D: torch.Tensor     # (q,)
    sigma_map: torch.Tensor  # (p,) int64 output-dim -> error group


class RepData(NamedTuple):
    """Static training tensors for submethod='rep'.

    ``scale`` is ybar_std when rep_standardize_ybar is on (then the noise
    variance used is sigma2 / scale^2, reference lcgp.py:576-584) and ones
    otherwise; ``ybar`` holds the matrix the loss consumes (standardized
    or raw)."""
    xs: torch.Tensor         # (n, d) standardized unique inputs
    ybar: torch.Tensor       # (p, n) replicate-averaged outputs
    scale: torch.Tensor      # (p,) ybar_std (or ones)
    r: torch.Tensor          # (n,) float replicate counts
    phi: torch.Tensor        # (p, q)
    diag_D: torch.Tensor     # (q,)
    sigma_map: torch.Tensor  # (p,) int64


def _bmv(mats: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """Batched matrix-vector: (q,n,m) @ (q,m) -> (q,n)."""
    return torch.matmul(mats, vecs[..., :, None])[..., :, 0]


def _factor(B: torch.Tensor, compute_dtype) -> torch.Tensor:
    """Cholesky of the factorization target; under 'mixed' ('mixed:N' for
    N refinement steps) an f32 factor refined to f64 grade.  The caller
    gives B up under 'high' and 'fast', whose solves do not read it: the
    factor may then be formed in B's storage, to save a (qc, n, n)
    buffer.  'mixed' keeps B for its refined solves."""
    steps = mixed_ops.parse_refine(compute_dtype)
    if steps is not None:
        return mixed_ops.cholesky_mixed(B, refine_steps=steps,
                                        seed_jitter=1e-6)
    return linalg.cholesky(B, overwrite=True)


def _factor_solve_vec(L: torch.Tensor, B: torch.Tensor, v: torch.Tensor,
                      compute_dtype) -> torch.Tensor:
    steps = mixed_ops.parse_refine(compute_dtype)
    if steps is not None:
        return mixed_ops.cho_solve_vec_refined(L, B, v, refine_steps=steps)
    return linalg.cho_solve_vec(L, v)


def _factor_inverse(L: torch.Tensor, compute_dtype) -> torch.Tensor:
    """(L L^T)^{-1} for the loss gradient.  The caller gives L up: under
    'high' and 'fast' the inverse is formed in L's storage, to save a
    (qc, n, n) buffer.  'mixed' takes the f32 potri seed alone
    (newton_steps=0): an f64-grade loss with f32-grade gradients, as
    ``lcgp_tpu/models/likelihood.py:42-61`` designs it; 'mixed:N'
    tightens only the forward refinement."""
    if mixed_ops.is_mixed(compute_dtype):
        return mixed_ops.chol_inverse_from_factor_mixed(L, newton_steps=0)
    return linalg.chol_inverse(L, overwrite=True)


def _dtypes(compute_dtype, xs):
    """(dt, vdt): the dtype the Gram and factor are built in (f32 under
    'fast', the data's under 'high' and 'mixed') and the one the gradient
    work runs in (f32 under 'mixed' and 'fast')."""
    mixed = mixed_ops.is_mixed(compute_dtype)
    dt = xs.dtype if compute_dtype is None or mixed else compute_dtype
    return dt, (torch.float32 if mixed else dt)


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


def _full_terms_impl(compute_dtype, jitter: float, kernel: str, xs, lLmb,
                     lLmb0, lnug, D, a, want_kernel_grad: bool = False):
    """The component terms (qc,), -C w (the gradient in a), and, when
    ``want_kernel_grad``, the gradients (glens, gamp, gnug) of the terms in
    the kernel parameters.

    compute_dtype: None ('high'), the 'mixed' sentinel (f64 Gram, refined
    factor and solve, f32 gradient work) or torch.float32 ('fast': f32
    Gram, factor and solves).  The n-length sums accumulate in f64."""
    n = xs.shape[0]
    dt, vdt = _dtypes(compute_dtype, xs)
    diag_vec = torch.full((D.shape[0], n), 1.0 + jitter, dtype=dt,
                          device=xs.device)
    B = gram_factor_target(xs, lLmb, lLmb0, lnug, row_scale=D,
                           diag_vec=diag_vec, compute_dtype=compute_dtype,
                           kind=kernel)
    LB = _factor(B, compute_dtype)
    a_c = a.to(LB.dtype)
    w = _factor_solve_vec(LB, B, a_c, compute_dtype)
    del B
    logdet = linalg.chol_logdet(LB)
    Dm = D.to(LB.dtype)
    Cw = (a_c - (1.0 + jitter) * w) / Dm[:, None]
    quad = torch.sum((a_c * Cw).to(torch.float64), dim=-1)
    terms = 0.5 * logdet - 0.5 * quad
    if not want_kernel_grad:
        return terms, Cw, None
    # 'mixed' seeds the inverse from the f32 cast of the refined factor
    Binv = _factor_inverse(LB.to(vdt), compute_dtype).to(vdt)
    del LB
    # the cotangent 0.5 D B^{-1} - 0.5 w w^T of the Gram, in vdt: K2 runs
    # in the cotangent's dtype
    kgrad = gram_vjp_fused(xs, lLmb, lLmb0, lnug, M=Binv,
                           alpha=0.5 * Dm.to(vdt), beta=-0.5,
                           w=w.to(vdt).contiguous(), kind=kernel)
    return terms, Cw, kgrad


def _scale(g, t):
    return None if g is None else t.to(g.dtype) * g


class _FullTerms(torch.autograd.Function):
    """Component terms with the gradient formed in the forward.

    The forward does the extra work (B^{-1}, the Gram VJP) only for the
    inputs ``ctx.needs_input_grad`` names, so ``loss()`` without a gradient
    costs what the value alone costs."""

    @staticmethod
    def forward(ctx, compute_dtype, jitter, kernel, xs, lLmb, lLmb0, lnug, D,
                a):
        want = ctx.needs_input_grad
        terms, Cw, kgrad = _full_terms_impl(
            compute_dtype, jitter, kernel, xs, lLmb, lLmb0, lnug, D, a,
            want_kernel_grad=any(want[4:7]))
        glens0, gamp0, gnug0 = kgrad if kgrad is not None else (None,) * 3
        ctx.save_for_backward(glens0, gamp0, gnug0,
                              (-Cw).to(a.dtype) if want[8] else None)
        return terms

    @staticmethod
    def backward(ctx, tbar):
        glens0, gamp0, gnug0, abar0 = ctx.saved_tensors
        return (None, None, None, None, _scale(glens0, tbar[:, None]),
                _scale(gamp0, tbar), _scale(gnug0, tbar), None,
                _scale(abar0, tbar[:, None]))


def _full_terms(compute_dtype, jitter: float, kernel: str, xs, lLmb, lLmb0,
                lnug, D, a):
    if not torch.is_grad_enabled():
        # needs_input_grad follows requires_grad even under no_grad
        return _full_terms_impl(compute_dtype, jitter, kernel, xs, lLmb,
                                lLmb0, lnug, D, a)[0]
    return _FullTerms.apply(compute_dtype, jitter, kernel, xs, lLmb, lLmb0,
                            lnug, D, a)


def neglpost_full(free: P.FreeParams, data: FullData, compute_dtype=None,
                  jitter: float = 0.0, q_chunk: int | None = None,
                  kernel: str = 'matern32'):
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
        return _full_terms(compute_dtype, jitter, kernel, data.xs,
                           *stacks)                        # (qc,)

    terms = _map_components(body, (lLmb, lLmb0, lnug, data.diag_D, a),
                            q_chunk)
    nlp = torch.sum(terms).to(data.ys.dtype)
    nlp = nlp + 0.5 * n * torch.sum(lsig)
    nlp = nlp + 0.5 * torch.sum(torch.square(data.ys / torch.sqrt(sigma)[:, None]))
    return nlp


def _rep_terms_impl(compute_dtype, jitter: float, kernel: str, xs, sr,
                    lLmb, lLmb0, lnug, D, b, want_kernel_grad: bool = False):
    """The rep component terms (qc,), -C u (the gradient in b), and, when
    ``want_kernel_grad``, the gradients (glens, gamp, gnug) of the terms in
    the kernel parameters.  compute_dtype as in :func:`_full_terms_impl`."""
    dt, vdt = _dtypes(compute_dtype, xs)
    Dc = D.to(dt)
    r2 = torch.square(sr.to(dt))   # r through its square root, as in JAX
    lam = 1.0 / (Dc[:, None] * r2[None, :])                  # (qc, n)
    # jitter scaled by the amplitude (0 under 'high')
    diag_vec = (lam + jitter * (1.0 + lLmb0.to(dt)[:, None])).contiguous()
    A = gram_factor_target(xs, lLmb, lLmb0, lnug,
                           row_scale=torch.ones_like(Dc), diag_vec=diag_vec,
                           compute_dtype=compute_dtype, kind=kernel)
    LT = _factor(A, compute_dtype)
    lam_b = lam * b.to(dt)
    u = _factor_solve_vec(LT, A, lam_b, compute_dtype)
    del A
    Cu = lam_b - diag_vec * u                                # C u from A u
    logdetA = (torch.sum(torch.log(Dc[:, None] * r2[None, :])
                         .to(torch.float64), dim=-1)
               + linalg.chol_logdet(LT))
    terms = (-0.5 * torch.sum((b.to(dt) * Cu).to(torch.float64), dim=-1)
             + 0.5 * logdetA)
    if not want_kernel_grad:
        return terms, Cu, None
    Tinv = _factor_inverse(LT.to(vdt), compute_dtype).to(vdt)  # (C + Lam)^-1
    del LT
    # the cotangent 0.5 A^{-1} - 0.5 u u^T of the Gram
    kgrad = gram_vjp_fused(xs, lLmb, lLmb0, lnug, M=Tinv,
                           alpha=torch.full_like(Dc, 0.5, dtype=vdt),
                           beta=-0.5, w=u.to(vdt).contiguous(), kind=kernel)
    return terms, Cu, kgrad


class _RepTerms(torch.autograd.Function):
    """Rep component terms with the gradient formed in the forward, as
    :class:`_FullTerms`: A^{-1} and the Gram VJP only for the inputs
    ``ctx.needs_input_grad`` names."""

    @staticmethod
    def forward(ctx, compute_dtype, jitter, kernel, xs, sr, lLmb, lLmb0,
                lnug, D, b):
        want = ctx.needs_input_grad
        terms, Cu, kgrad = _rep_terms_impl(
            compute_dtype, jitter, kernel, xs, sr, lLmb, lLmb0, lnug, D, b,
            want_kernel_grad=any(want[5:8]))
        glens0, gamp0, gnug0 = kgrad if kgrad is not None else (None,) * 3
        ctx.save_for_backward(glens0, gamp0, gnug0,
                              (-Cu).to(b.dtype) if want[9] else None)
        return terms

    @staticmethod
    def backward(ctx, tbar):
        glens0, gamp0, gnug0, bbar0 = ctx.saved_tensors
        return (None, None, None, None, None, _scale(glens0, tbar[:, None]),
                _scale(gamp0, tbar), _scale(gnug0, tbar), None,
                _scale(bbar0, tbar[:, None]))


def _rep_terms(compute_dtype, jitter: float, kernel: str, xs, sr, lLmb,
               lLmb0, lnug, D, b):
    if not torch.is_grad_enabled():
        return _rep_terms_impl(compute_dtype, jitter, kernel, xs, sr, lLmb,
                               lLmb0, lnug, D, b)[0]
    return _RepTerms.apply(compute_dtype, jitter, kernel, xs, sr, lLmb,
                           lLmb0, lnug, D, b)


def neglpost_rep(free: P.FreeParams, data: RepData, compute_dtype=None,
                 jitter: float = 0.0, q_chunk: int | None = None,
                 kernel: str = 'matern32'):
    """Replication negative log marginal on the unique sites (reference
    lcgp.py:554-630): sum_k t_k plus the diagonal data terms, all divided
    by n, the number of unique sites."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)          # (p,)
    sigma_raw = torch.exp(lsig)
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    r = data.r
    sr = torch.sqrt(r)

    sigma_var_used = sigma_raw / torch.square(data.scale)
    sigma_inv_sqrt = data.scale / torch.sqrt(sigma_raw)    # (p,)

    nlp = 0.5 * torch.sum(r * torch.sum(
        torch.square(data.ybar * sigma_inv_sqrt[:, None]), dim=0))
    nlp = nlp + 0.5 * n * torch.sum(torch.log(sigma_var_used))
    nlp = nlp - 0.5 * p * torch.sum(torch.log(r))

    v = data.phi * sigma_inv_sqrt[:, None]                 # (p, q)
    b = r[None, :] * (data.ybar.T @ v).T                   # (q, n)

    def body(stacks):
        return _rep_terms(compute_dtype, jitter, kernel, data.xs, sr,
                          *stacks)                         # (qc,)

    terms = _map_components(body, (lLmb, lLmb0, lnug, data.diag_D, b),
                            q_chunk)
    nlp = nlp + torch.sum(terms).to(nlp.dtype)
    return nlp / n


def make_loss(submethod: str, data, compute_dtype=None, jitter: float = 0.0,
              q_chunk: int | None = None, kernel: str = 'matern32'):
    """Return ``loss(free_params)`` for the given submethod."""
    if submethod not in ('full', 'rep'):
        raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")
    neglpost = neglpost_full if submethod == 'full' else neglpost_rep

    def loss(free):
        return neglpost(free, data, compute_dtype=compute_dtype,
                        jitter=jitter, q_chunk=q_chunk, kernel=kernel)
    return loss
