"""FITC/Nyström inducing-point path for n >> 10^4 (counterpart of
``lcgp_tpu/models/sparse.py``).

Both exact losses share one algebraic core per component (likelihood.py):

    u    = (C + Lam)^{-1} Lam b          Lam diagonal:
    quad = b^T C u                         rep:  Lam = 1/(D r)
    ld   = logdet(C + Lam)                 full: Lam = (1/D) 1

FITC replaces the smooth kernel part with its Nyström approximation
Q = Knm Kmm^{-1} Kmn plus an exact diagonal correction:

    C_hat = Q + diag(c_diag - q_diag),  c_diag = amp (the Gram's diagonal)

so C_hat + Lam = W W^T + Lam~ with W = Knm Lmm^{-T} (n, m) and
Lam~ = Lam + c_diag - q_diag.  Woodbury gives everything at O(n m^2) per
component instead of O(n^3):

    M  = I_m + W^T Lam~^{-1} W,   LM = chol(M)
    (C_hat + Lam)^{-1} v = Lam~^{-1} v - Lam~^{-1} W M^{-1} W^T Lam~^{-1} v
    logdet(C_hat + Lam) = sum log Lam~ + logdet(M)

all of it batched over the q component axis.

The gradient is plain autograd through these tensor operations.  Kmm and
Knm come from :func:`~lcgp_tpu_torch.ops.gram.gram_stack`, which returns
through ``GramFn`` when a parameter or the inducing points ``z`` require a
gradient: on CUDA its backward is the kind's VJP kernel (K2, K3's or K4's)
at the cotangent autograd hands it, and K5 for ``z``.

Precision, as in the reference: Kmm, Lmm, M and LM are f64; Knm, W and the
n-sized work are in the compute dtype; the n-length reductions accumulate
in f64, an f32 product over n in blocks of G_BLOCK rows (:func:`_nsum`,
forward and backward), and an f32 loss takes its quadratic term in one
pass (:func:`_fitc_terms`).  Spans (``utils.profiling``, device time on
CUDA): ``lcgp.fitc.panel`` Knm and W's solve, ``lcgp.fitc.nsum`` each
blocked sum and each one's backward.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

from ..ops import linalg
from ..ops.gram import gram_stack
from ..ops.matern import matern32_diag
from ..utils.profiling import device_span
from . import params as P
from .likelihood import FullData, RepData, _dtypes

_F64 = torch.float64

# jitter on Kmm's diagonal (relative to amplitude): the Nyström factor is
# rank-deficient by construction when inducing points nearly coincide
KMM_JITTER = 1e-8


def select_inducing(x, m: int):
    """Greedy farthest-point (max-min) selection of m rows of x (n, d), a
    NumPy copy of the reference's: the same rows in the same order.

    Deterministic, O(n m).  Returns the (m, d) subset (all of x when
    m >= n)."""
    x = np.asarray(x, dtype=np.float64)
    n = x.shape[0]
    if m >= n:
        return x.copy()
    idx = [int(np.argmin(np.linalg.norm(x - x.mean(0), axis=1)))]
    d2 = np.sum((x - x[idx[0]]) ** 2, axis=1)
    for _ in range(m - 1):
        nxt = int(np.argmax(d2))
        idx.append(nxt)
        d2 = np.minimum(d2, np.sum((x - x[nxt]) ** 2, axis=1))
    return x[np.asarray(idx)]


# Every contraction over the n axis of an f32 panel goes through one rule,
# :func:`_nsum`.  A single f32 GEMM adds each entry's n terms into one
# accumulator, as cuBLAS does at these shapes: at config 7 (n = 400,000) an
# f32 G = W^T Lam~^{-1} W was 3.0e-5 (of the largest entry) off the f64
# product of the same inputs on an H100, where the CPU's BLAS was 1.7e-7
# off, and the 'fast' loss 17% off f64.  So an f32 contraction is summed over
# blocks of G_BLOCK rows, one GEMM a block, and the blocks' partials are
# added in f64 (tools/fitc_bisect.py on an H100: 1024 rows 6.3e-9 and the
# loss 1.3e-4 off, in 20.1 ms against the one GEMM's 20.7); its backward's
# products run over m, not n.  An f64 contraction stays one product.
G_BLOCK = 1024
# the partial products materialized at a time (entries): the blocked sum's
# extra memory stays ~128 MB whatever n
_G_GROUP_ENTRIES = 1 << 25


def _blocked_nsum(A, B, block):
    """sum_b A[:, :, b] @ B[:, b, :] in f64 over row blocks b of ``block``
    rows, each block's product in A's dtype; A (q, m, n), B (q, n, k).
    One component at a time, so that the blocks of A and B are strided
    views of the operands, not copies."""
    q, m, n = A.shape
    k = B.shape[-1]
    full = n - n % block
    rows = max(1, _G_GROUP_ENTRIES // (m * k)) * block
    out = torch.zeros((q, m, k), dtype=_F64, device=A.device)
    for c in range(q):
        for s in range(0, full, rows):
            e = min(s + rows, full)
            a = A[c, :, s:e].unflatten(-1, (-1, block)).transpose(0, 1)
            b = B[c, s:e, :].unflatten(0, (-1, block))
            out[c] += torch.sum(a @ b, dim=0, dtype=_F64)
    if full < n:
        out += (A[..., full:] @ B[..., full:, :]).to(_F64)
    return out


class _NSum(torch.autograd.Function):
    """:func:`_blocked_nsum` with the gradient of the plain product
    ``(A @ B).to(f64)``: the cotangent in A's dtype times the other
    operand, two GEMMs with sums over m and k.  (Autograd through the
    blocks' slices would build a gradient of A's and B's full size for
    each block.)  Each direction is an ``lcgp.fitc.nsum`` device span."""

    @staticmethod
    def forward(ctx, A, B):
        ctx.save_for_backward(A, B)
        _nsum.blocked += 1
        with device_span('lcgp.fitc.nsum', A.device):
            return _blocked_nsum(A, B, G_BLOCK)

    @staticmethod
    def backward(ctx, g):
        A, B = ctx.saved_tensors
        _nsum.backward += 1
        with device_span('lcgp.fitc.nsum', A.device):
            g = g.to(A.dtype)
            gA = g @ B.mT if ctx.needs_input_grad[0] else None
            gB = A.mT @ g if ctx.needs_input_grad[1] else None
        return gA, gB


def _nsum(A, B):
    """A @ B (q, m, k) in f64 for A (q, m, n), B (q, n, k): the sum over
    the n axis.  f64 operands: one product.  f32: a GEMM a block of
    :data:`G_BLOCK` rows, the partials added in f64 (:class:`_NSum`).  The
    counters ``_nsum.single``, ``.blocked`` and ``.backward`` count the
    calls of each kind (a backward: the blocked sum's)."""
    if A.dtype == _F64:
        _nsum.single += 1
        return A @ B
    return _NSum.apply(A, B)


_nsum.single = _nsum.blocked = _nsum.backward = 0


def _einsum_qnm_qn(W, v):
    """W^T v per component, (q, n, m), (q, n) -> (q, m) in f64: a sum over
    n (:func:`_nsum`; in f64 the einsum of old, whose bits the f64 losses
    keep)."""
    if W.dtype == _F64:
        _nsum.single += 1
        return torch.einsum('qnm,qn->qm', W, v)
    return _NSum.apply(W.mT, v[..., None])[..., 0]


def _einsum_qnm_qm(W, s):
    """W s per component: (q, n, m), (q, m) -> (q, n): its sums run over m.
    (No loss differentiates through it in f32, where the gradient in s
    would sum over n.)"""
    return torch.einsum('qnm,qm->qn', W, s)


def _lmm64(z, lLmb, lLmb0, lnug, kernel):
    """chol(Kmm + KMM_JITTER amp I) in f64, Kmm = C(z, z) with no nugget
    diagonal (``same=False``)."""
    Kmm64 = gram_stack(z, z, lLmb, lLmb0, lnug, same=False,
                       compute_dtype=None, kind=kernel).to(_F64)
    amp64 = lLmb0.to(_F64)
    return linalg.cholesky(linalg.add_diag(Kmm64, KMM_JITTER * amp64[:, None]))


class _PanelSolve(torch.autograd.Function):
    """W = Knm Lmm^{-T} for an f32 panel.  The solve's gradient in Lmm,
    -tril(Lmm^{-T} dW^T W), sums over n: it goes through :func:`_nsum`
    (autograd's own takes one f32 GEMM over n)."""

    @staticmethod
    def forward(ctx, Lmm, Knm):
        W = linalg.solve_tri_lower(Lmm, Knm.mT).mT
        ctx.save_for_backward(Lmm, W)
        return W

    @staticmethod
    def backward(ctx, gW):
        Lmm, W = ctx.saved_tensors
        gB = torch.linalg.solve_triangular(Lmm.mT, gW.mT, upper=True)
        gL = (-_nsum(gB, W).to(Lmm.dtype).tril_()
              if ctx.needs_input_grad[0] else None)
        return gL, gB.mT


def _panel(xs, z, Lmm, lLmb, lLmb0, lnug, lam, *, compute_dtype, kernel):
    """W = Knm Lmm^{-T} (q, n, m) and Lam~ (q, n) of the points xs, in
    Lmm's (the compute) dtype; Knm and the solve an ``lcgp.fitc.panel``
    device span."""
    dt = Lmm.dtype
    with device_span('lcgp.fitc.panel', xs.device):
        Knm = gram_stack(xs, z, lLmb, lLmb0, lnug, same=False,
                         compute_dtype=compute_dtype, kind=kernel)
        # W = Knm Lmm^{-T}: solve Lmm W^T = Knm^T
        W = (linalg.solve_tri_lower(Lmm, Knm.mT).mT if dt == _F64
             else _PanelSolve.apply(Lmm, Knm))
    q_diag = torch.sum(torch.square(W), dim=-1)                # (q, n)
    c_diag = lLmb0.to(_F64).to(dt)[:, None] * torch.ones_like(q_diag)
    # torch.maximum splits a tie's gradient as jnp.maximum does
    lam_t = torch.maximum(
        lam.to(dt) + torch.maximum(c_diag - q_diag, torch.zeros_like(q_diag)),
        torch.full((), 1e-10, dtype=dt, device=W.device))
    return W, lam_t


class FitcCore(NamedTuple):
    """Per-component Woodbury state shared by loss and predict."""
    Lmm: torch.Tensor     # (q, m, m) chol of Kmm + jitter, compute dtype
    W: torch.Tensor       # (q, n, m) Knm Lmm^{-T}
    lam_t: torch.Tensor   # (q, n) Lam~ = Lam + c_diag - q_diag
    LM: torch.Tensor      # (q, m, m) f64 chol(I + W^T Lam~^{-1} W)


def _fitc_core(xs, z, lLmb, lLmb0, lnug, lam, *, compute_dtype, kernel):
    """Build the Woodbury state.  lam: (q, n) exact diagonal.

    The O(n m^2) work (Knm, the W panel solve, the M assembly GEMM) runs in
    the compute dtype; the (m, m) factorizations are always f64, since an
    f32 Cholesky of a near-rank-deficient Kmm gives NaNs that no jitter
    reliably prevents."""
    dt = _dtypes(compute_dtype, z)[0]
    Lmm = _lmm64(z, lLmb, lLmb0, lnug, kernel).to(dt)
    W, lam_t = _panel(xs, z, Lmm, lLmb, lLmb0, lnug, lam,
                      compute_dtype=compute_dtype, kernel=kernel)
    WtLi = W.mT / lam_t[:, None, :]                            # (q, m, n)
    M64 = linalg.add_diag(_nsum(WtLi, W), 1.0)
    LM = linalg.cholesky(M64)                                  # (q, m, m) f64
    return FitcCore(Lmm=Lmm, W=W, lam_t=lam_t, LM=LM)


def _fitc_solve(core: FitcCore, v):
    """(C_hat + Lam)^{-1} v for v (q, n) via Woodbury.  The (m, m) solve
    runs in f64 (LM is an f64 factor); the n-sized ops keep v's dtype."""
    vi = v / core.lam_t
    t = _einsum_qnm_qn(core.W, vi)
    s = linalg.cho_solve_vec(core.LM, t.to(core.LM.dtype)).to(v.dtype)
    return vi - _einsum_qnm_qm(core.W, s) / core.lam_t


def _fitc_logdet(core: FitcCore):
    return (torch.sum(torch.log(core.lam_t.to(core.LM.dtype)), dim=-1)
            + linalg.chol_logdet(core.LM))                     # (q,) f64


def _fitc_terms(core: FitcCore, lam, b):
    """quad = b^T C_hat u and ld per component, u = (C_hat + Lam)^{-1}
    Lam b.  The n-length reductions accumulate in f64 whatever the compute
    dtype: at n=50k an f32 sum of O(1) terms resolves the loss only to ~1e0
    absolute, which blinds a line search.

    In f32, quad = sum lam b^2 - sum lam b vi + t^T M^{-1} t with
    vi = lam b / Lam~ and t = W^T vi (the streamed path's one pass, the
    benchmark reference's recipe).  Through u instead, u = vi - Lam~^{-1}
    W M^{-1} t cancels, and C_hat u = W W^T u + (Lam~ - Lam) u multiplies
    u's rounding by C_hat: along a 'fast' fit at config 7 that path left
    f64 by up to 1e-2 an output entry (``tools/fitc_bisect.py --along``;
    PERF.md).  In f64 quad goes through u, lcgp_tpu's path, whose bits the
    f64 losses keep."""
    dt = core.W.dtype
    b = b.to(dt)
    lb = lam.to(dt) * b
    if dt == _F64:
        u = _fitc_solve(core, lb)
        # C_hat u = W W^T u + (lam_t - lam) u   (diag corr = lam_t - lam)
        Cu = (_einsum_qnm_qm(core.W, _einsum_qnm_qn(core.W, u))
              + (core.lam_t - lam.to(dt)) * u)
        quad = torch.sum(b * Cu, dim=-1)
    else:
        vi = lb / core.lam_t
        t = _einsum_qnm_qn(core.W, vi)
        s = linalg.cho_solve_vec(core.LM, t)
        quad = (torch.sum((lb * b).to(_F64), dim=-1)
                - torch.sum((lb * vi).to(_F64), dim=-1)
                + torch.sum(t * s, dim=-1))
    return quad, _fitc_logdet(core)


class FitcStream(NamedTuple):
    """Accumulated Woodbury state from one streaming pass over n-blocks:
    only (q, m, m), (q, m) and (q,) accumulators, so the resident memory is
    O(q m^2) plus one block's (q, n_chunk, m) working set whatever n."""
    Lmm: torch.Tensor     # (q, m, m) compute-dtype chol of Kmm + jitter
    LM: torch.Tensor      # (q, m, m) f64 chol(I + G)
    G: torch.Tensor       # (q, m, m) f64  W^T Lam~^{-1} W
    t: torch.Tensor       # (q, m)  f64  W^T (Lam b / Lam~)
    s: torch.Tensor       # (q, m)  f64  M^{-1} t
    quad: torch.Tensor    # (q,)    f64  b^T C_hat u
    ld: torch.Tensor      # (q,)    f64  logdet(C_hat + Lam)


def _pad_blocks(n, n_chunk):
    """(n_blocks, pad) for splitting an n-axis into n_chunk-sized blocks."""
    n_blocks = -(-n // n_chunk)
    return n_blocks, n_blocks * n_chunk - n


def _blocks(xs, lam, b, n_chunk):
    """The n-axis of xs (n, d), lam and b (q, n) cut into n_chunk blocks:
    [(xs_b, lam_b, b_b, w_b)].  Padded rows reuse xs[0] (finite Gram
    values), lam 1 and b 0, and are masked out of every accumulator by the
    weight w_b (1 on real rows, 0 on padding)."""
    q, n = lam.shape
    n_blocks, pad = _pad_blocks(n, n_chunk)
    w = torch.ones((n,), dtype=_F64, device=xs.device)
    if pad:
        xs = torch.cat([xs, xs[:1].expand(pad, xs.shape[1])])
        lam = torch.cat([lam, torch.ones((q, pad), dtype=lam.dtype,
                                         device=lam.device)], dim=1)
        b = torch.cat([b, torch.zeros((q, pad), dtype=b.dtype,
                                      device=b.device)], dim=1)
        w = torch.cat([w, torch.zeros((pad,), dtype=_F64, device=xs.device)])
    return [(xs[s:s + n_chunk], lam[:, s:s + n_chunk], b[:, s:s + n_chunk],
             w[s:s + n_chunk]) for s in range(0, n_blocks * n_chunk, n_chunk)]


def _stream_block(xs_b, z, Lmm, lLmb, lLmb0, lnug, lam_b, b_b, w_b, *,
                  compute_dtype, kernel):
    """One block's contributions to the stream's accumulators:
    (G, t, sum log Lam~, sum lam b^2, sum lam b vi), in f64."""
    W, lam_t = _panel(xs_b, z, Lmm, lLmb, lLmb0, lnug, lam_b,
                      compute_dtype=compute_dtype, kernel=kernel)
    dt = Lmm.dtype
    lam_dt = lam_b.to(dt)
    b_dt = b_b.to(dt)
    vi = lam_dt * b_dt / lam_t                                 # (q, nc)
    wq = w_b.to(dt)[None, :]
    G = _nsum(W.mT * (wq / lam_t)[:, None, :], W)
    t = _einsum_qnm_qn(W, wq * vi)
    sumlog = torch.sum(w_b * torch.log(lam_t.to(_F64)), dim=-1)
    bb = torch.sum((wq * lam_dt * b_dt * b_dt).to(_F64), dim=-1)
    bu = torch.sum((wq * lam_dt * b_dt * vi).to(_F64), dim=-1)
    return G, t, sumlog, bb, bu


def _fitc_stream(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk, *,
                 compute_dtype, kernel):
    """Single-pass streaming (n-blocked) Woodbury accumulation.

    The un-chunked core holds the (q, n, m) W panel and autograd's copies
    of it.  This version loops over n-blocks: each block builds its Knm/W
    slice and returns its O(q m^2) contributions, under
    ``torch.utils.checkpoint`` when a gradient is recorded, so the backward
    recomputes each block (one Gram launch more per block) instead of
    keeping it.

    One pass suffices: with u = (C_hat + Lam)^{-1} Lam b,

        quad = b^T C_hat u = sum lam b^2 - sum (lam b)^2 / lam_t
               + t^T M^{-1} t

    so the quadratic term needs only the accumulators of the logdet."""
    dt = _dtypes(compute_dtype, z)[0]
    Lmm = _lmm64(z, lLmb, lLmb0, lnug, kernel).to(dt)
    q, m = lam.shape[0], z.shape[0]
    G = torch.zeros((q, m, m), dtype=_F64, device=z.device)
    t = torch.zeros((q, m), dtype=_F64, device=z.device)
    sumlog, acc_bb, acc_bu = (torch.zeros((q,), dtype=_F64, device=z.device)
                              for _ in range(3))

    def block(xs_b, z, Lmm, lLmb, lLmb0, lnug, lam_b, b_b, w_b):
        return _stream_block(xs_b, z, Lmm, lLmb, lLmb0, lnug, lam_b, b_b,
                             w_b, compute_dtype=compute_dtype, kernel=kernel)

    remat = torch.is_grad_enabled()
    for xs_b, lam_b, b_b, w_b in _blocks(xs, lam, b, n_chunk):
        args = (xs_b, z, Lmm, lLmb, lLmb0, lnug, lam_b, b_b, w_b)
        parts = (checkpoint(block, *args, use_reentrant=False,
                            preserve_rng_state=False) if remat
                 else block(*args))
        G = G + parts[0]
        t = t + parts[1]
        sumlog = sumlog + parts[2]
        acc_bb = acc_bb + parts[3]
        acc_bu = acc_bu + parts[4]

    LM = linalg.cholesky(linalg.add_diag(G, 1.0))
    s = linalg.cho_solve_vec(LM, t)
    quad = acc_bb - acc_bu + torch.sum(t * s, dim=-1)
    ld = sumlog + linalg.chol_logdet(LM)
    return FitcStream(Lmm=Lmm, LM=LM, G=G, t=t, s=s, quad=quad, ld=ld)


def _full_lam_b(free: P.FreeParams, data: FullData):
    """(lam, b) of the full path: lam = 1/D broadcast to (q, n) and
    b = a = (Y^T psi_c)^T with psi_c = phi / sqrt(sigma)."""
    _, _, lsig_g, _ = P.constrain(free)
    sigma = torch.exp(P.expand_sigma(lsig_g, data.sigma_map))
    psi_c = data.phi / torch.sqrt(sigma)[:, None]
    a = (data.ys.T @ psi_c).T                                  # (q, n)
    lam = (1.0 / data.diag_D)[:, None].expand(a.shape)
    return lam, a


def _rep_lam_b(free: P.FreeParams, data: RepData):
    """(lam, b) of the rep path: lam = 1/(D r), b = r (ybar^T v)^T with
    v = phi scale / sqrt(sigma)."""
    _, _, lsig_g, _ = P.constrain(free)
    sigma_raw = torch.exp(P.expand_sigma(lsig_g, data.sigma_map))
    v = data.phi * (data.scale / torch.sqrt(sigma_raw))[:, None]
    b = data.r[None, :] * (data.ybar.T @ v).T                  # (q, n)
    lam = 1.0 / (data.diag_D[:, None] * data.r[None, :])
    return lam, b


def _quad_ld(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk, compute_dtype,
             kernel):
    if n_chunk:
        st = _fitc_stream(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
                          compute_dtype=compute_dtype, kernel=kernel)
        return st.quad, st.ld
    core = _fitc_core(xs, z, lLmb, lLmb0, lnug, lam,
                      compute_dtype=compute_dtype, kernel=kernel)
    return _fitc_terms(core, lam, b)


def neglpost_full_fitc(free: P.FreeParams, data: FullData, z,
                       compute_dtype=None, kernel: str = 'matern32',
                       n_chunk: int | None = None):
    """FITC approximation of the full-data loss (likelihood.neglpost_full
    semantics, reference lcgp.py:635-666) at O(q n m^2).  ``n_chunk``
    streams the n axis in blocks of that many points."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)
    n = data.xs.shape[0]
    lam, a = _full_lam_b(free, data)
    quad, ld = _quad_ld(data.xs, z, lLmb, lLmb0, lnug, lam, a, n_chunk,
                        compute_dtype, kernel)
    # logdet(I + D C_hat) = n log D + logdet(C_hat + (1/D) I)
    D = data.diag_D
    terms = 0.5 * (n * torch.log(D.to(ld.dtype)) + ld) - 0.5 * quad
    nlp = torch.sum(terms).to(data.ys.dtype)
    nlp = nlp + 0.5 * n * torch.sum(lsig)
    nlp = nlp + 0.5 * torch.sum(
        torch.square(data.ys / torch.sqrt(sigma)[:, None]))
    return nlp


def neglpost_rep_fitc(free: P.FreeParams, data: RepData, z,
                      compute_dtype=None, kernel: str = 'matern32',
                      n_chunk: int | None = None):
    """FITC approximation of the replication loss (likelihood.neglpost_rep
    semantics, reference lcgp.py:554-630) at O(q n m^2), divided by n."""
    lLmb, lLmb0, lsig_g, lnug = P.constrain(free)
    lsig = P.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = torch.exp(lsig)
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    r = data.r

    sigma_var_used = sigma_raw / torch.square(data.scale)
    sigma_inv_sqrt = data.scale / torch.sqrt(sigma_raw)

    nlp = 0.5 * torch.sum(r * torch.sum(
        torch.square(data.ybar * sigma_inv_sqrt[:, None]), dim=0))
    nlp = nlp + 0.5 * n * torch.sum(torch.log(sigma_var_used))
    nlp = nlp - 0.5 * p * torch.sum(torch.log(r))

    lam, b = _rep_lam_b(free, data)
    quad, ld = _quad_ld(data.xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
                        compute_dtype, kernel)
    # logdet A = sum_i log(D r_i) + logdet(C_hat + Lam)
    D = data.diag_D
    terms = 0.5 * (torch.sum(torch.log(D[:, None] * r[None, :]), dim=-1)
                   .to(ld.dtype) + ld) - 0.5 * quad
    nlp = nlp + torch.sum(terms).to(nlp.dtype)
    return nlp / n


class FitcAux(NamedTuple):
    """Predictive state: dual weights in inducing space + variance kernel."""
    Lmm: torch.Tensor     # (q, m, m)
    alpha: torch.Tensor   # (q, m)  W^T u  (mean: ghat = W0 alpha)
    inner: torch.Tensor   # (q, m, m) f64 G M^{-1} (variance reduction kernel)
    u: torch.Tensor       # (q, n) dual weights (diagnostic)


@torch.no_grad()
def compute_aux_fitc(free: P.FreeParams, data, z, mode: str,
                     compute_dtype=None, kernel: str = 'matern32',
                     n_chunk: int | None = None) -> FitcAux:
    """The predictive aux of the FITC model, forward only.  ``mode`` is the
    submethod ('full' or 'rep')."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    lam, b = (_rep_lam_b if mode == 'rep' else _full_lam_b)(free, data)
    if n_chunk:
        return _compute_aux_fitc_streamed(
            data.xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
            compute_dtype=compute_dtype, kernel=kernel)

    core = _fitc_core(data.xs, z, lLmb, lLmb0, lnug, lam,
                      compute_dtype=compute_dtype, kernel=kernel)
    dt = core.W.dtype
    u = _fitc_solve(core, lam.to(dt) * b.to(dt))
    alpha = _einsum_qnm_qn(core.W, u).to(dt)
    # G = W^T Lam~^{-1} W = M - I; the variance reduction kernel is
    # G - G M^{-1} G = G M^{-1} (M = I + G commutes with G), symmetric PSD
    Minv = linalg.chol_inverse(core.LM)                        # f64
    G = _nsum(core.W.mT / core.lam_t[:, None, :], core.W)
    inner = G @ Minv
    inner = 0.5 * (inner + inner.mT)
    return FitcAux(Lmm=core.Lmm, alpha=alpha, inner=inner, u=u)


def _compute_aux_fitc_streamed(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk, *,
                               compute_dtype, kernel) -> FitcAux:
    """Memory-bounded aux: one accumulation pass (shared with the loss)
    plus a second forward sweep for the (q, n) dual weights u.

    alpha = W^T u collapses onto the pass-1 accumulators:
        u = Lam~^{-1}(Lam b) - Lam~^{-1} W s  =>  alpha = t - G s.
    The u sweep recomputes each W block and keeps only its (q, n_chunk)
    outputs."""
    st = _fitc_stream(xs, z, lLmb, lLmb0, lnug, lam, b, n_chunk,
                      compute_dtype=compute_dtype, kernel=kernel)
    dt = st.Lmm.dtype
    alpha = (st.t - torch.einsum('qmk,qk->qm', st.G, st.s)).to(dt)
    Minv = linalg.chol_inverse(st.LM)
    inner = st.G @ Minv
    inner = 0.5 * (inner + inner.mT)

    s_dt = st.s.to(dt)
    u_blocks = []
    for xs_b, lam_b, b_b, _ in _blocks(xs, lam, b, n_chunk):
        W, lam_t = _panel(xs_b, z, st.Lmm, lLmb, lLmb0, lnug, lam_b,
                          compute_dtype=compute_dtype, kernel=kernel)
        u_blocks.append((lam_b.to(dt) * b_b.to(dt)
                         - _einsum_qnm_qm(W, s_dt)) / lam_t)
    u = torch.cat(u_blocks, dim=1)[:, :lam.shape[1]]
    return FitcAux(Lmm=st.Lmm, alpha=alpha, inner=inner, u=u)


def predict_fitc_core(free: P.FreeParams, data, aux: FitcAux, z, x0s,
                      compute_dtype=None, kernel: str = 'matern32'):
    """Latent predictive mean/var at x0s: O(n0 m) mean, O(n0 m^2) var.
    ghat is in the aux's dtype, gvar in f64 (the variance kernel's)."""
    lLmb, lLmb0, _, lnug = P.constrain(free)
    c00 = matern32_diag(x0s, lLmb0)                            # (q, n0)
    K0m = gram_stack(x0s, z, lLmb, lLmb0, lnug, same=False,
                     compute_dtype=compute_dtype, kind=kernel)  # (q, n0, m)
    W0 = linalg.solve_tri_lower(aux.Lmm, K0m.mT).mT
    ghat = _einsum_qnm_qm(W0, aux.alpha)
    W0i = W0.to(aux.inner.dtype)
    red = torch.einsum('qam,qmk,qak->qa', W0i, aux.inner, W0i)
    gvar = c00.to(red.dtype) - red
    # negative entries are a bad-inducing-set symptom; the model layer
    # clamps and counts them (health_check surfaces the statistics)
    return ghat, gvar


def clamp_variance(gvar):
    """Clamp negative predictive variances to zero, returning the clamped
    tensor plus (count, worst) clamp statistics as device scalars."""
    neg = gvar < 0.0
    count = torch.sum(neg)
    worst = torch.min(torch.where(neg, gvar, torch.zeros_like(gvar)))
    return torch.clamp_min(gvar, 0.0), count, worst
