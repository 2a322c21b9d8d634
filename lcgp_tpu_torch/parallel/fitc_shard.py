"""n-sharded FITC: the (q, n, m) Woodbury panel distributed over an ('n',)
or ('comp','n') mesh (counterpart of ``lcgp_tpu/parallel/fitc_shard.py``).

The one-device FITC path (``models/sparse.py``) costs O(n m^2) a component
but holds the (q, n, m) W panel, and autograd's copies of it, whole.  Every
n-contraction of its Woodbury core reduces into (m,) or (m, m) objects, so
each rank builds the panel rows of its block of points and the sums are
all-reduced: the same estimator, the sums reordered, with a rank's memory
and GEMM work divided by the 'n' size.

No hand-written backward is needed, unlike ``nshard.py``'s: autograd's
saved tensors are the rank's panel blocks, the footprint of the forward,
and every collective is a sum.  The gradient comes from ``group.py``'s
pieces: the free parameters and z enter through one
:meth:`~.group.Mesh.enter` node, each sum is a differentiable
:meth:`~.group.Mesh.all_reduce`, and the replicated (quad, logdet) leave
through :meth:`~.group.Mesh.leave`.  Kmm and its factor are computed on
every rank from the entered z and parameters, and enter/leave count their
gradient once.  On CUDA a rank's Knm block and Kmm run the kind's Gram
kernel (K1, K3 or K4), their VJPs the kind's VJP kernel in cross mode at
autograd's cotangent, and z's gradient K5, all through ``ops/gram.py``'s
``GramFn``.

On a ('comp','n') mesh the q components are also split over 'comp': the
per-component (quad, logdet) have no cross-component coupling, so each
'comp' group runs its components and the terms are gathered over 'comp'; q
not divisible by the 'comp' size is padded with neutral components (zero
phi columns, D 1, the last component's kernel parameters).  n not divisible
by the 'n' size is padded with rows that carry mask 0 (Lam~ 1, b 0, u 0,
no share of G).  The scalar p-axis terms are computed on the unpadded data, outside
the mesh code.

Every rank holds the whole training data, so a rank reads its rows where
the reference shards them.  Every function taking a mesh is a collective:
every rank of the mesh calls it with the same arguments, and every rank
issues the same collectives in the same order whatever its block holds.
"""
from __future__ import annotations

import torch

from ..models import likelihood as lik
from ..models import params as Pm
from ..models import sparse
from ..ops import linalg
from .group import Mesh
from .nshard import (AXIS, COMP, _comps, _gather_full, _gather_rows,
                     _n_pad, _n_size, _pad_q, _pad_q_params, _pad_to,
                     _padded_inputs, _q_pad, _qax, _rows)

_F64 = torch.float64


def _woodbury_block(xblk, mblk, lam, b, z, lLmb, lLmb0, lnug, *, mesh,
                    kernel, compute_dtype):
    """The blockwise mirror of ``sparse._fitc_core`` and ``_fitc_terms``.

    xblk (nb, d), mblk (nb,) and lam, b (q, nb) are this rank's rows; z and
    the parameters are replicated.  Padding rows (mblk 0) get Lam~ 1, b 0,
    u 0 and no share of G, so they add nothing to any sum.  The mask goes
    on WtLi and the (q, nb) vectors, not on the (q, nb, m) panel W: a
    masked copy of W would stay alive for the backward beside W, one panel
    more than one device holds.  Returns per-component (quad, ld), alike
    on the 'n' ranks, and the block state the aux needs (Lmm, G, LM,
    alpha, u)."""
    dt = lik._dtypes(compute_dtype, z)[0]
    Lmm = sparse._lmm64(z, lLmb, lLmb0, lnug, kernel).to(dt)
    W, lam_t = sparse._panel(xblk, z, Lmm, lLmb, lLmb0, lnug, lam,
                             compute_dtype=compute_dtype, kernel=kernel)
    mb = mblk.to(dt)[None, :]
    lam_t = torch.where(mb > 0, lam_t, torch.ones_like(lam_t))
    b = b.to(dt) * mb
    lam = lam.to(dt)

    WtLi = W.mT / lam_t[:, None, :] * mb[:, None, :]           # (q, m, nb)
    G = mesh.all_reduce(sparse._nsum(WtLi, W), AXIS, grad=True)  # (q, m, m)
    LM = linalg.cholesky(linalg.add_diag(G, 1.0))              # f64

    # u = (C_hat + Lam)^{-1} (Lam b): sparse._fitc_solve, two sums
    vi = lam * b / lam_t
    t = mesh.all_reduce(sparse._einsum_qnm_qn(W, vi), AXIS, grad=True)
    s64 = linalg.cho_solve_vec(LM, t.to(_F64))
    s = s64.to(dt)
    u = (vi - sparse._einsum_qnm_qm(W, s) / lam_t) * mb

    alpha = mesh.all_reduce(sparse._einsum_qnm_qn(W, u), AXIS,
                            grad=True).to(dt)
    if dt == _F64:
        Cu = sparse._einsum_qnm_qm(W, alpha) + (lam_t - lam) * u
        quad = mesh.all_reduce(torch.sum((b * Cu).to(_F64), dim=-1), AXIS,
                               grad=True)
    else:
        # sparse._fitc_terms' one pass: u's rounding times C_hat drifts
        lb = lam * b
        quad = mesh.all_reduce(torch.sum((lb * b).to(_F64), dim=-1)
                               - torch.sum((lb * vi).to(_F64), dim=-1),
                               AXIS, grad=True) + torch.sum(t * s64, dim=-1)
    ld = (mesh.all_reduce(torch.sum(torch.log(lam_t.to(_F64)), dim=-1), AXIS,
                          grad=True)
          + linalg.chol_logdet(LM))
    return quad, ld, (Lmm, G, LM, alpha, u)


def _pad_inputs(data, mesh: Mesh):
    """xs and its row mask padded to a multiple of the 'n' size:
    (xs, mask, n, n_pad)."""
    n = data.xs.shape[0]
    n_pad = _n_pad(mesh, n)
    return (*_padded_inputs(data.xs, n_pad), n, n_pad)


def _pad_q_fitc(mesh, phi, D, lLmb, lLmb0, lnug):
    """The q axis padded for a ('comp','n') mesh: phi gains zero columns
    (no data weight for the padded components), D pads with 1, the kernel
    parameters repeat the last component (a well-posed Kmm).  The padded
    components' terms are sliced away by the callers."""
    qp = _q_pad(mesh, phi.shape[1])
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    if qp != phi.shape[1]:
        phi = torch.cat([phi, phi.new_zeros((phi.shape[0],
                                             qp - phi.shape[1]))], dim=1)
    return phi, _pad_q(D, qp, fill=1.0), lLmb, lLmb0, lnug


def _enter(mesh, *tensors):
    """The tensors, those that require a gradient through one
    :meth:`~.group.Mesh.enter` node: a tensor that requires none stays out
    of it, so that its gradient kernel does not run (z outside
    ``refine_inducing``).  The flags are alike on every rank."""
    idx = [i for i, t in enumerate(tensors) if t.requires_grad]
    if not idx:
        return tensors
    out = list(tensors)
    for i, t in zip(idx, mesh.enter(*(tensors[i] for i in idx))):
        out[i] = t
    return tuple(out)


def _local(free, data, z, mesh, *, compute_dtype, kernel):
    """This rank's share of the Woodbury terms: the free parameters and z
    enter, the rank's rows and components go through
    :func:`_woodbury_block` (their (lam, b) by ``sparse``'s own helpers on
    the rank's block of the data), and the (qp, 2) terms (quad, ld) come
    back whole over q and alike on every rank, with the block state.
    Returns (terms, state, n)."""
    *leaves, z = _enter(mesh, *free, z)
    free = Pm.FreeParams(*leaves)
    lLmb, lLmb0, _, lnug = Pm.constrain(free)
    xs, mask, n, n_pad = _pad_inputs(data, mesh)
    rows = _rows(mesh, n_pad // _n_size(mesh))
    phi, D, lLmb, lLmb0, lnug = _pad_q_fitc(mesh, data.phi, data.diag_D,
                                            lLmb, lLmb0, lnug)
    qs = _comps(mesh, phi.shape[1])
    # the rank's block; the padding holds zero data (and r 1), so b is 0
    if isinstance(data, lik.RepData):
        block = data._replace(
            xs=xs[rows], ybar=_pad_to(data.ybar, n_pad, axis=1)[:, rows],
            r=_pad_to(data.r, n_pad, axis=0, fill=1.0)[rows],
            phi=phi[:, qs], diag_D=D[qs])
        lam, b = sparse._rep_lam_b(free, block)
    else:
        block = data._replace(
            xs=xs[rows], ys=_pad_to(data.ys, n_pad, axis=1)[:, rows],
            phi=phi[:, qs], diag_D=D[qs])
        lam, b = sparse._full_lam_b(free, block)
    quad, ld, state = _woodbury_block(
        block.xs, mask[rows], lam, b, z, lLmb[qs], lLmb0[qs], lnug[qs],
        mesh=mesh, kernel=kernel, compute_dtype=compute_dtype)
    terms = torch.stack([quad, ld], dim=1)                     # (qc, 2)
    if _qax(mesh):
        terms = mesh.all_gather(terms, COMP, grad=True).reshape(-1, 2)
    return terms, state, n


def _terms(free, data, z, mesh, *, compute_dtype, kernel):
    """(quad, ld) per real component, the replicated value leaving the
    mesh code (its gradient counted once), and n."""
    terms, _, n = _local(free, data, z, mesh, compute_dtype=compute_dtype,
                         kernel=kernel)
    q = data.phi.shape[1]
    terms = mesh.leave(terms)[:q]
    return terms[:, 0], terms[:, 1], n


def neglpost_full_fitc_nsharded(free: Pm.FreeParams, data: lik.FullData, z,
                                mesh: Mesh, compute_dtype=None,
                                kernel: str = 'matern32'):
    """The n-sharded FITC full-data loss: the estimator of
    ``sparse.neglpost_full_fitc`` (not divided by n), the panel's rows
    distributed over the mesh, alike on every rank.  A collective."""
    quad, ld, n = _terms(free, data, z, mesh, compute_dtype=compute_dtype,
                         kernel=kernel)
    _, _, lsig_g, _ = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    Dlog = torch.log(data.diag_D.to(ld.dtype))
    nlp = torch.sum(0.5 * (n * Dlog + ld) - 0.5 * quad).to(data.ys.dtype)
    nlp = nlp + 0.5 * n * torch.sum(lsig)
    sigma = torch.exp(lsig)
    return nlp + 0.5 * torch.sum(torch.square(data.ys
                                              / torch.sqrt(sigma)[:, None]))


def neglpost_rep_fitc_nsharded(free: Pm.FreeParams, data: lik.RepData, z,
                               mesh: Mesh, compute_dtype=None,
                               kernel: str = 'matern32'):
    """The n-sharded FITC replication loss: the estimator of
    ``sparse.neglpost_rep_fitc``, divided by n, alike on every rank.  A
    collective."""
    quad, ld, n = _terms(free, data, z, mesh, compute_dtype=compute_dtype,
                         kernel=kernel)
    _, _, lsig_g, _ = Pm.constrain(free)
    sigma_raw = torch.exp(Pm.expand_sigma(lsig_g, data.sigma_map))
    p = data.ybar.shape[0]
    # the scalar data terms: sums over the unpadded data
    sigma_var_used = sigma_raw / torch.square(data.scale)
    sigma_inv_sqrt = data.scale / torch.sqrt(sigma_raw)
    nlp = 0.5 * torch.sum(data.r * torch.sum(
        torch.square(data.ybar * sigma_inv_sqrt[:, None]), dim=0))
    nlp = nlp + 0.5 * n * torch.sum(torch.log(sigma_var_used))
    nlp = nlp - 0.5 * p * torch.sum(torch.log(data.r))
    Dlog = torch.log(data.diag_D.to(ld.dtype))
    sum_log_r = torch.sum(torch.log(data.r.to(ld.dtype)))
    terms = 0.5 * (n * Dlog + sum_log_r + ld) - 0.5 * quad
    return (nlp + torch.sum(terms).to(nlp.dtype)) / n


def make_loss(submethod: str, data, z, mesh: Mesh, compute_dtype=None,
              kernel: str = 'matern32'):
    """``loss(free)`` on the mesh, z closed over (``nshard.make_loss``'s
    contract, the FITC estimator).  A collective."""
    loss_fn = (neglpost_rep_fitc_nsharded if submethod == 'rep'
               else neglpost_full_fitc_nsharded)

    def loss(free):
        return loss_fn(free, data, z, mesh, compute_dtype=compute_dtype,
                       kernel=kernel)
    return loss


@torch.no_grad()
def compute_aux_fitc_nsharded(free: Pm.FreeParams, data, z, mode: str,
                              mesh: Mesh, compute_dtype=None,
                              kernel: str = 'matern32') -> sparse.FitcAux:
    """The FITC predictive aux, its O(n) build distributed.  Returns the
    one-device ``sparse.FitcAux``, replicated on every rank with ``u``
    gathered to (q, n) and trimmed of both paddings, so
    ``sparse.predict_fitc_core`` (and the server) consume it unchanged.
    ``mode`` is the submethod; it must match the data.  A collective."""
    if (mode == 'rep') != isinstance(data, lik.RepData):
        raise ValueError(f"mode={mode!r} does not match the data "
                         f"({type(data).__name__})")
    _, (Lmm, G, LM, alpha, u), n = _local(
        free, data, z, mesh, compute_dtype=compute_dtype, kernel=kernel)
    # the variance reduction kernel G M^{-1} (sparse.compute_aux_fitc)
    inner = G @ linalg.chol_inverse(LM)
    inner = 0.5 * (inner + inner.mT)
    q = data.phi.shape[1]

    def whole(t):
        return _gather_rows(mesh, t, COMP) if _qax(mesh) else t
    return sparse.FitcAux(Lmm=whole(Lmm)[:q], alpha=whole(alpha)[:q],
                          inner=whole(inner)[:q],
                          u=_gather_full(mesh, u)[:q, :n])
