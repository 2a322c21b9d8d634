"""n-axis sharded linear algebra for the large-n regime (counterpart of
``lcgp_tpu/parallel/nshard.py``).

The ('comp','out') mesh (``mesh.py``) splits the q component stack and the
p output axis, the wrong axes once one replica's Gram matrix no longer fits
one device.  This module shards the design-point axis n:

- each rank owns a block of Gram rows, so its working set is
  (q, n/ndev, n) and the memory of the stack divides by the ranks;
- a right-looking blocked Cholesky runs over the block rows: per panel step
  the owner's diagonal block is broadcast and the factored panel column
  all-gathered, and each rank applies its own trailing update;
- blocked forward/back substitution (one or many right-hand sides), the
  inverse's rows and the logdet come from the same distributed factor;
- :func:`neglpost_full_nsharded` / :func:`neglpost_rep_nsharded` are the
  training losses (the semantics of ``likelihood.neglpost_*``) without any
  rank forming a whole (n, n) Gram, the backward included: each is a
  ``torch.autograd.Function`` whose forward saves only the rank's factor
  rows and one solve vector, and whose backward rebuilds the rank's rows of
  the inverse, forms the cotangent rows and runs the kernel's Gram VJP in
  cross mode (K2, K3's or K4's), so the backward's working set is also
  O(q n/ndev n) a rank;
- :func:`compute_aux_nsharded` and :func:`predict_nsharded_core` are the
  predictive path on the distributed factor.

On a 2-D ('comp','n') mesh (:func:`make_nc_mesh`) the q components are
also split over 'comp' groups, each group running the algorithm above on
its components; the panel loop's length is the 'n' size only.  q not
divisible by the 'comp' size is padded with neutral components (copies of
the last) whose terms are dropped; n not divisible by the 'n' size is
padded with decoupled unit-diagonal rows.

Every rank holds the whole training data (each constructs the same
model), so where the reference all-gathers the points a rank simply reads
them.  Each per-rank body below is the counterpart of a ``shard_map`` body,
with the mesh's collectives written out.  Where the reference broadcasts
an owner's block as ``psum(is_mine * X)`` this is ``Mesh.broadcast``; the
real sums stay all-reduces.  Every function taking a mesh is a collective:
every rank of the mesh calls it with the same arguments.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
import torch.distributed as dist

from ..models import likelihood as lik
from ..models import params as Pm
from ..ops import linalg
from ..ops.gram import gram_stack, gram_vjp
from ..ops.matern import matern32_diag
from .group import Mesh, _need_group, resolve_device

AXIS = 'n'
COMP = 'comp'


def make_n_mesh(n_devices: Optional[int] = None, device=None) -> Mesh:
    """A 1-D ('n',) mesh over the first ``n_devices`` ranks (all of the
    world for None).  ``device`` None is this rank's card.  A collective:
    every rank of the world calls it."""
    _need_group('make_n_mesh')
    n = dist.get_world_size() if n_devices is None else int(n_devices)
    return Mesh((n,), (AXIS,), resolve_device(device))


def make_nc_mesh(n_comp: int, n_n: int, device=None) -> Mesh:
    """A 2-D ('comp','n') mesh: q components split over 'comp' groups,
    each running the n-sharded algorithm over its 'n' ranks.  'comp' is the
    outer axis, so each 'n' group is contiguous ranks.  A collective."""
    _need_group('make_nc_mesh')
    return Mesh((n_comp, n_n), (COMP, AXIS), resolve_device(device))


def is_n_mesh(mesh) -> bool:
    """True for the meshes this module runs on: ('n',) or ('comp','n')."""
    return tuple(mesh.axis_names) in ((AXIS,), (COMP, AXIS))


def data_shardings(mesh: Mesh, data):
    """This rank's index into each data tensor: its rows of xs and r and
    its columns of ys/ybar when n divides by the 'n' size; everything else,
    and every tensor when n does not divide (the losses pad), replicated."""
    n = data.xs.shape[0]
    every = slice(None)
    if n % _n_size(mesh):
        row = col = every
    else:
        row = _rows(mesh, n // _n_size(mesh))
        col = (every, row)
    if isinstance(data, lik.RepData):
        return lik.RepData(xs=row, ybar=col, scale=every, r=row, phi=every,
                           diag_D=every, sigma_map=every)
    return lik.FullData(xs=row, ys=col, phi=every, diag_D=every,
                        sigma_map=every)


def _n_size(mesh: Mesh) -> int:
    """Ranks along the n axis (the panel loop's length)."""
    return mesh.size(AXIS)


def _qax(mesh: Mesh):
    """The mesh axis the q components map to (None on an ('n',) mesh)."""
    return COMP if COMP in mesh.axis_names else None


def _q_pad(mesh: Mesh, q: int) -> int:
    """q padded up to a multiple of the 'comp' size."""
    nc = mesh.size(COMP)
    return -(-q // nc) * nc


def _pad_q(a, qp: int, fill: float = 0.0):
    """Axis 0 (the components) of ``a`` padded up to qp with ``fill``."""
    if a.shape[0] == qp:
        return a
    pad = a.new_full((qp - a.shape[0],) + tuple(a.shape[1:]), fill)
    return torch.cat([a, pad])


def _pad_q_params(mesh, lLmb, lLmb0, lnug):
    """The kernel parameters' q axis padded by repeating the last
    component: values that keep every padded factorization well posed."""
    qp = _q_pad(mesh, lLmb0.shape[0])
    extra = qp - lLmb0.shape[0]
    if not extra:
        return lLmb, lLmb0, lnug
    return tuple(torch.cat([t, t[-1:].expand((extra,) + tuple(t.shape[1:]))])
                 for t in (lLmb, lLmb0, lnug))


def _pad_to(x, total: int, axis: int, fill: float = 0.0):
    pad = total - x.shape[axis]
    if pad == 0:
        return x
    shape = list(x.shape)
    shape[axis] = pad
    return torch.cat([x, x.new_full(shape, fill)], dim=axis)


def _rows(mesh: Mesh, nb: int) -> slice:
    """This rank's block of rows."""
    j = mesh.index(AXIS)
    return slice(j * nb, (j + 1) * nb)


def _comps(mesh: Mesh, qp: int) -> slice:
    """This rank's components of the padded stack."""
    qc = qp // mesh.size(COMP)
    c = mesh.index(COMP)
    return slice(c * qc, (c + 1) * qc)


# ---------------------------------------------------------------------------
# Distributed factorization / substitution (the per-rank bodies).
# Layout: (q, nb, n) is this rank's block of rows of a (q, n, n) stack and
# (q, nb, m) its rows of (q, n, m) right-hand sides; nb * ndev == n (the
# callers pad).  A rank skips the steps its rows do not need and works in
# place; the losses' backward is hand-written, so no step is differentiated.
# ---------------------------------------------------------------------------

def _dist_cholesky_local(Ablk, mesh: Mesh):
    """This rank's rows of L, A = L L^T, from its (q, nb, n) rows of A.
    Ablk is overwritten by the factor."""
    q, nb, n = Ablk.shape
    ndev, idx = _n_size(mesh), mesh.index(AXIS)
    if nb * ndev != n:
        raise ValueError(f'{nb} rows x {ndev} ranks != n={n}')
    for k in range(ndev):
        cols = slice(k * nb, (k + 1) * nb)
        # the (updated) diagonal block, from its owner
        Lkk = linalg.cholesky(mesh.broadcast(Ablk[:, :, cols], AXIS, k))
        if idx == k:
            blk = Lkk
        elif idx > k:
            # my panel block L_ik = A_ik Lkk^{-T}
            blk = torch.linalg.solve_triangular(Lkk.mT, Ablk[:, :, cols],
                                                upper=True, left=False)
        else:
            blk = torch.zeros_like(Lkk)
        Ablk[:, :, cols] = blk
        if k + 1 < ndev:
            panel = mesh.all_gather(blk, AXIS)             # (ndev,q,nb,nb)
            if idx > k:
                below = panel[k + 1:].transpose(0, 1).reshape(
                    q, (ndev - 1 - k) * nb, nb)
                Ablk[:, :, (k + 1) * nb:] -= blk @ below.mT
    return Ablk


def _dist_solve_rows_local(Lblk, Bblk, mesh: Mesh, transpose: bool = False):
    """L Y = B (``transpose`` False) or L^T Y = B, with B's rows
    distributed: Bblk (q, nb, m) is this rank's; returns its rows of Y.

    Forward substitution: step k's owner solves its diagonal block against
    its rows of B less what the earlier steps sent, and broadcasts its rows
    of Y to the ranks below it.  Back substitution: each step all-reduces
    ``sum_{j>k} L_jk^T x_j`` (rank j holds L's block (j, k)) and its owner
    solves."""
    nb = Lblk.shape[1]
    ndev, idx = _n_size(mesh), mesh.index(AXIS)
    out = acc = None
    if not transpose:
        for k in range(ndev):
            cols = slice(k * nb, (k + 1) * nb)
            if idx == k:
                rhs = Bblk if acc is None else Bblk - acc
                out = torch.linalg.solve_triangular(Lblk[:, :, cols], rhs,
                                                    upper=False)
            if k + 1 < ndev:
                yk = mesh.broadcast(out if idx == k else Bblk, AXIS, k)
                if idx > k:
                    step = Lblk[:, :, cols] @ yk
                    acc = step if acc is None else acc.add_(step)
                del yk
        return out
    for k in reversed(range(ndev)):
        cols = slice(k * nb, (k + 1) * nb)
        contrib = (Lblk[:, :, cols].mT @ out if idx > k
                   else torch.zeros_like(Bblk))
        s = mesh.all_reduce(contrib, AXIS)
        del contrib
        if idx == k:
            out = torch.linalg.solve_triangular(Lblk[:, :, cols].mT,
                                                Bblk - s, upper=True)
    return out


def _dist_cho_solve_rows_local(Lblk, Bblk, mesh: Mesh):
    """(L L^T)^{-1} B with B's rows distributed; (q, nb, m) local."""
    y = _dist_solve_rows_local(Lblk, Bblk, mesh)
    return _dist_solve_rows_local(Lblk, y, mesh, transpose=True)


def _dist_cho_solve_vec_local(Lblk, bblk, mesh: Mesh):
    """(L L^T)^{-1} b with the distributed factor; b's rows (q, nb)."""
    return _dist_cho_solve_rows_local(Lblk, bblk[..., None], mesh)[..., 0]


def _eye_rows(idx: int, nb: int, n: int, dtype, device):
    """This rank's (nb, n) block of rows of the n x n identity."""
    eye = torch.zeros((nb, n), dtype=dtype, device=device)
    eye[:, idx * nb:(idx + 1) * nb].fill_diagonal_(1.0)
    return eye


def _dist_chol_inverse_rows_local(Lblk, mesh: Mesh):
    """This rank's (q, nb, n) rows of (L L^T)^{-1}: one distributed
    cho_solve against the identity, whose rows are distributed alike (the
    inverse is symmetric, so its rows are exact)."""
    q, nb, n = Lblk.shape
    eye = _eye_rows(mesh.index(AXIS), nb, n, Lblk.dtype, Lblk.device)
    # row-major: the solves can return column-major blocks on CUDA, and the
    # VJP kernels read the rows as one dense block
    return _dist_cho_solve_rows_local(Lblk, eye.expand(q, nb, n),
                                      mesh).contiguous()


def _dist_chol_logdet_local(Lblk, mesh: Mesh):
    """logdet(A) = 2 sum log diag(L); the diagonal lives in the owner
    rows.  The n-length log-sum accumulates in f64 even for f32 factors."""
    nb = Lblk.shape[1]
    idx = mesh.index(AXIS)
    d = torch.diagonal(Lblk[:, :, idx * nb:(idx + 1) * nb], dim1=-2,
                       dim2=-1)
    local = 2.0 * torch.sum(torch.log(d).to(torch.float64), dim=-1)
    return mesh.all_reduce(local, AXIS)


def _gather_rows(mesh: Mesh, blk, axis: str = AXIS):
    """All-gather a tensor sharded along its axis 1 (rows) or, with
    ``axis=COMP``, its axis 0 (components): the whole tensor."""
    g = mesh.all_gather(blk, axis)
    if axis == COMP:
        return g.reshape((-1,) + tuple(blk.shape[1:]))
    return g.transpose(0, 1).reshape(
        (blk.shape[0], -1) + tuple(blk.shape[2:]))


def _gather_full(mesh: Mesh, blk):
    """A (q_loc, nb, ...) block gathered over 'n' and 'comp'."""
    return _gather_rows(mesh, _gather_rows(mesh, blk), COMP)


# The public distributed primitives: the whole (q, n, n) stack in, this
# rank's rows of the result out (``dist_chol_logdet``: the logdet, alike on
# every rank).  n must divide by the 'n' size (the losses pad).

def _row_block(mesh, A):
    nb = A.shape[1] // _n_size(mesh)
    if nb * _n_size(mesh) != A.shape[1]:
        raise ValueError(f'n={A.shape[1]} must divide by the mesh\'s '
                         f'{_n_size(mesh)} ranks')
    return A[:, _rows(mesh, nb)]


def dist_cholesky(mesh: Mesh, A):
    """Distributed Cholesky of a (q, n, n) PSD stack: this rank's rows of
    L.  A collective."""
    return _dist_cholesky_local(_row_block(mesh, A).clone(), mesh)


def dist_cho_solve_vec(mesh: Mesh, L, b):
    """(L L^T)^{-1} b for L's rows from :func:`dist_cholesky`; b (q, n);
    returns this rank's rows (q, nb).  A collective."""
    return _dist_cho_solve_vec_local(L, _row_block(mesh, b[..., None])[..., 0],
                                     mesh)


def dist_cho_solve(mesh: Mesh, L, B):
    """(L L^T)^{-1} B for B (q, n, m); this rank's rows.  A collective."""
    return _dist_cho_solve_rows_local(L, _row_block(mesh, B), mesh)


def dist_chol_inverse(mesh: Mesh, L):
    """This rank's rows of (L L^T)^{-1}.  A collective."""
    return _dist_chol_inverse_rows_local(L, mesh)


def dist_chol_logdet(mesh: Mesh, L):
    """logdet(L L^T), alike on every rank.  A collective."""
    return _dist_chol_logdet_local(L, mesh)


def gather_rows(mesh: Mesh, blk):
    """The whole tensor from each rank's rows (axis 1).  A collective."""
    return _gather_rows(mesh, blk)


# ---------------------------------------------------------------------------
# Shared local helpers for the losses and aux
# ---------------------------------------------------------------------------

def _local_gram_rows(xs, mask, lLmb, lLmb0, lnug, *, mesh, kernel,
                     compute_dtype):
    """This rank's (q, nb, n) rows of the masked, nugget-included Gram
    stack: the kind's Gram kernel across (my rows, all points), then
    ``amp * eta`` on my rows' global diagonal, which reproduces the
    same-point stack ``amp ((1 - eta) C0 + eta I)``, then padded rows and
    columns zeroed.  The (1 - eta) shrink comes from the cross mode, so
    the diagonal may differ from the square kernel's in its last bit."""
    nb = xs.shape[0] // _n_size(mesh)
    rows = _rows(mesh, nb)
    C = gram_stack(xs[rows], xs, lLmb, lLmb0, lnug, same=False,
                   compute_dtype=compute_dtype, kind=kernel)   # (q, nb, n)
    eta = (lnug / (1.0 + lnug)).to(C.dtype)
    amp = lLmb0.to(C.dtype)
    mrow, mcol = mask[rows].to(C.dtype), mask.to(C.dtype)
    C[:, :, rows].diagonal(dim1=-2, dim2=-1).add_((amp * eta)[:, None])
    return C.mul_(mrow[None, :, None] * mcol[None, None, :])


def _add_diag_rows(M, vals, mesh):
    """M (q, nb, n) plus vals (q, nb) on my rows' global diagonal, in
    place."""
    rows = _rows(mesh, M.shape[1])
    M[:, :, rows].diagonal(dim1=-2, dim2=-1).add_(vals)
    return M


def _local_gram_grads(xs, mask, lLmb, lLmb0, lnug, Cbar, *, mesh, kernel):
    """(glens, gamp, gnug) for this rank's rows' Gram cotangent Cbar (the
    cotangent of the masked, nugget-included rows), all-reduced over 'n':
    the cross part through the kind's VJP kernel in cross mode (which runs
    in Cbar's dtype), the nugget diagonal through its closed form.
    Overwrites Cbar."""
    nb = Cbar.shape[1]
    rows = _rows(mesh, nb)
    dt = Cbar.dtype
    Cbar.mul_(mask[rows].to(dt)[None, :, None] * mask.to(dt)[None, None, :])
    x1, x2, ls, amp_, nug_ = (t.to(dt).contiguous() for t in
                              (xs[rows], xs, lLmb, lLmb0, lnug))
    glens, gamp, gnug = gram_vjp(x1, x2, ls, amp_, nug_, same=False,
                                 cbar=Cbar, kind=kernel)
    # the nugget diagonal: the forward added amp * eta on my global diagonal
    s = Cbar[:, :, rows].diagonal(dim1=-2, dim2=-1).sum(-1)     # (q,)
    eta = nug_ / (1.0 + nug_)
    gamp = gamp.to(dt) + eta * s
    gnug = gnug.to(dt) + amp_ * s / torch.square(1.0 + nug_)
    q, d = glens.shape
    red = mesh.all_reduce(torch.cat([glens.to(dt).reshape(-1), gamp, gnug]),
                          AXIS)
    return red[:q * d].reshape(q, d), red[q * d:q * d + q], red[q * d + q:]


# ---------------------------------------------------------------------------
# The n-sharded full-data loss
# ---------------------------------------------------------------------------

def _full_fwd_local(xs, mask, a, lLmb, lLmb0, lnug, D, *, mesh, jitter,
                    kernel, compute_dtype):
    """A rank's forward on its components: its Gram rows, the distributed
    factor and solve, the per-component terms.  Returns (terms (q,) f64,
    alike on the 'n' ranks; LB rows; w rows).  ``a`` (q, n) whole."""
    C = _local_gram_rows(xs, mask, lLmb, lLmb0, lnug, mesh=mesh,
                         kernel=kernel, compute_dtype=compute_dtype)
    nb = C.shape[1]
    rows = _rows(mesh, nb)
    Dm = D.to(C.dtype)
    B = C.mul_(Dm[:, None, None])
    # padded rows keep a unit diagonal
    diag_vals = (1.0 + jitter * mask[rows]).to(C.dtype)
    B = _add_diag_rows(B, diag_vals.expand(B.shape[0], nb), mesh)
    LB = _dist_cholesky_local(B, mesh)
    a_blk = a[:, rows].to(LB.dtype)
    w = _dist_cho_solve_vec_local(LB, a_blk, mesh)
    # C w = (a - (1+jitter) w) / D from B w = a, as the one-device loss
    Cw = (a_blk - (1.0 + jitter) * w) / Dm[:, None].to(LB.dtype)
    quad = mesh.all_reduce(torch.sum((a_blk * Cw).to(torch.float64), dim=-1),
                           AXIS)
    logdet = _dist_chol_logdet_local(LB, mesh)
    return 0.5 * logdet - 0.5 * quad, LB, w


def _full_bwd_local(xs, mask, a, lLmb, lLmb0, lnug, D, LB, w, *, mesh,
                    jitter, kernel):
    """The closed-form backward at a unit cotangent (as
    ``likelihood._full_terms_impl``'s): dt/dC = 0.5 D B^{-1} - 0.5 w w^T,
    dt/da = -C w, from the saved factor rows.  Returns the rank's
    (glens, gamp, gnug) for its components (reduced over 'n') and its rows
    of -C w."""
    nb = LB.shape[1]
    rows = _rows(mesh, nb)
    dt = LB.dtype
    Dm = D.to(dt)
    w_full = _gather_rows(mesh, w)                               # (q, n)
    Cbar = _dist_chol_inverse_rows_local(LB, mesh)
    Cbar.mul_((0.5 * Dm)[:, None, None])
    Cbar.baddbmm_(-0.5 * w[:, :, None], w_full[:, None, :])
    grads = _local_gram_grads(xs, mask, lLmb, lLmb0, lnug, Cbar, mesh=mesh,
                              kernel=kernel)
    del Cbar
    Cw = (a[:, rows].to(dt) - (1.0 + jitter) * w) / Dm[:, None]
    return grads, -Cw


def _whole_q(mesh, g):
    """A per-component piece gathered over 'comp' (the whole padded q)."""
    return _gather_rows(mesh, g, COMP) if _qax(mesh) else g


def _param_grads(mesh, grads, tb, params):
    """The kernel parameters' gradients, whole: this rank's components'
    (glens, gamp, gnug) at unit cotangent, scaled by the terms' cotangent
    tb and gathered over 'comp', in the parameters' dtypes."""
    glens, gamp, gnug = grads
    tb = tb.to(glens.dtype)
    return tuple(_whole_q(mesh, g).to(p.dtype) for g, p in
                 zip((glens * tb[:, None], gamp * tb, gnug * tb), params))


def _full_terms_fwd(mesh, jitter, kernel, compute_dtype, xs, mask, a, lLmb,
                    lLmb0, lnug, D):
    """(terms (qp,) whole, LB rows, w rows) from the whole padded inputs."""
    qs = _comps(mesh, lLmb0.shape[0])
    terms, LB, w = _full_fwd_local(
        xs, mask, a[qs], lLmb[qs], lLmb0[qs], lnug[qs], D[qs], mesh=mesh,
        jitter=jitter, kernel=kernel, compute_dtype=compute_dtype)
    return _whole_q(mesh, terms), LB, w


class _FullTermsNSharded(torch.autograd.Function):
    """The per-component terms (qp,) of the n-sharded full loss, alike on
    every rank, from the whole (padded) inputs.  The forward saves this
    rank's factor rows and w rows; the backward forms the gradients (the
    reference's custom VJP) and returns them whole on every rank."""

    @staticmethod
    def forward(ctx, mesh, jitter, kernel, compute_dtype, xs, mask, a,
                lLmb, lLmb0, lnug, D):
        terms, LB, w = _full_terms_fwd(mesh, jitter, kernel, compute_dtype,
                                       xs, mask, a, lLmb, lLmb0, lnug, D)
        ctx.mesh, ctx.jitter, ctx.kernel = mesh, jitter, kernel
        ctx.save_for_backward(xs, mask, a, lLmb, lLmb0, lnug, D, LB, w)
        return terms

    @staticmethod
    def backward(ctx, tbar):
        mesh = ctx.mesh
        xs, mask, a, lLmb, lLmb0, lnug, D, LB, w = ctx.saved_tensors
        qs = _comps(mesh, lLmb0.shape[0])
        tb = tbar[qs]
        grads, abar = _full_bwd_local(
            xs, mask, a[qs], lLmb[qs], lLmb0[qs], lnug[qs], D[qs], LB, w,
            mesh=mesh, jitter=ctx.jitter, kernel=ctx.kernel)
        glens, gamp, gnug = _param_grads(mesh, grads, tb,
                                         (lLmb, lLmb0, lnug))
        abar = _gather_full(mesh, tb[:, None].to(abar.dtype) * abar)
        return (None,) * 6 + (abar.to(a.dtype), glens, gamp, gnug, None)


def _n_pad(mesh, n: int) -> int:
    """n padded up to a multiple of the 'n' size."""
    return -(-n // _n_size(mesh)) * _n_size(mesh)


def _padded_inputs(xs, n_pad: int):
    """xs padded to n_pad rows (fill 0.5) and its row mask (1 on the real
    rows, 0 on the padding)."""
    return (_pad_to(xs, n_pad, axis=0, fill=0.5),
            _pad_to(xs.new_ones(xs.shape[0]), n_pad, axis=0))


def _full_inputs(free, data, mesh):
    """The padded inputs of the full terms and the (p,) log-variances and
    variances."""
    n_pad = _n_pad(mesh, data.xs.shape[0])
    qp = _q_pad(mesh, data.phi.shape[1])
    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma = torch.exp(lsig)
    psi_c = data.phi / torch.sqrt(sigma)[:, None]            # (p, q)
    a = (data.ys.T @ psi_c).T                                # (q, n)
    xs, mask = _padded_inputs(data.xs, n_pad)
    a = _pad_q(_pad_to(a, n_pad, axis=1), qp)
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    D = _pad_q(data.diag_D, qp, fill=1.0)   # D = 1 keeps padded B = C + I PD
    return (xs, mask, a, lLmb, lLmb0, lnug, D), lsig, sigma


def neglpost_full_nsharded(free: Pm.FreeParams, data: lik.FullData,
                           mesh: Mesh, compute_dtype=None,
                           jitter: float = 0.0, kernel: str = 'matern32'):
    """The full-data loss with the n axis sharded over the mesh: the value
    of ``likelihood.neglpost_full`` (not divided by n), alike on every rank.
    n is padded to a multiple of the 'n' size with loss-neutral rows (C
    zeroed, unit diagonal, zero data weight); on a ('comp','n') mesh q is
    padded to a multiple of the 'comp' size.  A collective."""
    q = data.phi.shape[1]
    n = data.xs.shape[0]
    inputs, lsig, sigma = _full_inputs(free, data, mesh)
    if torch.is_grad_enabled():
        terms = _FullTermsNSharded.apply(mesh, jitter, kernel, compute_dtype,
                                         *inputs)
    else:
        terms = _full_terms_fwd(mesh, jitter, kernel, compute_dtype,
                                *inputs)[0]
    nlp = torch.sum(terms[:q]).to(data.ys.dtype)
    nlp = nlp + 0.5 * n * torch.sum(lsig)
    return nlp + 0.5 * torch.sum(torch.square(data.ys
                                              / torch.sqrt(sigma)[:, None]))


# ---------------------------------------------------------------------------
# The n-sharded replication loss
# ---------------------------------------------------------------------------

def _rep_fwd_local(xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug, *, mesh,
                   kernel, compute_dtype):
    """Rep-path forward on the rank's components: its rows of
    A = C + diag(lam + jit), the distributed factor and solve, the terms.
    Returns (terms, LT rows, u rows, Cu rows)."""
    C = _local_gram_rows(xs, mask, lLmb, lLmb0, lnug, mesh=mesh,
                         kernel=kernel, compute_dtype=compute_dtype)
    nb = C.shape[1]
    rows = _rows(mesh, nb)
    mrow = mask[rows]
    # padded rows get a clean unit diagonal (zero logdet and quad)
    diag_vals = torch.where(mrow[None, :] > 0,
                            lam[:, rows].to(C.dtype) + jit_q.to(C.dtype),
                            torch.ones((), dtype=C.dtype, device=C.device))
    A = _add_diag_rows(C, diag_vals, mesh)
    LT = _dist_cholesky_local(A, mesh)
    b_blk = b[:, rows].to(LT.dtype)
    lb = lam[:, rows].to(LT.dtype) * b_blk
    u = _dist_cho_solve_vec_local(LT, lb, mesh)
    Cu = lb - diag_vals.to(LT.dtype) * u                       # (S b) rows
    quad = mesh.all_reduce(torch.sum((b_blk * Cu).to(torch.float64), dim=-1),
                           AXIS)
    logdet = _dist_chol_logdet_local(LT, mesh)
    return -0.5 * quad + 0.5 * logdet, LT, u, Cu


def _rep_terms_fwd(mesh, kernel, compute_dtype, xs, mask, lam, jit_q, b,
                   lLmb, lLmb0, lnug):
    """(terms (qp,) whole, LT rows, u rows, Cu rows)."""
    qs = _comps(mesh, lLmb0.shape[0])
    terms, LT, u, Cu = _rep_fwd_local(
        xs, mask, lam[qs], jit_q[qs], b[qs], lLmb[qs], lLmb0[qs], lnug[qs],
        mesh=mesh, kernel=kernel, compute_dtype=compute_dtype)
    return _whole_q(mesh, terms), LT, u, Cu


class _RepTermsNSharded(torch.autograd.Function):
    """The per-component terms of the n-sharded rep loss; as
    :class:`_FullTermsNSharded`, with dt/dC = 0.5 A^{-1} - 0.5 u u^T and
    dt/db = -C u.  lam and the jitter carry no gradient, as in the
    reference's custom VJP."""

    @staticmethod
    def forward(ctx, mesh, kernel, compute_dtype, xs, mask, lam, jit_q, b,
                lLmb, lLmb0, lnug):
        terms, LT, u, Cu = _rep_terms_fwd(mesh, kernel, compute_dtype, xs,
                                          mask, lam, jit_q, b, lLmb, lLmb0,
                                          lnug)
        ctx.mesh, ctx.kernel = mesh, kernel
        ctx.save_for_backward(xs, mask, b, lLmb, lLmb0, lnug, LT, u, Cu)
        return terms

    @staticmethod
    def backward(ctx, tbar):
        mesh = ctx.mesh
        xs, mask, b, lLmb, lLmb0, lnug, LT, u, Cu = ctx.saved_tensors
        qs = _comps(mesh, lLmb0.shape[0])
        tb = tbar[qs]
        u_full = _gather_rows(mesh, u)
        Cbar = _dist_chol_inverse_rows_local(LT, mesh)
        Cbar.mul_(0.5)
        Cbar.baddbmm_(-0.5 * u[:, :, None], u_full[:, None, :])
        grads = _local_gram_grads(xs, mask, lLmb[qs], lLmb0[qs], lnug[qs],
                                  Cbar, mesh=mesh, kernel=ctx.kernel)
        del Cbar
        glens, gamp, gnug = _param_grads(mesh, grads, tb,
                                         (lLmb, lLmb0, lnug))
        bbar = _gather_full(mesh, -tb[:, None].to(Cu.dtype) * Cu)
        return (None,) * 7 + (bbar.to(b.dtype), glens, gamp, gnug)


def _rep_inputs(free, data, mesh, jitter):
    """The padded inputs of the rep terms and the diagonal data terms."""
    n = data.xs.shape[0]
    p = data.ybar.shape[0]
    n_pad = _n_pad(mesh, n)
    lLmb, lLmb0, lsig_g, lnug = Pm.constrain(free)
    lsig = Pm.expand_sigma(lsig_g, data.sigma_map)
    sigma_raw = torch.exp(lsig)
    r = data.r
    sigma_var_used = sigma_raw / torch.square(data.scale)
    sigma_inv_sqrt = data.scale / torch.sqrt(sigma_raw)
    # the diagonal data terms: plain n-sums, no sharding needed
    nlp = 0.5 * torch.sum(r * torch.sum(
        torch.square(data.ybar * sigma_inv_sqrt[:, None]), dim=0))
    nlp = nlp + 0.5 * n * torch.sum(torch.log(sigma_var_used))
    nlp = nlp - 0.5 * p * torch.sum(torch.log(r))
    v = data.phi * sigma_inv_sqrt[:, None]
    b = r[None, :] * (data.ybar.T @ v).T                       # (q, n)
    D = data.diag_D
    lam = 1.0 / (D[:, None] * r[None, :])                      # (q, n)
    nlp = nlp + 0.5 * torch.sum(torch.log(D[:, None] * r[None, :]))
    # the amplitude-scaled jitter of likelihood._rep_terms_impl
    jit_q = jitter * (1.0 + lLmb0[:, None])                    # (q, 1)
    xs, mask = _padded_inputs(data.xs, n_pad)
    qp = _q_pad(mesh, data.phi.shape[1])
    b = _pad_q(_pad_to(b, n_pad, axis=1), qp)
    # padded components and rows: lam 1, so A = C + I stays well posed
    lam = _pad_q(_pad_to(lam, n_pad, axis=1, fill=1.0), qp, fill=1.0)
    jit_q = _pad_q(jit_q, qp)
    lLmb, lLmb0, lnug = _pad_q_params(mesh, lLmb, lLmb0, lnug)
    return (xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug), nlp


def neglpost_rep_nsharded(free: Pm.FreeParams, data: lik.RepData,
                          mesh: Mesh, compute_dtype=None,
                          jitter: float = 0.0, kernel: str = 'matern32'):
    """The replication loss with the unique sites sharded over the mesh:
    the value of ``likelihood.neglpost_rep`` (divided by n), alike on every
    rank.  A collective."""
    n = data.xs.shape[0]
    q = data.phi.shape[1]
    inputs, nlp = _rep_inputs(free, data, mesh, jitter)
    if torch.is_grad_enabled():
        terms = _RepTermsNSharded.apply(mesh, kernel, compute_dtype, *inputs)
    else:
        terms = _rep_terms_fwd(mesh, kernel, compute_dtype, *inputs)[0]
    nlp = nlp + torch.sum(terms[:q]).to(nlp.dtype)
    return nlp / n


def make_loss(submethod: str, data, mesh: Mesh, compute_dtype=None,
              jitter: float = 0.0, kernel: str = 'matern32'):
    """``loss(free)`` on the mesh (``likelihood.make_loss``'s contract,
    n-sharded).  A collective."""
    loss_fn = (neglpost_rep_nsharded if submethod == 'rep'
               else neglpost_full_nsharded)

    def loss(free):
        return loss_fn(free, data, mesh, compute_dtype=compute_dtype,
                       jitter=jitter, kernel=kernel)
    return loss


def make_nsharded_value_and_grad(mesh: Mesh, data, compute_dtype=None,
                                 jitter: float = 0.0,
                                 kernel: str = 'matern32'):
    """``vg(free) -> (loss, grads)`` of the n-sharded loss (full or rep
    data), replicated on every rank.  A collective."""
    sub = 'rep' if isinstance(data, lik.RepData) else 'full'
    loss = make_loss(sub, data, mesh, compute_dtype=compute_dtype,
                     jitter=jitter, kernel=kernel)

    def vg(free):
        leaves = Pm.FreeParams(*(t.detach().clone().requires_grad_(True)
                                 for t in free))
        v = loss(leaves)
        return v.detach(), Pm.FreeParams(*torch.autograd.grad(v, leaves))
    return vg


# ---------------------------------------------------------------------------
# The n-sharded predictive path
# ---------------------------------------------------------------------------

class NShardAux(NamedTuple):
    """The distributed predictive state: this rank's rows of the dual
    weights ``u`` (CinvM) and of the factor ``L``, for its components."""
    u: torch.Tensor      # (qp / n_comp, n_pad / n_n)
    L: torch.Tensor      # (qp / n_comp, n_pad / n_n, n_pad)
    kind: str = 'full'   # 'full' (L = chol(D C + (1+jit) I)) or
    #                      'rep'  (L = chol(C + diag(lam + jit)))


def gather_u(mesh: Mesh, aux: NShardAux):
    """The dual weights (qp, n_pad), whole on every rank.  A collective."""
    return _gather_full(mesh, aux.u)


def gather_factor(mesh: Mesh, aux: NShardAux):
    """The factor (qp, n_pad, n_pad), whole on every rank.  A
    collective."""
    return _gather_full(mesh, aux.L)


def compute_aux_nsharded(free: Pm.FreeParams, data, mesh: Mesh,
                         compute_dtype=None, jitter: float = 0.0,
                         kernel: str = 'matern32') -> NShardAux:
    """The distributed predictive aux.  Full path: the loss's factor of
    B = D C + (1+jitter) I and u = B^{-1} a, the CinvM of
    ``predict.compute_aux_full``; rep path: u = (C + Lam)^{-1} Lam b
    (``predict.compute_aux_rep``).  A collective."""
    with torch.no_grad():
        if isinstance(data, lik.RepData):
            (xs, mask, lam, jit_q, b, lLmb, lLmb0, lnug), _ = _rep_inputs(
                free, data, mesh, jitter)
            qs = _comps(mesh, lLmb0.shape[0])
            _, L, u, _ = _rep_fwd_local(
                xs, mask, lam[qs], jit_q[qs], b[qs], lLmb[qs], lLmb0[qs],
                lnug[qs], mesh=mesh, kernel=kernel,
                compute_dtype=compute_dtype)
            return NShardAux(u=u, L=L, kind='rep')
        (xs, mask, a, lLmb, lLmb0, lnug, D), _, _ = _full_inputs(free, data,
                                                                mesh)
        qs = _comps(mesh, lLmb0.shape[0])
        _, L, u = _full_fwd_local(
            xs, mask, a[qs], lLmb[qs], lLmb0[qs], lnug[qs], D[qs],
            mesh=mesh, jitter=jitter, kernel=kernel,
            compute_dtype=compute_dtype)
        return NShardAux(u=u, L=L, kind='full')


def predict_nsharded_core(free: Pm.FreeParams, data, aux: NShardAux, x0s,
                          mesh: Mesh, compute_dtype=None,
                          jitter: float = 0.0, kernel: str = 'matern32'):
    """(ghat, gvar) (q, n0) at standardized x0s, alike on every rank, as
    ``predict.predict_full_core`` / ``predict_rep_core`` give them:

        full: gvar = c00 - D sum(M^2),  M = LB^{-1} c0^T
        rep:  gvar = c00 - sum(M^2),    M = LT^{-1} c0^T

    A rank forms its columns of the (q, n0, n) cross-covariance (the kind's
    Gram kernel across (x0s, my rows)), all-reduces ``c0 u`` over 'n', and
    reduces the variance through the distributed forward substitution.
    A collective."""
    n_pad = aux.L.shape[-1]
    q = data.diag_D.shape[0]
    with torch.no_grad():
        lLmb, lLmb0, _, lnug = Pm.constrain(free)
        lLmb_p, lLmb0_p, lnug_p = _pad_q_params(mesh, lLmb, lLmb0, lnug)
        qs = _comps(mesh, lLmb0_p.shape[0])
        xs, mask = _padded_inputs(data.xs, n_pad)
        rows = _rows(mesh, aux.L.shape[1])
        c0 = gram_stack(x0s, xs[rows], lLmb_p[qs], lLmb0_p[qs], lnug_p[qs],
                        same=False, compute_dtype=compute_dtype,
                        kind=kernel)                        # (q_r, n0, nb)
        c0 = c0 * mask[rows].to(c0.dtype)[None, None, :]
        ghat = mesh.all_reduce(lik._bmv(c0, aux.u.to(c0.dtype)), AXIS)
        M = _dist_solve_rows_local(aux.L, c0.mT.to(aux.L.dtype), mesh)
        ssq = mesh.all_reduce(torch.sum(torch.square(M), dim=1), AXIS)
        ghat, ssq = _whole_q(mesh, ghat)[:q], _whole_q(mesh, ssq)[:q]
        c00 = matern32_diag(x0s, lLmb0).to(ssq.dtype)
        if aux.kind == 'full':
            return ghat, c00 - data.diag_D[:, None].to(ssq.dtype) * ssq
        return ghat, c00 - ssq
