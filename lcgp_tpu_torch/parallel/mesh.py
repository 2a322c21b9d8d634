"""The ('comp', 'out') mesh (counterpart of ``lcgp_tpu/parallel/mesh.py``).

The reference's only intra-model concurrency is over the q independent
latent components.  On a 2-D mesh:

- axis ``'comp'`` splits the q component stack: each rank factors its own
  slice of the (q, n, n) Gram/Cholesky stack;
- axis ``'out'`` splits the p output axis of Y/phi: the p-contractions
  (``Y^T (phi / sqrt(sigma))`` and the diagonal data terms) become
  all-reduces over 'out'.

Where GSPMD inserts the psums implicitly, here they are explicit: a rank
forms ``a = (Y_p^T psi_{c,p})^T`` for its p rows and q components and
all-reduces it over 'out', runs the single-device component terms
(``likelihood._full_terms`` / ``_rep_terms``) on its q slice, sums them
over 'comp', and sums its noise terms over 'out' only.  Each term enters
the total once.  The collectives are differentiable
(:meth:`~lcgp_tpu_torch.parallel.group.Mesh.all_reduce` with ``grad=True``)
and the parameters enter through ``Mesh.enter`` and the total leaves
through ``Mesh.leave``, so autograd gives every rank the one gradient,
bit for bit alike (it ends in all-reduces).  The single-device drivers
(``fit/scipy_lbfgs.py``, ``fit/lbfgs.py``, ``fit/adam.py``) therefore run
unchanged and in lockstep on every rank.

Every function here is a collective: every rank of the mesh calls it with
the same arguments (the full, replicated parameters and data).
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

from ..fit import minimize_adam
from ..fit.adam import DeviceFitResult, PlateauTracker
from ..models import likelihood as lik
from ..models import params as Pm
from .group import Mesh, _need_group, resolve_device

COMP, OUT = 'comp', 'out'


def make_mesh(n_comp: Optional[int] = None, n_out: int = 1,
              device=None) -> Mesh:
    """A ('comp', 'out') mesh over the first ``n_comp * n_out`` ranks.
    ``n_comp`` None takes every rank the world has for ``n_out``;
    ``device`` None is this rank's card.  A collective: every rank of the
    world calls it."""
    _need_group('make_mesh')
    world = dist.get_world_size()
    if n_comp is None:
        n_comp = max(1, world // n_out)
    return Mesh((n_comp, n_out), (COMP, OUT), resolve_device(device))


def _chunk(size: int, parts: int, i: int) -> slice:
    """Part i of ``range(size)`` cut in ``parts`` contiguous pieces, the
    first ``size % parts`` one longer (``torch.tensor_split``'s cut)."""
    base, extra = divmod(size, parts)
    start = i * base + min(i, extra)
    return slice(start, start + base + (i < extra))


def param_shardings(mesh: Mesh, q: int) -> Pm.FreeParams:
    """This rank's index into each parameter: the q-stacked ones take its
    'comp' slice; the grouped error variances are replicated."""
    qs = _chunk(q, mesh.size(COMP), mesh.index(COMP))
    return Pm.FreeParams(lLmb=qs, lLmb0=qs, lsigma2s=slice(None),
                         lnugGPs=qs)


def data_shardings(mesh: Mesh, data):
    """This rank's index into each data tensor: Y/ybar, phi's rows, scale
    and sigma_map take its 'out' slice of p, phi's columns and diag_D its
    'comp' slice of q; inputs and replicate counts are replicated."""
    p, q = data.phi.shape
    ps = _chunk(p, mesh.size(OUT), mesh.index(OUT))
    qs = _chunk(q, mesh.size(COMP), mesh.index(COMP))
    every = slice(None)
    if isinstance(data, lik.RepData):
        return lik.RepData(xs=every, ybar=ps, scale=ps, r=every,
                           phi=(ps, qs), diag_D=qs, sigma_map=ps)
    return lik.FullData(xs=every, ys=ps, phi=(ps, qs), diag_D=qs,
                        sigma_map=ps)


def place(tree, shardings):
    """Each tensor of ``tree`` (a NamedTuple or tuple) cut to this rank's
    shard."""
    cut = [t[s] for t, s in zip(tree, shardings)]
    return type(tree)(*cut) if hasattr(tree, '_fields') else tuple(cut)


def _sharded_full(free, data, mesh, compute_dtype, jitter, kernel):
    lLmb, lLmb0, lsig_g, lnug = place(Pm.constrain(free),
                                      param_shardings(mesh, data.phi.shape[1]))
    d = place(data, data_shardings(mesh, data))
    lsig = Pm.expand_sigma(lsig_g, d.sigma_map)               # (p_r,)
    sigma = torch.exp(lsig)
    n = d.xs.shape[0]
    psi_c = d.phi / torch.sqrt(sigma)[:, None]                # (p_r, q_r)
    a = mesh.all_reduce((d.ys.T @ psi_c).T, OUT, grad=True)   # (q_r, n)
    # a rank with no component still joins the sum, with its (0,) terms in
    # the autograd graph, so it also joins the sum's backward
    terms = (lik._full_terms(compute_dtype, jitter, kernel, d.xs, lLmb,
                             lLmb0, lnug, d.diag_D, a)
             if a.shape[0] else a.sum(-1).to(torch.float64))
    nlp = mesh.all_reduce(torch.sum(terms), COMP, grad=True).to(d.ys.dtype)
    noise = 0.5 * n * torch.sum(lsig) + 0.5 * torch.sum(
        torch.square(d.ys / torch.sqrt(sigma)[:, None]))
    return nlp + mesh.all_reduce(noise, OUT, grad=True)


def _sharded_rep(free, data, mesh, compute_dtype, jitter, kernel):
    lLmb, lLmb0, lsig_g, lnug = place(Pm.constrain(free),
                                      param_shardings(mesh, data.phi.shape[1]))
    d = place(data, data_shardings(mesh, data))
    lsig = Pm.expand_sigma(lsig_g, d.sigma_map)               # (p_r,)
    sigma_raw = torch.exp(lsig)
    n = d.xs.shape[0]
    p = data.ybar.shape[0]
    r = d.r
    sigma_var_used = sigma_raw / torch.square(d.scale)
    sigma_inv_sqrt = d.scale / torch.sqrt(sigma_raw)
    # the diagonal data terms of this rank's outputs, summed over 'out'
    noise = (0.5 * torch.sum(r * torch.sum(
        torch.square(d.ybar * sigma_inv_sqrt[:, None]), dim=0))
        + 0.5 * n * torch.sum(torch.log(sigma_var_used)))
    nlp = mesh.all_reduce(noise, OUT, grad=True) \
        - 0.5 * p * torch.sum(torch.log(r))
    v = d.phi * sigma_inv_sqrt[:, None]                       # (p_r, q_r)
    b = mesh.all_reduce(r[None, :] * (d.ybar.T @ v).T, OUT, grad=True)
    terms = (lik._rep_terms(compute_dtype, jitter, kernel, d.xs,
                            torch.sqrt(r), lLmb, lLmb0, lnug, d.diag_D, b)
             if b.shape[0] else b.sum(-1).to(torch.float64))
    nlp = nlp + mesh.all_reduce(torch.sum(terms), COMP,
                                grad=True).to(nlp.dtype)
    return nlp / n


def make_sharded_loss(mesh: Mesh, data, compute_dtype=None,
                      jitter: float = 0.0, kernel: str = 'matern32'):
    """``loss(free)`` over the ('comp','out') mesh, for every optimizer
    driver in ``fit/``: the value and (by autograd) the gradient are the
    single-device ones, identical on every rank.  A collective."""
    body = _sharded_rep if isinstance(data, lik.RepData) else _sharded_full

    def loss(free):
        free = Pm.FreeParams(*mesh.enter(*free))
        return mesh.leave(body(free, data, mesh, compute_dtype, jitter,
                               kernel))
    return loss


def make_sharded_value_and_grad(mesh: Mesh, data):
    """``vg(free, data) -> (loss, grads)`` over the mesh: the loss and the
    FreeParams of its gradient, replicated on every rank.  A collective."""
    def vg(free, data):
        leaves = Pm.FreeParams(*(t.detach().clone().requires_grad_(True)
                                 for t in free))
        v = make_sharded_loss(mesh, data)(leaves)
        grads = torch.autograd.grad(v, leaves)
        return v.detach(), Pm.FreeParams(*grads)
    return vg


class _Plateau(Exception):
    def __init__(self, step, loss, params):
        super().__init__('plateau')
        self.step, self.loss, self.params = step, loss, params


def fit_sharded(data, free0: Pm.FreeParams, mesh: Mesh, *, steps: int = 200,
                learning_rate: float = 5e-2, block_steps: int = 50,
                verbose: bool = False, callback=None,
                plateau_rtol: float = None, plateau_patience: int = 3,
                compute_dtype=None, jitter: float = 0.0,
                kernel: str = 'matern32'):
    """Adam over the mesh: ``fit/adam.py``'s loop on the sharded loss, in
    lockstep on every rank.  Returns (free_params, DeviceFitResult).

    ``callback(step, loss, params)`` fires at every block boundary
    (``block_steps``), and the opt-in ``plateau_rtol`` stops once the best
    loss so far has failed to improve by that relative tolerance for
    ``plateau_patience`` consecutive blocks; the result records fun, nit
    and stop_reason.  A collective."""
    plateau = PlateauTracker(plateau_rtol, patience=plateau_patience)

    def at_block(step, loss, params):
        if verbose:
            print(f'[lcgp_tpu_torch.fit sharded-adam] step {step:4d}  '
                  f'loss {loss:.8g}')
        if callback is not None:
            callback(step, loss, params)
        if plateau.update(loss):
            raise _Plateau(step, loss, params)

    loss = make_sharded_loss(mesh, data, compute_dtype=compute_dtype,
                             jitter=jitter, kernel=kernel)
    try:
        res = minimize_adam(loss, free0, steps=steps,
                            learning_rate=learning_rate,
                            block_steps=block_steps, callback=at_block)
    except _Plateau as stop:
        res = DeviceFitResult(params=stop.params, fun=stop.loss,
                              nit=stop.step, stop_reason='plateau',
                              nfev=stop.step)
    return res.params, res
