"""A small run of every mesh mode on ``n`` local ranks, each checked against
one device (counterpart of ``__graft_entry__.py``'s ``dryrun_multichip``).

    python -m lcgp_tpu_torch.parallel.dryrun 4          # on the card
    python -m lcgp_tpu_torch.parallel.dryrun 4 --cpu    # on the CPU

spawns a gloo group of ``n`` ranks that share one device
(:class:`~.group.WorkerGroup`: this process's card, or the CPU when asked)
and runs on every rank:

- the ('comp','out') mesh: one ``fit_sharded`` Adam step, two iterations of
  the on-device L-BFGS over ``make_sharded_loss``, and a rep-path value and
  gradient, each against the single-device loss and gradient;
- the ('n',) mesh of every rank: the n-sharded loss and gradient, then
  ``LCGP.fit(mesh=...)`` (Adam) and ``predict`` against the single-device
  predict at the fitted parameters;
- n-sharded FITC on that mesh (``fitc_shard.py``): an inducing-point
  model's 4-step Adam ``fit(mesh=...)`` and ``predict`` against the
  single-device FITC model at the fitted parameters and z;
- with 4 or more ranks (an even count), the ('comp','n') mesh (2, n/2):
  its loss and gradient with q=3 (the component padding) and a fit and
  predict through the API, then the n-sharded FITC loss and gradient there
  with q=3.

Any disagreement raises.  The summary lists the modes run.
"""
from __future__ import annotations

import argparse

import numpy as np
import torch

from ..models import basis as basis_mod
from ..models import likelihood as lik
from ..models import params as Pm
from ..models import sparse
from .group import WorkerGroup


def _full_problem(n=64, d=2, p=8, q=4, seed=0, device='cpu'):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, d))
    ys = rng.standard_normal((p, n))
    ys = (ys - ys.mean(1, keepdims=True)) / ys.std(1, keepdims=True)
    b = basis_mod.init_phi(ys, q=q)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    data = lik.FullData(xs=t(xs), ys=t(ys), phi=t(b.phi), diag_D=t(b.diag_D),
                        sigma_map=Pm.sigma_index_map([1] * p, device))
    return data, Pm.init_values(xs, ys, b.q, [1] * p, device)


def _value_and_grad(loss, free):
    leaves = Pm.FreeParams(*(t.detach().clone().requires_grad_(True)
                             for t in free))
    v = loss(leaves)
    return float(v.detach()), torch.autograd.grad(v, leaves)


def _check(what, got, ref, rtol=1e-8, atol=1e-10):
    got, ref = (np.asarray(torch.as_tensor(a).detach().cpu(), dtype=float)
                for a in (got, ref))
    if not np.allclose(got, ref, rtol=rtol, atol=atol):
        raise RuntimeError(f'{what}: {got} != single-device {ref}')


def _check_vg(what, mesh_vg, ref_vg):
    _check(f'{what} loss', mesh_vg[0], ref_vg[0])
    for g, r in zip(mesh_vg[1], ref_vg[1]):
        _check(f'{what} gradient', g, r, rtol=1e-7, atol=1e-9)


def _predict_parity(what, model, x, y, x0, device, **ctor):
    from ..models.lcgp import LCGP
    got = model.predict(x0)[0]
    single = LCGP(y=y, x=x, q=model.q, device=device, **ctor)
    single.free = model.free
    if model._z is not None:
        single._z = model._z.clone()
    _check(what, got, single.predict(x0)[0])


def _dryrun_body(n_devices: int, device: str) -> dict:
    from ..fit import minimize_lbfgs_jax
    from ..models.lcgp import LCGP
    from . import mesh as mesh_mod
    from . import nshard

    n_out = 2 if n_devices % 2 == 0 else 1
    n_comp = n_devices // n_out
    mesh = mesh_mod.make_mesh(n_comp=n_comp, n_out=n_out, device=device)
    q = n_comp * 2
    p = max(n_out * 4, q)
    data, free = _full_problem(n=32, p=p, q=q, device=device)

    # one sharded Adam step and two L-BFGS iterations through the
    # single-device driver over the sharded loss
    _, res = mesh_mod.fit_sharded(data, free, mesh, steps=1,
                                  learning_rate=1e-2)
    if not np.isfinite(res.fun):
        raise RuntimeError('sharded Adam produced a non-finite loss')
    sl = mesh_mod.make_sharded_loss(mesh, data)
    res_lb = minimize_lbfgs_jax(sl, free, maxiter=2)
    if not np.isfinite(float(res_lb.fun)):
        raise RuntimeError('sharded L-BFGS produced a non-finite loss')
    _check_vg("('comp','out') full", _value_and_grad(sl, free),
              _value_and_grad(lambda f: lik.neglpost_full(f, data), free))

    # the rep path's value and gradient on the same mesh
    rng = np.random.default_rng(2)
    n = 16
    ybar = rng.standard_normal((p, n))
    b = basis_mod.init_phi(ybar, q=q)

    def t(a):
        return torch.as_tensor(a, dtype=torch.float64, device=device)
    rep = lik.RepData(xs=t(rng.uniform(0, 1, (n, 2))), ybar=t(ybar),
                      scale=t(np.ones(p)),
                      r=t(rng.integers(1, 4, n).astype(np.float64)),
                      phi=t(b.phi), diag_D=t(b.diag_D),
                      sigma_map=Pm.sigma_index_map([1] * p, device))
    free_rep = Pm.init_values(rep.xs.cpu().numpy(), ybar, q, [1] * p, device)
    v, g = mesh_mod.make_sharded_value_and_grad(mesh, rep)(free_rep, rep)
    _check_vg("('comp','out') rep", (float(v), g),
              _value_and_grad(lambda f: lik.neglpost_rep(f, rep), free_rep))

    # the ('n',) mesh: the distributed-Cholesky loss and gradient, then the
    # API's fit and predict
    nmesh = nshard.make_n_mesh(n_devices, device=device)
    data_n, free_n = _full_problem(n=40, p=8, q=4, seed=3, device=device)
    v_n, g_n = nshard.make_nsharded_value_and_grad(nmesh, data_n)(free_n)
    _check_vg("('n',) full", (float(v_n), g_n),
              _value_and_grad(lambda f: lik.neglpost_full(f, data_n),
                              free_n))
    rng = np.random.default_rng(7)
    n, d, p = 36, 2, 6
    x = rng.uniform(0, 1, (n, d))
    y = rng.standard_normal((p, n))
    x0 = rng.uniform(0, 1, (5, d))
    model = LCGP(y=y, x=x, q=3, device=device)
    model.fit(mesh=nmesh, method='adam', steps=8, learning_rate=1e-2)
    _predict_parity("('n',) LCGP predict", model, x, y, x0, device)
    done = ['comp_out', 'n']

    # n-sharded FITC on the same mesh: a train step and predict on an
    # inducing-point model, the (q, n, m) panel's rows distributed
    model_f = LCGP(y=y, x=x, q=3, inducing=8, device=device)
    model_f.fit(mesh=nmesh, method='adam', steps=4, learning_rate=1e-2)
    _predict_parity("('n',) FITC predict", model_f, x, y, x0, device,
                    inducing=8)
    done.append('fitc_n')

    # the ('comp','n') mesh, q=3 not divisible by 'comp' = 2
    if n_devices % 2 == 0 and n_devices >= 4:
        ncmesh = nshard.make_nc_mesh(2, n_devices // 2, device=device)
        data_c, free_c = _full_problem(n=40, p=8, q=3, seed=5, device=device)
        v_c, g_c = nshard.make_nsharded_value_and_grad(ncmesh,
                                                       data_c)(free_c)
        _check_vg("('comp','n') full", (float(v_c), g_c),
                  _value_and_grad(lambda f: lik.neglpost_full(f, data_c),
                                  free_c))
        model_c = LCGP(y=y, x=x, q=3, device=device)
        model_c.fit(mesh=ncmesh, method='adam', steps=2, learning_rate=1e-2)
        _predict_parity("('comp','n') LCGP predict", model_c, x, y, x0,
                        device)
        done.append('comp_n')
        # FITC on the 2-D mesh: the loss and its gradient, q=3
        from . import fitc_shard
        z_c = torch.as_tensor(np.random.default_rng(6).uniform(0, 1, (8, 2)),
                              dtype=torch.float64, device=device)
        _check_vg("('comp','n') FITC", _value_and_grad(
            fitc_shard.make_loss('full', data_c, z_c, ncmesh), free_c),
            _value_and_grad(lambda f: sparse.neglpost_full_fitc(
                f, data_c, z_c), free_c))
        done.append('fitc_comp_n')
    return dict(modes=done)


def dryrun_multichip(n_devices: int, device=None) -> dict:
    """Run the mesh modes on ``n_devices`` gloo ranks that share ``device``
    (None: this process's card; raises without CUDA, pass ``device='cpu'``
    for the CPU), each against one device; raises on any disagreement.
    Returns rank 0's summary."""
    # the ranks import the body from the package, also under ``-m``
    from .dryrun import _dryrun_body as body
    with WorkerGroup(n_devices, device=device, backend='gloo') as group:
        if group.device.type == 'cuda':
            from ..ops._build import build
            build()     # once here, so that no rank builds the kernels
        return group.run(body, n_devices, str(group.device))[0]


if __name__ == '__main__':
    ap = argparse.ArgumentParser(
        description='Run the mesh modes on local ranks, each against one '
                    'device.')
    ap.add_argument('n', type=int, nargs='?', default=4,
                    help='ranks (default 4)')
    ap.add_argument('--cpu', action='store_true',
                    help='run the ranks on the CPU (default: the card)')
    args = ap.parse_args()
    print(dryrun_multichip(args.n, device='cpu' if args.cpu else None))
