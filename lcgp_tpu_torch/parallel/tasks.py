"""Rank-side functions for :class:`~.group.WorkerGroup`: each builds its mesh
(every rank of the world calls it), runs one operation on it and returns
NumPy, so a caller in another process (a test, :mod:`.dryrun`,
``chip_smoke.py``) can hold the ranks' answers against one device.

A mesh is named by a spec: ``('n', n_n)``, ``('nc', n_comp, n_n)`` or
``('co', n_comp, n_out)``.  Data and parameters arrive as NumPy: a dict with
the fields of ``FullData`` (``ys``) or ``RepData`` (``ybar``), and the four
free-parameter arrays.  A rank outside the mesh returns None.
"""
from __future__ import annotations

import numpy as np
import torch

from ..models import likelihood as lik
from ..models import params as Pm
from . import mesh as mesh_mod
from . import nshard


def make(spec, device='cpu'):
    """The mesh a spec names (a collective)."""
    kind, *shape = spec
    if kind == 'n':
        return nshard.make_n_mesh(*shape, device=device)
    if kind == 'nc':
        return nshard.make_nc_mesh(*shape, device=device)
    if kind == 'co':
        return mesh_mod.make_mesh(*shape, device=device)
    raise ValueError(f'unknown mesh spec {spec!r}')


def host(t):
    return None if t is None else t.detach().cpu().numpy()


def _t(a, device):
    return torch.as_tensor(np.array(a), device=device)


def data_of(d: dict, device):
    """FullData or RepData on ``device`` from NumPy fields."""
    cls = lik.RepData if 'ybar' in d else lik.FullData
    return cls(**{k: _t(d[k], device) for k in cls._fields})


def free_of(f, device) -> Pm.FreeParams:
    return Pm.FreeParams(*(_t(a, device).to(torch.float64) for a in f))


def compute_dtype_of(name):
    """None, 'mixed' or 'float32' (torch.float32) from its name."""
    return torch.float32 if name == 'float32' else name


def loss_fn(spec, mesh, data, *, compute_dtype=None, jitter=0.0,
            kernel='matern32', custom_vjp=True):
    """``loss(free)`` of the mesh's module for the data."""
    cd = compute_dtype_of(compute_dtype)
    if spec[0] == 'co':
        return mesh_mod.make_sharded_loss(mesh, data, compute_dtype=cd,
                                          jitter=jitter, kernel=kernel)
    if isinstance(data, lik.RepData):
        return nshard.make_loss('rep', data, mesh, compute_dtype=cd,
                                jitter=jitter, kernel=kernel)

    def loss(free):
        return nshard.neglpost_full_nsharded(
            free, data, mesh, compute_dtype=cd, jitter=jitter,
            kernel=kernel, _custom_vjp=custom_vjp)
    return loss


def loss_and_grad(spec, data, free, *, device='cpu', **kw):
    """(loss, [grad of each free leaf]) on the mesh."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    loss = loss_fn(spec, mesh, data_of(data, device), **kw)
    leaves = Pm.FreeParams(*(t.requires_grad_(True)
                             for t in free_of(free, device)))
    v = loss(leaves)
    grads = torch.autograd.grad(v, leaves)
    return float(v.detach()), [host(g) for g in grads]


def sharded_value_and_grad(spec, data, free, *, device='cpu'):
    """(loss, [grads]) through ``mesh.make_sharded_value_and_grad``."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    d = data_of(data, device)
    v, g = mesh_mod.make_sharded_value_and_grad(mesh, d)(
        free_of(free, device), d)
    return float(v), [host(t) for t in g]


def fit_sharded(spec, data, free, *, device='cpu', **kw):
    """([fitted free arrays], result fields) of ``mesh.fit_sharded``."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    free1, res = mesh_mod.fit_sharded(data_of(data, device),
                                      free_of(free, device), mesh, **kw)
    return [host(t) for t in free1], dict(fun=float(res.fun),
                                          nit=int(res.nit),
                                          stop_reason=res.stop_reason)


def loss_value(spec, data, free, *, device='cpu', **kw):
    """The loss alone, without autograd."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    with torch.no_grad():
        return float(loss_fn(spec, mesh, data_of(data, device), **kw)(
            free_of(free, device)))


def dist_linalg(spec, M, b, *, device='cpu'):
    """The distributed factor, solve, logdet and inverse of the stack M
    (q, n, n) and vectors b (q, n), each gathered whole."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    M, b = _t(M, device), _t(b, device)
    L = nshard.dist_cholesky(mesh, M)
    return dict(
        L=host(nshard.gather_rows(mesh, L)),
        x=host(nshard.gather_rows(mesh, nshard.dist_cho_solve_vec(mesh, L,
                                                                  b))),
        X=host(nshard.gather_rows(mesh, nshard.dist_cho_solve(
            mesh, L, b[:, :, None].expand(-1, -1, 3).contiguous()))),
        logdet=host(nshard.dist_chol_logdet(mesh, L)),
        inv=host(nshard.gather_rows(mesh, nshard.dist_chol_inverse(mesh,
                                                                   L))))


def aux_and_predict(spec, data, free, x0s, *, device='cpu',
                    compute_dtype=None, jitter=0.0, kernel='matern32'):
    """The distributed aux (gathered, padding kept) and the latent
    prediction at standardized x0s."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    d, fr = data_of(data, device), free_of(free, device)
    cd = compute_dtype_of(compute_dtype)
    aux = nshard.compute_aux_nsharded(fr, d, mesh, compute_dtype=cd,
                                      jitter=jitter, kernel=kernel)
    ghat, gvar = nshard.predict_nsharded_core(
        fr, d, aux, _t(x0s, device), mesh, compute_dtype=cd, jitter=jitter,
        kernel=kernel)
    return dict(u=host(nshard.gather_u(mesh, aux)),
                L=host(nshard.gather_factor(mesh, aux)),
                ghat=host(ghat), gvar=host(gvar))


def saved_bytes(spec, data, free, *, device='cpu'):
    """Bytes autograd saves for the backward during one forward of the
    n-sharded full loss, with the custom backward and without it, and the
    gradient of each."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    d = data_of(data, device)
    out = {}
    for name, custom in (('custom', True), ('raw', False)):
        total = [0]

        def pack(t):
            total[0] += t.numel() * t.element_size()
            return t

        leaves = Pm.FreeParams(*(t.requires_grad_(True)
                                 for t in free_of(free, device)))
        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            v = nshard.neglpost_full_nsharded(leaves, d, mesh,
                                              _custom_vjp=custom)
        out[name] = total[0]
        out[f'grad_{name}'] = [host(g)
                               for g in torch.autograd.grad(v, leaves)]
        out[f'loss_{name}'] = float(v.detach())
    return out


# ---------------------------------------------------------------------------
# The model: LCGP constructed on every rank alike, then a list of steps
# ---------------------------------------------------------------------------

def _step_fit(m, mesh, kw):
    kw = dict(kw)
    record = kw.pop('record', False)
    seen = []
    if record:
        kw['callback'] = lambda s, v, p: seen.append((int(s), float(v)))
    m.fit(mesh=mesh if kw.pop('on_mesh', True) else None, **kw)
    res = m._fit_result
    return dict(nit=int(res.nit), fun=float(res.fun),
                stop_reason=getattr(res, 'stop_reason', None),
                callbacks=seen)


def _step_accessors(m, mesh, kw):
    names = (('CinvMs', 'LTs', 'Tks') if m.submethod == 'rep'
             else ('CinvMs', 'LBs', 'Ths'))
    return {k: host(getattr(m, k)) for k in names}


def _step_set_free(m, mesh, arrays):
    m.free = Pm.FreeParams(*arrays)


STEPS = {
    'loss': lambda m, mesh, kw: float(m.loss()),
    'fit': _step_fit,
    'set_mesh': lambda m, mesh, kw: m.set_mesh(mesh if kw is None else kw),
    'predict': lambda m, mesh, x0: [host(t) for t in m.predict(x0)],
    'accessors': _step_accessors,
    'free': lambda m, mesh, kw: [host(t) for t in m.free],
    'set_free': _step_set_free,
    'init': lambda m, mesh, kw: m.init_params(),
    'save': lambda m, mesh, path: m.save(path),
}


def model(spec, x, y, ctor: dict, steps, *, device='cpu'):
    """Construct ``LCGP(y=y, x=x, device=device, **ctor)`` on every rank and
    run ``steps``, a list of (name, argument) of :data:`STEPS`; returns
    the list of their results.  ``('fit', kw)`` fits on the mesh unless
    ``kw['on_mesh']`` is False, recording callbacks with
    ``kw['record']``."""
    from ..models.lcgp import LCGP
    mesh = make(spec, device)
    if not mesh.member:
        return None
    m = LCGP(y=y, x=x, device=device, **ctor)
    return [STEPS[name](m, mesh, arg) for name, arg in steps]


def refusals(spec, x, y, *, device='cpu'):
    """What the misuses raise: FITC on an n-mesh (set_mesh and fit), FITC
    on a ('comp','out') mesh, and a mesh of other axis names."""
    from ..models.lcgp import LCGP
    mesh = make(spec, device)
    nmesh = nshard.make_n_mesh(mesh.size_total, device=device)
    if not mesh.member:
        return None

    class Rows:
        axis_names = ('rows',)
        device = mesh.device
        is_first = True

    fitc = LCGP(y=y, x=x, device=device, q=2, inducing=6)
    plain = LCGP(y=y, x=x, device=device, q=2)
    out = []
    for call in (lambda: fitc.set_mesh(nmesh),
                 lambda: fitc.fit(mesh=nmesh, method='adam', steps=1),
                 lambda: fitc.fit(mesh=mesh, method='adam', steps=1),
                 lambda: plain.fit(mesh=Rows()),
                 lambda: plain.set_mesh(Rows())):
        try:
            call()
            out.append(None)
        except (ValueError, NotImplementedError) as e:
            out.append((type(e).__name__, str(e)))
    return out


def measure(spec, x, y, ctor, free, x0, *, device, fit=None,
            sample_every: int = 32):
    """One rank's share of a timed mesh run (``chip_smoke.py`` on a card):
    one loss+grad evaluation as the fit drivers see it (first and warm,
    host seconds; the bytes staged through the host; the kind's Gram and
    VJP launches; the peak memory), then on an n-mesh the aux (seconds;
    every ``sample_every``-th row of this rank's factor rows, with their
    global indices) and ``predict(x0)``; then ``fit(mesh=..., **fit)`` when
    given (the fitted free parameters).  ``launches_total`` counts the
    kind's launches of all of it, ``launches_predict`` those of the two
    predicts (at the request's shape, not the Gram rows')."""
    import time

    from ..fit._flat import Flattener
    from ..fit.scipy_lbfgs import value_and_grad
    from ..models.lcgp import LCGP
    from ..ops.launch import family
    mesh = make(spec, device)
    if not mesh.member:
        return None
    cuda = mesh.device.type == 'cuda'

    def sync_s(t0):
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    m = LCGP(y=y, x=x, device=device, **ctor)
    m.free = free
    opts = dict(compute_dtype=m._compute_dtype, jitter=m._jitter,
                kernel=m.kernel)
    if spec[0] == 'co':
        loss_fn = mesh_mod.make_sharded_loss(mesh, m._data, **opts)
    else:
        m.set_mesh(mesh)
        loss_fn = nshard.make_loss(m.submethod, m._data, mesh, **opts)
    fam = family(m.kernel)

    def counts():
        return fam.gram.launches, fam.vjp.launches

    flat = Flattener(m.free)
    vg = value_and_grad(loss_fn, flat)
    z0 = flat.ravel(m.free).cpu().numpy()
    out = dict(rank=torch.distributed.get_rank())
    start = counts()
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out['resident_bytes'] = torch.cuda.memory_allocated()
    c0, s0, t0 = counts(), mesh.staged_bytes, time.perf_counter()
    out['loss'], out['grad'] = vg(z0)
    out['first_s'] = sync_s(t0)
    out['launches'] = tuple(b - a for a, b in zip(c0, counts()))
    out['staged_bytes'] = mesh.staged_bytes - s0
    if cuda:
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    vg(z0)
    out['warm_s'] = sync_s(t0)
    if spec[0] != 'co':
        t0 = time.perf_counter()
        m.compute_aux_predictive_quantities()
        out['aux_s'] = sync_s(t0)
        L = m._aux.L
        qc, nb = L.shape[:2]
        rows = mesh.index(nshard.AXIS) * nb + np.arange(nb)
        keep = (rows % sample_every == 0) & (rows < m.n)
        first = mesh.index(nshard.COMP) * qc
        real = max(0, min(qc, int(m.q) - first))    # not the q padding
        out['factor_rows'] = rows[keep]
        out['factor_comps'] = (first, first + real)
        out['factor'] = host(L[:real, torch.as_tensor(keep)][..., :m.n])
        c0 = counts()
        m.predict(x0)
        t0 = time.perf_counter()
        out['predict'] = [host(t) for t in m.predict(x0)]
        out['request_s'] = sync_s(t0)
        out['launches_predict'] = tuple(b - a for a, b in zip(c0, counts()))
    if fit is not None:
        m.fit(mesh=mesh, **fit)
        out['fit_free'] = [host(t) for t in m.free]
        out['fit_nfev'] = int(m._fit_result.nfev)
    out['launches_total'] = tuple(b - a for a, b in zip(start, counts()))
    return out
