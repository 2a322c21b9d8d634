"""Rank-side functions for :class:`~.group.WorkerGroup`: each builds its mesh
(every rank of the world calls it), runs one operation on it and returns
NumPy, so a caller in another process (a test, :mod:`.dryrun`,
``chip_smoke.py``) can hold the ranks' answers against one device.

A mesh is named by a spec: ``('n', n_n)``, ``('nc', n_comp, n_n)`` or
``('co', n_comp, n_out)``.  Data and parameters arrive as NumPy: a dict with
the fields of ``FullData`` (``ys``) or ``RepData`` (``ybar``), the four
free-parameter arrays and, for FITC, the standardized inducing points z.  A
rank outside the mesh returns None.
"""
from __future__ import annotations

import threading
import time

import numpy as np
import torch

from ..models import likelihood as lik
from ..models import params as Pm
from ..models import sparse
from . import fitc_shard
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


def _release(mesh):
    """On a card, return the blocks this rank's allocator caches: ranks
    that share a card would otherwise each keep their last run's peak."""
    if mesh.device.type == 'cuda':
        torch.cuda.empty_cache()


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
            kernel='matern32'):
    """``loss(free)`` of the mesh's module for the data."""
    cd = compute_dtype_of(compute_dtype)
    if spec[0] == 'co':
        return mesh_mod.make_sharded_loss(mesh, data, compute_dtype=cd,
                                          jitter=jitter, kernel=kernel)
    sub = 'rep' if isinstance(data, lik.RepData) else 'full'
    return nshard.make_loss(sub, data, mesh, compute_dtype=cd, jitter=jitter,
                            kernel=kernel)


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


def fitc_loss_and_grad(spec, data, free, z, *, device='cpu',
                       compute_dtype=None, with_z=False):
    """(loss, [grad of each free leaf, and of z with ``with_z``]) of the
    n-sharded FITC loss at the inducing points z."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    _release(mesh)
    d = data_of(data, device)
    sub = 'rep' if isinstance(d, lik.RepData) else 'full'
    leaves = Pm.FreeParams(*(t.requires_grad_(True)
                             for t in free_of(free, device)))
    zt = _t(z, device).to(torch.float64).requires_grad_(with_z)
    v = fitc_shard.make_loss(sub, d, zt, mesh,
                             compute_dtype=compute_dtype_of(compute_dtype))(
                                 leaves)
    grads = torch.autograd.grad(v, [*leaves, zt] if with_z else leaves)
    return float(v.detach()), [host(g) for g in grads]


def fitc_aux_and_predict(spec, data, free, z, x0s, *, device='cpu'):
    """The n-sharded FITC aux's fields and ``sparse.predict_fitc_core``'s
    latent prediction from it at standardized x0s, f64."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    d, fr = data_of(data, device), free_of(free, device)
    zt = _t(z, device).to(torch.float64)
    mode = 'rep' if isinstance(d, lik.RepData) else 'full'
    aux = fitc_shard.compute_aux_fitc_nsharded(fr, d, zt, mode, mesh)
    ghat, gvar = sparse.predict_fitc_core(fr, d, aux, zt, _t(x0s, device))
    return dict(**{k: host(v) for k, v in aux._asdict().items()},
                ghat=host(ghat), gvar=host(gvar))


def saved_bytes(spec, data, free, *, device='cpu'):
    """The bytes autograd saves for the backward during one forward of the
    n-sharded full loss (``saved``), the loss and the gradient of each free
    leaf."""
    mesh = make(spec, device)
    if not mesh.member:
        return None
    d = data_of(data, device)
    total = 0

    def pack(t):
        nonlocal total
        total += t.numel() * t.element_size()
        return t

    leaves = Pm.FreeParams(*(t.requires_grad_(True)
                             for t in free_of(free, device)))
    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        v = nshard.neglpost_full_nsharded(leaves, d, mesh)
    return dict(saved=total, loss=float(v.detach()),
                grad=[host(g) for g in torch.autograd.grad(v, leaves)])


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
    'z': lambda m, mesh, kw: host(m._z),
    'refine': lambda m, mesh, kw: m.refine_inducing(**kw),
    'aux': lambda m, mesh, kw: {k: host(v) for k, v in
                                m._ensure_aux()._asdict().items()},
}


def model(spec, x, y, ctor: dict, steps, *, device='cpu', load=None):
    """Construct ``LCGP(y=y, x=x, device=device, **ctor)`` (or, with
    ``load``, ``LCGP.load(load)``) on every rank and run ``steps``, a list
    of (name, argument) of :data:`STEPS`; returns the list of their
    results.  ``('fit', kw)`` fits on the mesh unless ``kw['on_mesh']`` is
    False, recording callbacks with ``kw['record']``."""
    from ..models.lcgp import LCGP
    mesh = make(spec, device)
    if not mesh.member:
        return None
    m = (LCGP.load(load, device=device) if load is not None
         else LCGP(y=y, x=x, device=device, **ctor))
    return [STEPS[name](m, mesh, arg) for name, arg in steps]


def refusals(spec, x, y, *, device='cpu'):
    """What five calls raise, as (type name, message), None where one
    succeeds: FITC on an n-mesh (set_mesh and fit; ported, so None), FITC
    on a ('comp','out') mesh, and a mesh of other axis names (fit and
    set_mesh)."""
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
        except ValueError as e:
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


def _fitc_launches(kind):
    """(Gram, VJP, K5) launches of the kind, f64 then f32: six counts."""
    from ..ops.launch import family
    fam = family(kind)
    return tuple(c for fn in (fam.gram, fam.vjp, fam.vjp_x)
                 for c in (fn.launches - fn.launches_f32, fn.launches_f32))


def _since(start, kind):
    return tuple(b - a for a, b in zip(start, _fitc_launches(kind)))


def measure_fitc(spec, x, y, ctor, x0, *, device, fit=None, refine=None):
    """One rank's share of a timed n-sharded FITC run (``chip_smoke.py`` on
    a card): the model on the mesh, one loss+grad in the free parameters
    as the fit drivers see it (first and warm, host seconds; the bytes
    staged through the host; the peak memory and what was resident before
    it; the launches), the aux and ``predict(x0)``, then
    ``refine_inducing(**refine)`` and ``fit(mesh=..., **fit)`` when given
    (their launches, the fitted parameters and z).  Launches are
    ``_fitc_launches`` deltas: (Gram, VJP, K5) f64 then f32;
    ``launches_total`` counts all of the run's."""
    from ..fit._flat import Flattener
    from ..fit.scipy_lbfgs import value_and_grad
    from ..models.lcgp import LCGP
    mesh = make(spec, device)
    if not mesh.member:
        return None
    cuda = mesh.device.type == 'cuda'

    def sync_s(t0):
        if cuda:
            torch.cuda.synchronize()
        return time.perf_counter() - t0

    m = LCGP(y=y, x=x, device=device, **ctor)
    m.set_mesh(mesh)
    kind = m.kernel
    flat = Flattener(m.free)
    vg = value_and_grad(m._loss_fn(), flat)
    z0 = flat.ravel(m.free).cpu().numpy()
    out = dict(rank=torch.distributed.get_rank(), z=host(m._z))
    start = _fitc_launches(kind)
    _release(mesh)
    if cuda:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out['resident_bytes'] = torch.cuda.memory_allocated()
    c0, s0, t0 = _fitc_launches(kind), mesh.staged_bytes, time.perf_counter()
    out['loss'], out['grad'] = vg(z0)
    out['first_s'] = sync_s(t0)
    out['launches'] = _since(c0, kind)
    out['staged_bytes'] = mesh.staged_bytes - s0
    if cuda:
        out['peak_bytes'] = torch.cuda.max_memory_allocated()
    t0 = time.perf_counter()
    vg(z0)
    out['warm_s'] = sync_s(t0)
    c0, t0 = _fitc_launches(kind), time.perf_counter()
    m.compute_aux_predictive_quantities()
    out['aux_s'] = sync_s(t0)
    out['launches_aux'] = _since(c0, kind)
    c0, t0 = _fitc_launches(kind), time.perf_counter()
    out['predict'] = [host(t) for t in m.predict(x0)]
    out['request_s'] = sync_s(t0)
    out['launches_predict'] = _since(c0, kind)
    if refine is not None:
        c0, t0 = _fitc_launches(kind), time.perf_counter()
        out['refine_loss'] = m.refine_inducing(**refine)
        out['refine_s'] = sync_s(t0)
        out['launches_refine'] = _since(c0, kind)
    if fit is not None:
        c0, t0 = _fitc_launches(kind), time.perf_counter()
        m.fit(mesh=mesh, **fit)
        out['fit_s'] = sync_s(t0)
        out['launches_fit'] = _since(c0, kind)
        out['fit_free'] = [host(t) for t in m.free]
        out['fit_z'] = host(m._z)
    out['launches_total'] = _since(start, kind)
    return out


# serve_mesh's concurrent one-row clients, and the seconds each of their
# dispatches is held so that the others queue behind it
SERVE_CLIENTS, SERVE_DELAY_S = 4, 0.05


def serve_mesh(spec, x, y, ctor, free, x0, *, device='cpu', batch_size=16,
               reload_free=None, reload_path=None, fullcov=False,
               requests=0):
    """A mesh model served by every rank (``serve.PredictServer``): each
    constructs the model at ``free`` and attaches the mesh, takes the mesh
    ``predict(x0)`` before the server starts (a collective), and constructs
    the server.  The first rank then predicts x0, times ``requests``
    sequential requests of x0 (host ms), sends SERVE_CLIENTS concurrent
    requests through a dispatch slowed by SERVE_DELAY_S (counting the
    dispatches), sends a request of the wrong width, and with ``fullcov``
    a fullcov request; reloads a model at ``reload_free`` (every rank's
    own) and the npz at ``reload_path``, predicting after each; and shuts
    the server down.  The other ranks call ``predict`` (which must raise)
    and ``follow``.  After the server stops every rank takes the mesh
    predictions of the reloaded models.  ``launches`` counts the kind's
    launches of all of it (``_fitc_launches``)."""
    from ..models.lcgp import LCGP
    from ..serve import PredictServer
    mesh = make(spec, device)
    if not mesh.member:
        return None
    _release(mesh)

    def on_mesh(m, fr):
        if fr is not None:
            m.free = Pm.FreeParams(*fr)
        m.set_mesh(mesh)
        return m

    m = LCGP(y=y, x=x, device=device, **ctor)
    start = _fitc_launches(m.kernel)
    m = on_mesh(m, free)
    out = dict(rank=torch.distributed.get_rank(), z=host(m._z),
               ref=[host(t) for t in m.predict(x0)])
    if fullcov:
        out['ref_fullcov'] = [host(t) for t in
                              m.predict(x0[:3], return_fullcov=True)]
    m2 = (None if reload_free is None else
          on_mesh(LCGP(y=y, x=x, device=device, **ctor), reload_free))
    srv = PredictServer(m, batch_size=batch_size, device=device)
    if not mesh.is_first:
        try:
            srv.predict(x0)
        except RuntimeError as e:
            out['follower_predict'] = str(e)
        srv.follow(reload=lambda: m2)
        out['followed'] = True
    else:
        out['served'] = list(srv.predict(x0))
        lat = []
        for _ in range(requests):
            t0 = time.perf_counter()
            srv.predict(x0)
            lat.append((time.perf_counter() - t0) * 1e3)
        out['latency_ms'] = lat
        calls, real = [], srv._live

        def counting(batch):
            calls.append(batch.shape[0])
            time.sleep(SERVE_DELAY_S)     # widen the coalescing window
            return real(batch)
        srv._live = counting
        answers = [None] * SERVE_CLIENTS

        def client(i):
            answers[i] = srv.predict(x0[i:i + 1])
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(SERVE_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        if any(t.is_alive() for t in threads):
            raise RuntimeError('a client was not answered within 120 s')
        srv._live = real
        out['clients'] = [list(a) for a in answers]
        out['dispatches'] = len(calls)
        try:
            srv.predict(np.zeros((3, x0.shape[1] + 1)))
        except ValueError as e:
            out['bad_request'] = str(e)
        if fullcov:
            out['fullcov'] = list(srv.predict_fullcov(x0[:3]))
        if m2 is not None:
            out['reload_reused'] = srv.reload(m2)['reused_executable']
            out['served_reload'] = list(srv.predict(x0))
        if reload_path is not None:
            srv.reload(reload_path)
            out['served_load'] = list(srv.predict(x0))
        out['info'] = srv.info()
        srv.shutdown()
    if m2 is not None:
        out['ref_reload'] = [host(t) for t in m2.predict(x0)]
    if reload_path is not None:
        m3 = on_mesh(LCGP.load(reload_path, device=device), None)
        out['ref_load'] = [host(t) for t in m3.predict(x0)]
    out['launches'] = _since(start, m.kernel)
    return out


# ---------------------------------------------------------------------------
# examples/torch_multichip_sharded.py: the demo every rank runs
# ---------------------------------------------------------------------------

def _rel_max(a, b):
    """max |a - b| over the largest |b|, for tensors or sequences of them."""
    if isinstance(a, torch.Tensor):
        a, b = [a], [b]
    num = max(float((u.detach().double() - v.detach().double()).abs().max())
              for u, v in zip(a, b))
    top = max(float(v.detach().double().abs().max()) for v in b)
    return num / max(top, 1e-300)


def multichip_demo(n_comp, n_out, steps, *, device='cpu'):
    """``examples/torch_multichip_sharded.py`` on this rank of the world
    (every rank calls it): each mesh mode against one device on the same
    rank.

    1. the ('comp','out') mesh (n_comp, n_out): the sharded loss and
       gradient at the init, then ``fit_sharded`` (Adam, ``steps``), each
       against one device's (``fit/adam.py`` on the model's loss);
    2. the ('n',) mesh of the world: ``fit(mesh=..., method='adam')`` on the
       exact path, then ``predict`` against one device's at the fitted
       parameters;
    3. n-sharded FITC (``inducing=32``) on that mesh, the same way;
    4. with 4 or more ranks (an even count), the ('comp','n') mesh
       (2, ranks/2), the same way.

    Returns {'lines': the demo's printed lines, each mode's relative
    differences and seconds, 'launches': this rank's (Gram, VJP, K5)
    launches of the run, f64 then f32, 'launches_ranks': every rank's}."""
    import torch.distributed as dist
    from ..fit.adam import minimize_adam
    from ..models.lcgp import LCGP
    start = _fitc_launches('matern32')
    lines, out = [], {}
    world = dist.get_world_size()
    lines.append(f'ranks: {world} on {device}')
    mesh = mesh_mod.make_mesh(n_comp=n_comp, n_out=n_out, device=device)
    lines.append(f'mesh: {mesh}')

    rng = np.random.default_rng(0)
    q = n_comp * 2
    p = max(n_out * 8, q)
    x = rng.uniform(0, 1, (256, 4))
    y = (np.sin(2 * np.pi * np.linspace(0, 1, p))[:, None] * x[:, 0][None, :]
         + 0.1 * rng.standard_normal((p, 256)))

    model = LCGP(y=y, x=x, q=q, device=device)
    leaves = Pm.FreeParams(*(t.detach().clone().requires_grad_(True)
                             for t in model.free))
    v1 = model._loss_fn()(leaves)
    g1 = torch.autograd.grad(v1, leaves)
    single = float(v1.detach())
    v, g = mesh_mod.make_sharded_value_and_grad(mesh, model._data)(
        model.free, model._data)
    out['sharded_loss'], out['single_loss'] = float(v), single
    out['sharded_loss_rel'] = abs(float(v) - single) / abs(single)
    out['sharded_grad_rel'] = max(_rel_max(a, b) for a, b in zip(g, g1))
    lines.append(f'sharded loss {float(v):.6f} vs single-device '
                 f'{single:.6f}; gradient max diff '
                 f'{out["sharded_grad_rel"]:.2e} of a leaf\'s largest')

    t0 = time.time()
    _, fit_res = mesh_mod.fit_sharded(model._data, model.free, mesh,
                                      steps=steps, learning_rate=3e-2)
    out['adam_s'] = time.time() - t0
    one = minimize_adam(model._loss_fn(), model.free, steps=steps,
                        learning_rate=3e-2)
    out['adam_loss_rel'] = abs(float(fit_res.fun) - float(one.fun)) / abs(
        float(one.fun))
    lines.append(f'{steps} sharded Adam steps in {out["adam_s"]:.2f}s; loss '
                 f'{single:.4f} -> {float(fit_res.fun):.4f} (stop: '
                 f'{fit_res.stop_reason}); single-device Adam '
                 f'{float(one.fun):.4f}')

    def predict_parity(mesh, **ctor):
        m = LCGP(y=y, x=x, q=q, device=device, **ctor)
        t0 = time.time()
        m.fit(mesh=mesh, method='adam', steps=steps, learning_rate=3e-2)
        x0 = np.random.default_rng(1).uniform(0, 1, (8, 4))
        got = m.predict(x0)[0]
        secs = time.time() - t0
        ref = LCGP(y=y, x=x, q=q, device=device, **ctor)
        ref.free = m.free
        if m._z is not None:
            ref._z = m._z.clone()
        return _rel_max(got, ref.predict(x0)[0]), secs

    nmesh = nshard.make_n_mesh(device=device)
    out['n_predict_rel'], out['n_s'] = predict_parity(nmesh)
    lines.append(f'n-sharded fit+predict over {world} ranks in '
                 f'{out["n_s"]:.2f}s; predict vs single-device max diff '
                 f'{out["n_predict_rel"]:.2e} of the largest')
    out['fitc_predict_rel'], out['fitc_s'] = predict_parity(
        nmesh, inducing=32)
    lines.append(f'n-sharded FITC (m=32) fit+predict in '
                 f'{out["fitc_s"]:.2f}s; predict vs single-device max diff '
                 f'{out["fitc_predict_rel"]:.2e} of the largest')
    if world >= 4 and world % 2 == 0:
        ncmesh = nshard.make_nc_mesh(2, world // 2, device=device)
        out['nc_predict_rel'], out['nc_s'] = predict_parity(ncmesh)
        lines.append(f"('comp','n') {{'comp': 2, 'n': {world // 2}}} "
                     f"fit+predict in {out['nc_s']:.2f}s; predict vs "
                     f"single-device max diff {out['nc_predict_rel']:.2e} "
                     "of the largest")
    out['launches'] = _since(start, 'matern32')
    out['launches_ranks'] = [None] * world
    dist.all_gather_object(out['launches_ranks'], out['launches'])
    out['lines'] = lines
    return out
