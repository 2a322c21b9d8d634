"""Serving a mesh model (``lcgp_tpu_torch/serve.py``: ``PredictServer`` on
every rank of an ('n',) mesh, the first rank serving and the others in
``follow()``), on one 4-rank gloo CPU group for the module: an exact and a
FITC mesh model, full and rep.  In each case:

- ``srv.predict`` on the first rank equals ``lcgp_tpu``'s single-device
  ``predict`` at the same parameters (and z) within rtol 1e-8 / atol 1e-10,
  and the model's mesh ``predict`` taken before the server started within
  rtol 1e-10 / atol 1e-12 (the server's tolerance against its model);
- concurrent clients share dispatches (counted on the dispatcher's path);
- a request of the wrong width raises before anything is broadcast, and
  the ranks stay in step (the requests after it are answered);
- a collective reload of every rank's own model at other parameters, and
  of an npz by path (every rank loads it), each answered as the reloaded
  model's mesh ``predict`` after the server stopped;
- a follower's ``predict`` raises naming ``follow()``, and every follower
  returns from ``follow()`` on the first rank's ``shutdown()``.

Every group call has a timeout, and every collective one of 60 s, so a
rank that falls out of step fails the case instead of hanging it.
"""
import numpy as np
import pytest

import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import params as P
from lcgp_tpu_torch.parallel import WorkerGroup, tasks

TOL_JAX = dict(rtol=1e-8, atol=1e-10)
TOL_MODEL = dict(rtol=1e-10, atol=1e-12)


@pytest.fixture(scope='module')
def group():
    with WorkerGroup(4, device='cpu', backend='gloo', timeout=180,
                     collective_timeout=60) as g:
        yield g


def _problem(sub, seed=0):
    rng = np.random.default_rng(seed)
    if sub == 'rep':
        xu = rng.uniform(0, 1, (30, 2))
        x = np.repeat(xu, 3, axis=0)
    else:
        x = rng.uniform(0, 1, (43, 2))
    y = (np.sin(3 * x[:, :1].T + np.linspace(0, 2, 5)[:, None])
         + 0.05 * rng.standard_normal((5, x.shape[0])))
    return x, y, rng.uniform(0, 1, (7, 2))


def _jax_predict(x, y, ctor, free, z, x0):
    m = lcgp_tpu.LCGP(y=y, x=x, **ctor)
    m._free = P.FreeParams(*map(jnp.asarray, free))
    if z is not None:
        m._z = jnp.asarray(z)
    m._params_version += 1
    return [np.asarray(t) for t in m.predict(x0)]


def _close(got, ref, tol):
    for a, b in zip(got, ref):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), **tol)


@pytest.mark.parametrize('fitc', [False, True], ids=['exact', 'fitc'])
@pytest.mark.parametrize('sub', ['full', 'rep'])
def test_served_mesh_model(group, tmp_path, sub, fitc):
    x, y, x0 = _problem(sub)
    ctor = dict(q=2, submethod=sub)
    if fitc:
        ctor['inducing'] = 9
    jm = lcgp_tpu.LCGP(y=y, x=x, **ctor)
    free = [np.asarray(a) for a in jm._free]
    free2 = [a + 0.1 for a in free]
    # the reload by path: an npz of lcgp_tpu's, at a third point
    jm._free = P.FreeParams(*(jnp.asarray(a - 0.1) for a in free))
    path = str(tmp_path / 'reload.npz')
    jm.save(path)
    res = group.run(tasks.serve_mesh, ('n', 4), x, y, ctor, free, x0,
                    reload_free=free2, reload_path=path,
                    fullcov=sub == 'full', timeout=150)
    lead, followers = res[0], res[1:]
    z = lead['z']
    for r in followers:
        if fitc:
            np.testing.assert_array_equal(r['z'], z)
        assert 'follow()' in r['follower_predict']
        assert r['followed']
    # the served answers: one device (lcgp_tpu) and the mesh model
    _close(lead['served'], _jax_predict(x, y, ctor, free, z, x0), TOL_JAX)
    _close(lead['served'], lead['ref'], TOL_MODEL)
    # concurrent one-row clients coalesced, each answered by its rows
    assert lead['dispatches'] < len(lead['clients'])
    for i, ans in enumerate(lead['clients']):
        _close(ans, [o[:, i:i + 1] for o in lead['ref']], TOL_MODEL)
    assert 'expected (n0, 2) inputs' in lead['bad_request']
    if sub == 'full':
        _close(lead['fullcov'], lead['ref_fullcov'], TOL_MODEL)
    # the collective reloads
    assert lead['reload_reused'] is True
    _close(lead['served_reload'],
           _jax_predict(x, y, ctor, free2, z, x0), TOL_JAX)
    _close(lead['served_reload'], lead['ref_reload'], TOL_MODEL)
    _close(lead['served_load'], lead['ref_load'], TOL_MODEL)
    _close(lead['served_load'],
           _jax_predict(x, y, ctor, [a - 0.1 for a in free],
                        np.asarray(jm._z) if fitc else None, x0), TOL_JAX)
    assert lead['info']['mesh'] == {'n': 4}
    assert lead['info']['reload_count'] == 2
