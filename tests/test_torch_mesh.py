"""The port's ('comp','out') mesh (``lcgp_tpu_torch/parallel/mesh.py``)
against lcgp_tpu on one device: the counterparts of
``tests/test_sharding.py``'s tests, on one 4-rank gloo CPU group for the
module (``parallel.WorkerGroup``), at that file's sizes and tolerances:

- loss rtol 1e-10, gradient rtol 1e-8 / atol 1e-10 against
  ``lcgp_tpu.models.likelihood`` and ``jax.grad``;
- the mesh Adam fit's loss within rtol 1e-6 of lcgp_tpu's single-device
  Adam, its callbacks at each block, checkpoint and stop reason;
- the mesh L-BFGS fits ('lbfgs-jax', 'scipy') within 1e-8 of lcgp_tpu's
  single-device fits;
- every rank's fitted parameters equal bit for bit;
- FITC on a ('comp','out') mesh and meshes of other axis names refused as
  lcgp_tpu refuses them, and FITC on an ('n',) mesh accepted.

The ranks run functions of ``lcgp_tpu_torch.parallel.tasks``; the JAX side
runs in this process.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import basis as basis_mod
from lcgp_tpu.models import likelihood as lik
from lcgp_tpu.models import params as P
from lcgp_tpu_torch import parallel
from lcgp_tpu_torch.parallel import WorkerGroup, dryrun, nshard, tasks

torch.set_num_threads(1)  # pytest -n workers share the host's cores

LOSS_RTOL = 1e-10
GRAD_TOL = dict(rtol=1e-8, atol=1e-10)


@pytest.fixture(scope='module')
def group():
    # short timeouts: a rank that misses a collective fails the test in a
    # minute instead of hanging the suite
    with WorkerGroup(4, device='cpu', backend='gloo', timeout=180,
                     collective_timeout=60) as g:
        yield g


def _np_free(free):
    return [np.asarray(a) for a in free]


def _full_problem(q=4, p=8, n=24, d=2, seed=0):
    rng = np.random.default_rng(seed)
    xs = rng.uniform(0, 1, (n, d))
    ys = rng.standard_normal((p, n))
    ys = (ys - ys.mean(1, keepdims=True)) / ys.std(1, keepdims=True)
    b = basis_mod.init_phi(ys, q=q)
    data = dict(xs=xs, ys=ys, phi=b.phi, diag_D=b.diag_D,
                sigma_map=P.sigma_index_map([1] * p))
    jdata = lik.FullData(**{k: jnp.asarray(v) for k, v in data.items()})
    return data, jdata, P.init_values(xs, ys, b.q, [1] * p)


def _rep_problem(q=4, p=8, n=16, seed=1):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n, 2))
    ybar = rng.standard_normal((p, n))
    b = basis_mod.init_phi(ybar, q=q)
    data = dict(xs=xu, ybar=ybar, scale=np.ones(p),
                r=rng.integers(1, 4, n).astype(np.float64), phi=b.phi,
                diag_D=b.diag_D, sigma_map=P.sigma_index_map([1] * p))
    jdata = lik.RepData(**{k: jnp.asarray(v) for k, v in data.items()})
    return data, jdata, P.init_values(xu, ybar, q, [1] * p)


def _check_vg(got, loss_fn, jdata, free):
    v, g = got
    ref_v, ref_g = jax.value_and_grad(loss_fn)(free, jdata)
    np.testing.assert_allclose(v, float(ref_v), rtol=LOSS_RTOL)
    for a, b in zip(g, jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(a, np.asarray(b), **GRAD_TOL)


def _alike(results):
    """Every member rank's answer, checked equal bit for bit."""
    got = [r for r in results if r is not None]
    for other in got[1:]:
        for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got[0]


class TestShardedLoss:
    def test_matches_single_device(self, group):
        data, jdata, free = _full_problem()
        got = _alike(group.run(tasks.sharded_value_and_grad, ('co', 2, 2),
                               data, _np_free(free)))
        _check_vg(got, lik.neglpost_full, jdata, free)

    def test_comp_only_mesh(self, group):
        data, jdata, free = _full_problem(q=8, p=8)
        got = _alike(group.run(tasks.loss_and_grad, ('co', 4, 1), data,
                               _np_free(free)))
        _check_vg(got, lik.neglpost_full, jdata, free)

    def test_fit_sharded_decreases_loss(self, group):
        data, jdata, free = _full_problem()
        l0 = float(lik.neglpost_full(free, jdata))
        free1, res = _alike(group.run(tasks.fit_sharded, ('co', 2, 2), data,
                                      _np_free(free), steps=30,
                                      learning_rate=3e-2))
        l1 = float(lik.neglpost_full(
            P.FreeParams(*map(jnp.asarray, free1)), jdata))
        assert l1 < l0
        assert res['nit'] == 30 and res['stop_reason'] == 'steps'

    def test_rep_sharded(self, group):
        data, jdata, free = _rep_problem()
        got = _alike(group.run(tasks.loss_and_grad, ('co', 2, 2), data,
                               _np_free(free)))
        _check_vg(got, lik.neglpost_rep, jdata, free)

    @pytest.mark.parametrize('spec', [('co', 4, 1), ('co', 1, 4)])
    def test_uneven_split(self, group, spec):
        # q=3 over 4 'comp' ranks leaves one rank no component, and p=6 over
        # 4 'out' ranks splits unevenly: every term must still enter once
        data, jdata, free = _full_problem(q=3, p=6, seed=3)
        got = _alike(group.run(tasks.loss_and_grad, spec, data,
                               _np_free(free)))
        _check_vg(got, lik.neglpost_full, jdata, free)


def _xy(seed, n=40, p=8):
    rng = np.random.default_rng(seed)
    return rng.uniform(0, 1, (n, 2)), rng.standard_normal((p, n))


class TestModelMeshFit:
    def test_fit_with_mesh_kwarg(self, group):
        x, y = _xy(9)
        out = _alike(group.run(tasks.model, ('co', 2, 2), x, y, dict(q=4), [
            ('loss', None),
            ('fit', dict(steps=60, learning_rate=3e-2)),
            ('loss', None), ('predict', x[:5]), ('free', None)]))
        l0, _, l1, (yp, ypv, _), _ = out
        assert l1 < l0
        assert np.isfinite(yp).all()
        assert (ypv > 0).all()

    def test_mesh_fit_optimizer_parity(self, group, tmp_path):
        x, y = _xy(11)
        ckpt = tmp_path / 'mesh_fit.npz'
        m_single = lcgp_tpu.LCGP(y=y, x=x, q=4)
        m_single.fit(method='adam', steps=60, learning_rate=3e-2,
                     block_steps=20)
        fit, loss = _alike(group.run(tasks.model, ('co', 2, 2), x, y,
                                     dict(q=4), [
            ('fit', dict(steps=60, learning_rate=3e-2, block_steps=20,
                         record=True, checkpoint_path=str(ckpt))),
            ('loss', None)]))
        assert [s for s, _ in fit['callbacks']] == [20, 40, 60]
        assert ckpt.exists()
        assert fit['stop_reason'] in ('steps', 'plateau')
        assert fit['nit'] == 60
        np.testing.assert_allclose(loss, float(m_single.loss()), rtol=1e-6)

    def test_mesh_lbfgs_matches_single_device(self, group):
        # 60 L-BFGS iterations, not test_sharding.py's 120: past ~60 on this
        # problem the trajectory follows last-bit differences of the loss
        # (at 120 a one-rank ('comp','out') mesh, whose only difference is
        # the association of the noise terms, ends 2.2e-7 from one device,
        # a 1x4 mesh 4.6e-6, and the 2x2 mesh 0.020 lower, 6e-5 relative,
        # in another part of the valley; at 60 all within 2e-10)
        x, y = _xy(13)
        m_single = lcgp_tpu.LCGP(y=y, x=x, q=4)
        m_single.fit(method='lbfgs-jax', maxiter=60)
        target = float(m_single.loss())
        m_sci = lcgp_tpu.LCGP(y=y, x=x, q=4)
        m_sci.fit(method='scipy', maxiter=80)
        out = _alike(group.run(tasks.model, ('co', 2, 2), x, y, dict(q=4), [
            ('fit', dict(method='lbfgs-jax', maxiter=60)), ('loss', None),
            ('predict', x[:4]), ('init', None),
            ('fit', dict(method='scipy', maxiter=80)), ('loss', None)]))
        _, sharded, (yp, _, _), _, _, sharded_sci = out
        assert abs(sharded - target) / max(1.0, abs(target)) < 1e-8
        # the fitted parameters are alike on every rank: predict needs no
        # mesh
        assert np.isfinite(yp).all()
        np.testing.assert_allclose(sharded_sci, float(m_sci.loss()),
                                   rtol=1e-8, atol=1e-8)

    def test_mesh_fit_plateau_stops_early(self, group):
        x, y = _xy(12, n=30, p=6)
        fit, = _alike(group.run(tasks.model, ('co', 2, 2), x, y, dict(q=2), [
            ('fit', dict(steps=400, learning_rate=3e-2, block_steps=10,
                         plateau_rtol=1e6))]))
        assert fit['stop_reason'] == 'plateau'
        assert fit['nit'] < 400

    def test_ranks_fit_alike_bit_for_bit(self, group):
        x, y = _xy(14)
        results = group.run(tasks.model, ('co', 2, 2), x, y, dict(q=4), [
            ('fit', dict(method='scipy', maxiter=15)), ('free', None)])
        assert all(r is not None for r in results)
        _alike([r[1] for r in results])

    def test_refusals(self, group):
        x, y = _xy(15, n=24, p=4)
        got = _alike(group.run(tasks.refusals, ('co', 2, 2), x, y))
        fitc_set, fitc_fit, fitc_co, bad_fit, bad_set = got
        # n-sharded FITC is ported: set_mesh and fit(mesh=nmesh) succeed
        assert fitc_set is None and fitc_fit is None
        assert fitc_co[0] == 'ValueError' and 'FITC' in fitc_co[1]
        for kind, msg in (bad_fit, bad_set):
            assert kind == 'ValueError' and 'axis names' in msg


@pytest.mark.parametrize('call,err,names', [
    (lambda: parallel.make_mesh(device='cpu'), RuntimeError,
     'init_distributed'),
    (lambda: nshard.make_n_mesh(device='cpu'), RuntimeError,
     'init_distributed'),
    (lambda: parallel.init_distributed(backend='nccl', device='cpu'),
     ValueError, "backend='gloo'"),
    (lambda: parallel.init_distributed(backend='mpi', device='cpu'),
     ValueError, "'nccl' or 'gloo'"),
    (lambda: WorkerGroup(2, device='cpu', backend='nccl'), ValueError,
     "backend='gloo'"),
])
def test_missing_group_or_backend_raises_naming_the_fix(call, err, names):
    # nothing falls back: a mesh without a process group, or a backend
    # that cannot serve the device, raises and names what to pass
    with pytest.raises(err, match=names):
        call()


@pytest.mark.parametrize('call', [
    lambda: WorkerGroup(2),
    lambda: dryrun.dryrun_multichip(2),
])
def test_card_by_default_raises_without_cuda(call, monkeypatch):
    # the worker group and the dryrun run on the card unless asked for the
    # CPU; without CUDA they raise before spawning and name the CPU option
    monkeypatch.setattr(torch.cuda, 'is_available', lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        call()


LBFGS_DRIFT_MESHES = (('co', 1, 1), ('co', 1, 4), ('co', 4, 1), ('co', 2, 2))


def lbfgs_drift(group, seeds=(13, 21, 34, 55, 89), iters=(60, 120)):
    """How far 'lbfgs-jax' fits on ('comp','out') meshes end from
    lcgp_tpu's single-device fit, the problem of
    test_mesh_lbfgs_matches_single_device at several seeds: rows of (seed,
    maxiter, fit, final loss, its difference from lcgp_tpu's).  The port's
    own one-device fit is a row too, so that the mesh's sums can be told
    from the association noise any second implementation has."""
    rows = []
    for seed in seeds:
        x, y = _xy(seed)
        for it in iters:
            ref = lcgp_tpu.LCGP(y=y, x=x, q=4)
            ref.fit(method='lbfgs-jax', maxiter=it)
            target = float(ref.loss())
            fit = dict(method='lbfgs-jax', maxiter=it)
            one = group.run(tasks.model, ('co', 1, 1), x, y, dict(q=4), [
                ('fit', dict(fit, on_mesh=False)), ('loss', None)])[0][1]
            rows.append((seed, it, 'port, one device', one, one - target))
            for spec in LBFGS_DRIFT_MESHES:
                got = _alike(group.run(tasks.model, spec, x, y, dict(q=4), [
                    ('fit', fit), ('loss', None)]))[1]
                rows.append((seed, it, f'{spec[1]}x{spec[2]} mesh', got,
                             got - target))
    return rows


if __name__ == '__main__':
    # PYTHONPATH=. python tests/test_torch_mesh.py: the readings behind
    # test_mesh_lbfgs_matches_single_device's 60 iterations, on the CPU
    jax.config.update('jax_platforms', 'cpu')
    jax.config.update('jax_enable_x64', True)
    with WorkerGroup(4, device='cpu', backend='gloo') as g:
        for seed, it, what, loss, diff in lbfgs_drift(g):
            print(f'seed {seed:3d}  maxiter {it:3d}  {what:17s}  '
                  f'loss {loss:.12e}  minus lcgp_tpu {diff:+.3e}  '
                  f'relative {diff / abs(loss - diff):+.3e}', flush=True)
