"""The port's n-sharded FITC (``lcgp_tpu_torch/parallel/fitc_shard.py``: the
distributed Woodbury panel's loss, gradient and aux, and the model's routes
on ('n',) and ('comp','n') meshes) against lcgp_tpu on one device: the
counterparts of ``tests/test_fitc_shard.py``'s tests and of
``tests/test_nshard.py::test_fitc_comp_mesh_parity``, on one 4-rank gloo
CPU group for the module, at their tolerances:

- losses rel < 1e-10 (f32 1e-5), gradients rel < 1e-8 (z's too);
- the aux fields ``Lmm``, ``alpha``, ``inner`` and ``u`` (trimmed to
  (q, n)) rel < 1e-9, ``predict_fitc_core`` on the sharded aux 1e-9;
- a 40-step Adam fit's loss 1e-9 and its predictions 1e-8;
  ``refine_inducing`` 1e-9; the ('comp','n') 2x2 fit's predictions with
  q=3 rtol 1e-8 / atol 1e-10.

The expected values come from ``lcgp_tpu``'s single-device ``sparse``
functions and ``LCGP`` in f64; the ranks load the JAX model's npz
(``lcgp_tpu.LCGP.save``, which carries ``inducing_z_std``) or take its
data, parameters and z as NumPy.  n=83 over 4 ranks is the ragged case.
Also the port's own: every rank's z and fitted parameters the same bits,
the FITC accessors on a mesh, a mesh model's ``save`` loading in
lcgp_tpu, and the replicated Kmm term's gradient counted once on either
mesh.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import params as P
from lcgp_tpu.models import sparse
from lcgp_tpu_torch.parallel import WorkerGroup, tasks


@pytest.fixture(scope='module')
def group():
    # short timeouts: a rank that misses a collective fails the test in a
    # minute instead of hanging the suite
    with WorkerGroup(4, device='cpu', backend='gloo', timeout=180,
                     collective_timeout=60) as g:
        yield g


def _first(results):
    """The first member rank's answer; every member's equals it bit for
    bit."""
    got = [r for r in results if r is not None]
    for other in got[1:]:
        for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got[0]


def _rel(a, b):
    a = np.asarray(a, dtype=float)
    b = np.asarray(b, dtype=float)
    return float(np.max(np.abs(a - b) / np.maximum(np.abs(a), 1e-12)))


def _field(n=83, d=3, p=6, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = (np.sin(x.sum(1))[None, :] * np.linspace(1, 2, p)[:, None]
         + 0.05 * rng.standard_normal((p, n)))
    return x, y


def _rep_field(n_unique=30, reps=4, d=2, p=4, seed=1):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n_unique, d))
    x = np.repeat(xu, reps, axis=0)
    y = (np.cos(2 * np.pi * x[:, :1].T) * np.linspace(0.5, 2, p)[:, None]
         + 0.1 * rng.standard_normal((p, x.shape[0])))
    return x, y


def _np(tree):
    return {k: np.asarray(v) for k, v in tree._asdict().items()}


def _args(mod):
    """(data, free, z) of a lcgp_tpu model as the ranks take them."""
    return _np(mod._data), [np.asarray(a) for a in mod._free], \
        np.asarray(mod._z)


def _saved(mod, tmp_path, name='jax_model.npz'):
    path = str(tmp_path / name)
    mod.save(path)
    return path


def _max_rel(got, ref):
    return max(_rel(a, np.asarray(b)) for a, b in zip(got, ref))


class TestLossParity:
    @pytest.mark.parametrize('spec', [('n', 4), ('nc', 2, 2)])
    def test_full_loss_and_grad(self, group, spec):
        # n=83 is not divisible by 4: the padding rows
        x, y = _field(n=83)
        mod = lcgp_tpu.LCGP(y=y, x=x, q=3, inducing=12)
        l1 = float(sparse.neglpost_full_fitc(mod._free, mod._data, mod._z))
        v, g = _first(group.run(tasks.fitc_loss_and_grad, spec,
                                *_args(mod)))
        assert _rel(l1, v) < 1e-10
        g1 = jax.grad(lambda f: sparse.neglpost_full_fitc(
            f, mod._data, mod._z))(mod._free)
        assert _max_rel(g, jax.tree.leaves(g1)) < 1e-8

    def test_rep_loss_and_grad(self, group):
        x, y = _rep_field()
        mod = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=10, submethod='rep')
        l1 = float(sparse.neglpost_rep_fitc(mod._free, mod._data, mod._z))
        v, g = _first(group.run(tasks.fitc_loss_and_grad, ('n', 4),
                                *_args(mod)))
        assert _rel(l1, v) < 1e-10
        g1 = jax.grad(lambda f: sparse.neglpost_rep_fitc(
            f, mod._data, mod._z))(mod._free)
        assert _max_rel(g, jax.tree.leaves(g1)) < 1e-8

    def test_f32_compute_dtype(self, group):
        x, y = _field(n=64, seed=2)
        mod = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=8)
        l1 = float(sparse.neglpost_full_fitc(
            mod._free, mod._data, mod._z, compute_dtype=jnp.float32))
        v, _ = _first(group.run(tasks.fitc_loss_and_grad, ('n', 4),
                                *_args(mod), compute_dtype='float32'))
        # the same precision recipe, the sums reordered over 4 ranks
        assert _rel(l1, v) < 1e-5


class TestKmmGradientCountedOnce:
    @pytest.mark.parametrize('spec,sub', [(('n', 4), 'full'),
                                          (('nc', 2, 2), 'full'),
                                          (('n', 4), 'rep')])
    def test_gradient_in_free_and_z(self, group, spec, sub):
        """Kmm and its factor are computed on every rank from the entered
        parameters and z: the gradient in (free, z) equals one device's,
        so the replicated Kmm term is counted once, not once a rank."""
        if sub == 'rep':
            x, y = _rep_field(seed=3)
            mod = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=9, submethod='rep')
            fn = sparse.neglpost_rep_fitc
        else:
            x, y = _field(n=45, seed=3)
            mod = lcgp_tpu.LCGP(y=y, x=x, q=3, inducing=9)
            fn = sparse.neglpost_full_fitc
        v, g = _first(group.run(tasks.fitc_loss_and_grad, spec, *_args(mod),
                                with_z=True))
        gf, gz = jax.grad(lambda f, z: fn(f, mod._data, z),
                          argnums=(0, 1))(mod._free, mod._z)
        assert _rel(float(fn(mod._free, mod._data, mod._z)), v) < 1e-10
        assert _max_rel(g[:4], jax.tree.leaves(gf)) < 1e-8
        assert _rel(g[4], gz) < 1e-8


class TestAuxPredictParity:
    @pytest.mark.parametrize('mode', ['full', 'rep'])
    def test_aux_fields(self, group, mode):
        if mode == 'rep':
            x, y = _rep_field()
            mod = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=10, submethod='rep')
        else:
            x, y = _field(n=83)
            mod = lcgp_tpu.LCGP(y=y, x=x, q=3, inducing=12)
        a1 = sparse.compute_aux_fitc(mod._free, mod._data, mod._z, mode)
        got = _first(group.run(tasks.fitc_aux_and_predict, ('n', 4),
                               *_args(mod), np.full((2, x.shape[1]), 0.5)))
        for f in ('Lmm', 'alpha', 'inner', 'u'):
            assert _rel(getattr(a1, f), got[f]) < 1e-9, f
        assert got['u'].shape == a1.u.shape     # the mesh padding trimmed

    def test_predict_core_consumes_sharded_aux(self, group):
        x, y = _field(n=83)
        mod = lcgp_tpu.LCGP(y=y, x=x, q=3, inducing=12)
        a1 = sparse.compute_aux_fitc(mod._free, mod._data, mod._z, 'full')
        x0 = np.random.default_rng(3).uniform(0, 1, (9, 3))
        gh1, gv1 = sparse.predict_fitc_core(mod._free, mod._data, a1,
                                            mod._z, jnp.asarray(x0))
        got = _first(group.run(tasks.fitc_aux_and_predict, ('n', 4),
                               *_args(mod), x0))
        assert _rel(gh1, got['ghat']) < 1e-9
        assert _rel(gv1, got['gvar']) < 1e-9


class TestModelIntegration:
    def test_set_mesh_accepts_fitc(self, group, tmp_path):
        x, y = _field(n=64, seed=4)
        ref = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=8)
        _, loss = _first(group.run(tasks.model, ('n', 4), None, None, None,
                                   [('set_mesh', None), ('loss', None)],
                                   load=_saved(ref, tmp_path)))
        assert _rel(float(ref.loss()), loss) < 1e-10

    def test_fit_predict_parity(self, group, tmp_path):
        x, y = _field(n=96, seed=5)
        m1 = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=10)
        path = _saved(m1, tmp_path)
        m1.fit(method='adam', steps=40, learning_rate=5e-2)
        x0 = np.random.default_rng(6).uniform(0, 1, (20, 3))
        _, loss, preds = _first(group.run(tasks.model, ('n', 4), None, None,
                                          None, [
            ('fit', dict(method='adam', steps=40, learning_rate=5e-2)),
            ('loss', None), ('predict', x0)], load=path))
        assert _rel(float(m1.loss()), loss) < 1e-9
        for a, b in zip(m1.predict(x0), preds):
            assert _rel(a, b) < 1e-8

    def test_comp_out_mesh_rejected_for_fitc(self, group):
        x, y = _field(n=48, seed=8)
        got = _first(group.run(tasks.refusals, ('co', 2, 2), x, y))
        assert got[2][0] == 'ValueError' and "('comp','out')" in got[2][1]

    def test_refine_inducing_on_mesh(self, group, tmp_path):
        x, y = _field(n=64, seed=7)
        m1 = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=8)
        path = _saved(m1, tmp_path)
        l1 = m1.refine_inducing(steps=5, learning_rate=1e-3)
        _, l2, z2 = _first(group.run(tasks.model, ('n', 4), None, None,
                                     None, [
            ('set_mesh', None),
            ('refine', dict(steps=5, learning_rate=1e-3)), ('z', None)],
            load=path))
        assert _rel(l1, l2) < 1e-9
        assert _rel(m1._z, z2) < 1e-9


def test_fitc_comp_mesh_parity(group):
    """The ('comp','n') 2x2 mesh with q=3 (not divisible by 'comp' = 2):
    fit and predict through the API, against the single-device FITC model
    at the fitted parameters and z."""
    rng = np.random.default_rng(8)
    x = rng.uniform(0, 1, (24, 2))
    y = rng.standard_normal((4, 24))
    x0 = rng.uniform(0, 1, (5, 2))
    _, yp, free, z = _first(group.run(tasks.model, ('nc', 2, 2), x, y,
                                      dict(q=3, inducing=8), [
        ('fit', dict(method='adam', steps=4, learning_rate=1e-2)),
        ('predict', x0), ('free', None), ('z', None)]))
    single = lcgp_tpu.LCGP(y=y, x=x, q=3, inducing=8)
    single._free = P.FreeParams(*map(jnp.asarray, free))
    single._z = jnp.asarray(z)
    single._params_version += 1
    np.testing.assert_allclose(yp[0], np.asarray(single.predict(x0)[0]),
                               rtol=1e-8, atol=1e-10)


class TestPortOwn:
    def test_ranks_hold_the_same_z_and_fit(self, group):
        """Every rank's inducing points (the first rank's, broadcast by
        set_mesh) and fitted parameters are the same bits."""
        x, y = _field(n=50, seed=9)
        for spec in (('n', 4), ('nc', 2, 2)):
            results = group.run(tasks.model, spec, x, y,
                                dict(q=3, inducing=7), [
                ('z', None), ('set_mesh', None), ('z', None),
                ('fit', dict(method='adam', steps=3, learning_rate=1e-2)),
                ('refine', dict(steps=2, learning_rate=1e-3)),
                ('free', None), ('z', None)])
            _first(results)

    @pytest.mark.parametrize('sub', ['full', 'rep'])
    def test_accessors_on_mesh_equal_one_device(self, group, sub, tmp_path):
        if sub == 'rep':
            x, y = _rep_field(seed=10)
            ref = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=9, submethod='rep')
        else:
            x, y = _field(n=51, seed=10)
            ref = lcgp_tpu.LCGP(y=y, x=x, q=2, inducing=9)
        _, acc, aux = _first(group.run(
            tasks.model, ('nc', 2, 2), None, None, None,
            [('set_mesh', None), ('accessors', None), ('aux', None)],
            load=_saved(ref, tmp_path)))
        assert _rel(ref.CinvMs, acc['CinvMs']) < 1e-9
        assert acc['CinvMs'].shape == (2, int(ref.n))
        for name in acc:
            if name != 'CinvMs':
                assert acc[name] is None and getattr(ref, name) is None
        a1 = sparse.compute_aux_fitc(ref._free, ref._data, ref._z, sub)
        assert sorted(aux) == ['Lmm', 'alpha', 'inner', 'u']
        for f in aux:
            assert _rel(getattr(a1, f), aux[f]) < 1e-9, f

    def test_save_on_mesh_loads_in_lcgp_tpu(self, group, tmp_path):
        # a collective: the mesh's first rank writes, every rank waits
        x, y = _field(n=40, seed=11)
        path = tmp_path / 'mesh_fitc.npz'
        _, _, free, z = _first(group.run(tasks.model, ('n', 4), x, y,
                                         dict(q=2, inducing=6), [
            ('fit', dict(method='adam', steps=2, learning_rate=1e-2)),
            ('save', str(path)), ('free', None), ('z', None)]))
        m = lcgp_tpu.LCGP.load(str(path))
        for a, b in zip(m._free, free):
            np.testing.assert_array_equal(np.asarray(a), b)
        np.testing.assert_array_equal(np.asarray(m._z), z)
