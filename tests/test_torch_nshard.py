"""The port's n-sharded path (``lcgp_tpu_torch/parallel/nshard.py``: the
distributed Cholesky, solves and logdet, the full and rep losses with their
hand-written backward, the aux and predict, and the model's ('n',) and
('comp','n') routes) against lcgp_tpu on one device: the counterparts of
``tests/test_nshard.py``'s tests (all but the FITC one, which
``tests/test_torch_fitc_shard.py`` holds), on one 4-rank gloo CPU group for the module, at that file's
tolerances:

- factor rtol 1e-10 / atol 1e-12, solve 1e-9 / 1e-11, logdet 1e-10;
- losses rtol 1e-10 (1e-12 on the ('comp','n') meshes), gradients rtol
  1e-7 / atol 1e-9 (1e-9 / 1e-11 on ('comp','n')), the f32 ('fast') losses
  2e-4 (2e-5 on ('comp','n'));
- the aux and the latent mean 1e-9 / 1e-12, the latent variance
  1e-8 / 1e-11; model predictions 1e-9 / 1e-12 (1e-8 / 1e-10 after a fit);
- a 'mixed' model's mesh predictions equal the 'high' model's bit for bit.

Not against lcgp_tpu.parallel: its shard_map programs compile for tens of
seconds each on the CPU, and its own tests hold it to one device.  With 4
ranks, n=26 and n=21 are the ragged (padded) cases.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

import lcgp_tpu
from lcgp_tpu.models import basis as basis_mod
from lcgp_tpu.models import likelihood as lik
from lcgp_tpu.models import params as P
from lcgp_tpu.models import predict as pred
from lcgp_tpu_torch.parallel import WorkerGroup, dryrun, tasks


@pytest.fixture(scope='module')
def group():
    # short timeouts: a rank that misses a collective fails the test in a
    # minute instead of hanging the suite
    with WorkerGroup(4, device='cpu', backend='gloo', timeout=180,
                     collective_timeout=60) as g:
        yield g


def _first(results):
    """The first member rank's answer; every member's is checked equal to
    it bit for bit (the results are replicated)."""
    got = [r for r in results if r is not None]
    for other in got[1:]:
        for a, b in zip(jax.tree.leaves(got[0]), jax.tree.leaves(other)):
            np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    return got[0]


def _np_free(free):
    return [np.asarray(a) for a in free]


def _spd_stack(q=3, n=32, seed=0):
    rng = np.random.default_rng(seed)
    A = rng.standard_normal((q, n, 8))
    return A @ np.swapaxes(A, -1, -2) + 5.0 * np.eye(n)


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


def _rep_problem(q=3, p=6, n=20, d=2, seed=0):
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n, d))
    ybar = rng.standard_normal((p, n))
    r = rng.integers(1, 5, n).astype(np.float64)
    b = basis_mod.init_phi(ybar, q=q)
    data = dict(xs=xu, ybar=ybar, scale=np.ones(p), r=r, phi=b.phi,
                diag_D=b.diag_D, sigma_map=P.sigma_index_map([1] * p))
    jdata = lik.RepData(**{k: jnp.asarray(v) for k, v in data.items()})
    return data, jdata, P.init_values(xu, ybar, b.q, [1] * p)


def _linalg(group, spec, M, b):
    return _first(group.run(tasks.dist_linalg, spec, M, b))


class TestDistChol:
    def test_matches_dense_cholesky(self, group):
        M = _spd_stack(q=3, n=32)
        got = _linalg(group, ('n', 4), M, np.ones((3, 32)))
        np.testing.assert_allclose(got['L'], np.linalg.cholesky(M),
                                   rtol=1e-10, atol=1e-12)
        np.testing.assert_allclose(got['inv'], np.linalg.inv(M),
                                   rtol=1e-9, atol=1e-11)

    def test_solve_matches_dense(self, group):
        M = _spd_stack(q=2, n=40, seed=1)
        b = np.random.default_rng(2).standard_normal((2, 40))
        got = _linalg(group, ('n', 4), M, b)
        ref = np.linalg.solve(M, b[..., None])[..., 0]
        np.testing.assert_allclose(got['x'], ref, rtol=1e-9, atol=1e-11)
        np.testing.assert_allclose(got['X'], np.repeat(ref[..., None], 3, -1),
                                   rtol=1e-9, atol=1e-11)

    def test_logdet_matches_dense(self, group):
        M = _spd_stack(q=3, n=24, seed=3)
        got = _linalg(group, ('n', 4), M, np.ones((3, 24)))
        np.testing.assert_allclose(got['logdet'], np.linalg.slogdet(M)[1],
                                   rtol=1e-10)

    def test_smaller_mesh(self, group):
        # a 2-rank mesh in the 4-rank world: every rank builds it, ranks 2
        # and 3 are outside it and return None without joining its
        # collectives
        M = _spd_stack(q=1, n=16, seed=4)
        results = group.run(tasks.dist_linalg, ('n', 2), M, np.ones((1, 16)))
        assert results[2] is None and results[3] is None
        np.testing.assert_allclose(_first(results)['L'],
                                   np.linalg.cholesky(M), rtol=1e-10,
                                   atol=1e-12)


def _vg(group, spec, data, free, **kw):
    return _first(group.run(tasks.loss_and_grad, spec, data, _np_free(free),
                            **kw))


def _check_grads(got, ref_g, rtol, atol):
    for a, b in zip(got, jax.tree.leaves(ref_g)):
        np.testing.assert_allclose(a, np.asarray(b), rtol=rtol, atol=atol)


class TestNShardedLoss:
    @pytest.mark.parametrize('n', [26, 32])     # 26: padded to 28
    def test_matches_single_device(self, group, n):
        data, jdata, free = _full_problem(n=n, seed=0 if n == 26 else 5)
        got = _first(group.run(tasks.loss_value, ('n', 4), data,
                               _np_free(free)))
        np.testing.assert_allclose(got, float(lik.neglpost_full(free, jdata)),
                                   rtol=1e-10)

    def test_gradient_matches(self, group):
        data, jdata, free = _full_problem(n=26, seed=6)
        v, g = _vg(group, ('n', 4), data, free)
        ref_v, ref_g = jax.value_and_grad(lik.neglpost_full)(free, jdata)
        np.testing.assert_allclose(v, float(ref_v), rtol=1e-10)
        _check_grads(g, ref_g, 1e-7, 1e-9)

    def test_fast_dtype_path(self, group):
        data, jdata, free = _full_problem(n=32, seed=7)
        got = _first(group.run(tasks.loss_value, ('n', 4), data,
                               _np_free(free), compute_dtype='float32',
                               jitter=1e-6))
        ref = float(lik.neglpost_full(free, jdata, compute_dtype=jnp.float32,
                                      jitter=1e-6))
        np.testing.assert_allclose(got, ref, rtol=2e-4)

    def test_backward_memory_bounded(self, group):
        """The hand-written backward saves a rank's factor rows and what
        the forward's inputs hold, nothing of the panel loop's steps (the
        counterpart of the compiled temp-size comparison): the saved bytes
        sit under an analytic bound, and the gradient is the reference's."""
        q, p, n, d, ndev = 4, 8, 256, 2, 4
        data, jdata, free = _full_problem(q=q, p=p, n=n, d=d, seed=9)
        got = _first(group.run(tasks.saved_bytes, ('n', ndev), data,
                               _np_free(free)))
        n_pad, f64 = n, 8                     # n divides by the 4 ranks
        nb = n_pad // ndev
        factor = q * nb * n_pad * f64         # the rank's rows of LB
        w = q * nb * f64
        # xs, mask, a, lLmb, lLmb0, lnug, D
        inputs = (n_pad * d + n_pad + q * n_pad + q * d + 3 * q) * f64
        # ys for a = (ys^T psi)^T, ys and ys / sqrt(sigma) for the noise
        data_terms = 3 * p * n * f64
        # the clamps of Pm.constrain (8 saves a (q,) or (q, d) leaf), phi
        # and the p-vectors of sigma (index, exp, sqrt; each twice at most)
        small = (8 * (q * d + 2 * q) + p * q + 6 * p) * f64
        bound = factor + w + inputs + data_terms + small
        assert factor <= got['saved'] <= bound, (got['saved'], bound)
        ref_g = jax.grad(lik.neglpost_full)(free, jdata)
        _check_grads(got['grad'], ref_g, 1e-7, 1e-9)


class TestNShardedRepLoss:
    @pytest.mark.parametrize('n', [20, 21])     # 21: padded to 24
    def test_matches_single_device(self, group, n):
        data, jdata, free = _rep_problem(n=n)
        got = _first(group.run(tasks.loss_value, ('n', 4), data,
                               _np_free(free)))
        np.testing.assert_allclose(got, float(lik.neglpost_rep(free, jdata)),
                                   rtol=1e-10)

    def test_gradient_matches(self, group):
        data, jdata, free = _rep_problem(n=24, seed=1)
        v, g = _vg(group, ('n', 4), data, free)
        ref_v, ref_g = jax.value_and_grad(lik.neglpost_rep)(free, jdata)
        np.testing.assert_allclose(v, float(ref_v), rtol=1e-10)
        _check_grads(g, ref_g, 1e-7, 1e-9)

    def test_fast_jitter_path(self, group):
        data, jdata, free = _rep_problem(n=32, seed=2)
        got = _first(group.run(tasks.loss_value, ('n', 4), data,
                               _np_free(free), compute_dtype='float32',
                               jitter=1e-6))
        ref = float(lik.neglpost_rep(free, jdata, compute_dtype=jnp.float32,
                                     jitter=1e-6))
        np.testing.assert_allclose(got, ref, rtol=2e-4)


def _xy(n=28, d=2, p=5, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = np.vstack([np.sin(3 * x[:, 0]), np.cos(2 * x[:, 1]),
                   x[:, 0] * x[:, 1], x.sum(1), (x ** 2).sum(1)])
    return x, y + 0.05 * rng.standard_normal((p, n))


class TestNShardEndToEnd:
    def test_predict_parity_full(self, group):
        x, y = _xy()
        x0 = np.random.default_rng(1).uniform(0, 1, (9, 2))
        m0 = lcgp_tpu.LCGP(y=y, x=x, q=3)
        m0.fit(method='scipy', maxiter=25)
        got = _first(group.run(tasks.model, ('n', 4), x, y, dict(q=3), [
            ('set_free', _np_free(m0._free)), ('set_mesh', None),
            ('predict', x0), ('loss', None)]))
        for r, g in zip(m0.predict(x0), got[2]):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-9,
                                       atol=1e-12)
        np.testing.assert_allclose(got[3], float(m0.loss()), rtol=1e-10)

    def test_predict_parity_rep(self, group):
        xtr, ytr, xte, _ = lcgp_tpu.datasets.make_rep_data_skewed(seed=42)
        m0 = lcgp_tpu.LCGP(y=ytr, x=xtr, q=3, submethod='rep')
        m0.fit(method='scipy', maxiter=25)
        got = _first(group.run(tasks.model, ('n', 4), xtr, ytr,
                               dict(q=3, submethod='rep'), [
            ('set_free', _np_free(m0._free)), ('set_mesh', None),
            ('predict', xte), ('loss', None)]))
        for r, g in zip(m0.predict(xte), got[2]):
            np.testing.assert_allclose(g, np.asarray(r), rtol=1e-9,
                                       atol=1e-12)
        np.testing.assert_allclose(got[3], float(m0.loss()), rtol=1e-10)

    def test_fit_through_api(self, group):
        x, y = _xy(seed=3)
        l0, fit, l1, acc, free = _first(group.run(
            tasks.model, ('n', 4), x, y, dict(q=3), [
                ('loss', None), ('fit', dict(method='scipy', maxiter=30)),
                ('loss', None), ('accessors', None), ('free', None)]))
        assert l1 < l0
        assert fit['nit'] > 0
        assert acc['CinvMs'].shape == (3, x.shape[0])
        assert acc['LBs'].shape == (3, x.shape[0], x.shape[0])
        # the factor against the single-device aux at the same parameters
        m2 = lcgp_tpu.LCGP(y=y, x=x, q=3)
        m2._free = P.FreeParams(*map(jnp.asarray, free))
        m2._params_version += 1
        np.testing.assert_allclose(acc['LBs'], np.asarray(m2.LBs),
                                   rtol=1e-9, atol=1e-12)

    def test_save_on_mesh_writes_once_and_loads(self, group, tmp_path):
        # a collective: the mesh's first rank writes, every rank waits
        x, y = _xy(seed=5)
        path = tmp_path / 'mesh_model.npz'
        _, _, free = _first(group.run(tasks.model, ('n', 4), x, y,
                                      dict(q=3), [
            ('set_mesh', None), ('save', str(path)), ('free', None)]))
        m = lcgp_tpu.LCGP.load(str(path))
        for a, b in zip(m._free, free):
            np.testing.assert_array_equal(np.asarray(a), b)

    def test_bad_mesh_axis_names(self, group):
        x, y = _xy(seed=4)
        got = _first(group.run(tasks.refusals, ('n', 4), x, y))
        assert got[3][0] == 'ValueError' and 'axis names' in got[3][1]
        assert got[4][0] == 'ValueError' and 'axis names' in got[4][1]


def _aux_predict(group, spec, data, free, x0s):
    return _first(group.run(tasks.aux_and_predict, spec, data,
                            _np_free(free), x0s))


class TestNShardAuxPredict:
    def test_aux_matches_single_device(self, group):
        data, jdata, free = _full_problem(q=3, p=6, n=26, d=2, seed=11)
        x0s = np.random.default_rng(0).uniform(0, 1, (3, 2))
        got = _aux_predict(group, ('n', 4), data, free, x0s)
        ref = pred.compute_aux_full(free, jdata)
        n = data['xs'].shape[0]
        np.testing.assert_allclose(got['u'][:, :n], np.asarray(ref.CinvM),
                                   rtol=1e-9, atol=1e-12)
        np.testing.assert_allclose(got['L'][:, :n, :n], np.asarray(ref.LB),
                                   rtol=1e-9, atol=1e-12)

    def test_predict_core_matches(self, group):
        data, jdata, free = _full_problem(q=3, p=6, n=26, d=2, seed=12)
        x0s = np.random.default_rng(13).uniform(0, 1, (7, 2))
        got = _aux_predict(group, ('n', 4), data, free, x0s)
        ref = pred.compute_aux_full(free, jdata)
        ghat, gvar = pred.predict_full_core(free, jdata, ref,
                                            jnp.asarray(x0s))
        np.testing.assert_allclose(got['ghat'], np.asarray(ghat), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got['gvar'], np.asarray(gvar), rtol=1e-8,
                                   atol=1e-11)


class TestNShardMixedAux:
    def test_mixed_predict_bitwise_high_on_mesh(self, group):
        """The distributed aux stays f64 under precision='mixed': a mixed
        model's mesh predictions equal the 'high' mesh model's exactly."""
        rng = np.random.default_rng(7)
        x = rng.uniform(0, 1, (24, 2))
        y = rng.standard_normal((4, 24))
        x0 = rng.uniform(0, 1, (6, 2))
        hi = lcgp_tpu.LCGP(y=y, x=x, q=3, precision='high')
        steps = [('set_free', _np_free(hi._free)), ('set_mesh', None),
                 ('predict', x0)]
        ph = _first(group.run(tasks.model, ('n', 4), x, y,
                              dict(q=3, precision='high'), steps))[2]
        pm = _first(group.run(tasks.model, ('n', 4), x, y,
                              dict(q=3, precision='mixed'), steps))[2]
        for u, v in zip(pm, ph):
            np.testing.assert_array_equal(u, v)


class TestNCMesh:
    """The 2-D ('comp','n') mesh, including 'comp' sizes that do not
    divide q (the neutral-component padding)."""

    @pytest.mark.parametrize('nc,nn', [(2, 2), (4, 1), (1, 4)])
    def test_full_loss_and_grad_parity(self, group, nc, nn):
        data, jdata, free = _full_problem(q=3, p=6, n=24, d=2, seed=3)
        v, g = _vg(group, ('nc', nc, nn), data, free)
        ref_v, ref_g = jax.value_and_grad(lik.neglpost_full)(free, jdata)
        np.testing.assert_allclose(v, float(ref_v), rtol=1e-12)
        _check_grads(g, ref_g, 1e-9, 1e-11)

    @pytest.mark.parametrize('nc,nn', [(2, 2), (4, 1)])
    def test_rep_loss_and_grad_parity(self, group, nc, nn):
        data, jdata, free = _rep_problem(q=3, p=6, n=21, d=2, seed=4)
        v, g = _vg(group, ('nc', nc, nn), data, free)
        ref_v, ref_g = jax.value_and_grad(lik.neglpost_rep)(free, jdata)
        np.testing.assert_allclose(v, float(ref_v), rtol=1e-12)
        _check_grads(g, ref_g, 1e-9, 1e-11)

    def test_divisible_q_no_padding(self, group):
        data, jdata, free = _full_problem(q=4, p=8, n=24, d=2, seed=5)
        got = _first(group.run(tasks.loss_value, ('nc', 4, 1), data,
                               _np_free(free)))
        np.testing.assert_allclose(got, float(lik.neglpost_full(free, jdata)),
                                   rtol=1e-12)

    @pytest.mark.parametrize('kind', ['full', 'rep'])
    def test_predict_parity(self, group, kind):
        x0s = np.random.default_rng(6).uniform(0, 1, (7, 2))
        if kind == 'full':
            data, jdata, free = _full_problem(q=3, p=6, n=24, d=2, seed=6)
            aux_r = pred.compute_aux_full(free, jdata)
            gh_r, gv_r = pred.predict_full_core(free, jdata, aux_r,
                                                jnp.asarray(x0s))
        else:
            data, jdata, free = _rep_problem(q=3, p=6, n=24, d=2, seed=6)
            aux_r = pred.compute_aux_rep(free, jdata)
            gh_r, gv_r = pred.predict_rep_core(free, jdata, aux_r,
                                               jnp.asarray(x0s))
        got = _aux_predict(group, ('nc', 2, 2), data, free, x0s)
        np.testing.assert_allclose(got['ghat'], np.asarray(gh_r), rtol=1e-9,
                                   atol=1e-12)
        np.testing.assert_allclose(got['gvar'], np.asarray(gv_r), rtol=1e-8,
                                   atol=1e-11)

    def test_fit_through_api(self, group):
        rng = np.random.default_rng(7)
        x = rng.uniform(0, 1, (24, 2))
        y = rng.standard_normal((5, 24))
        x0 = rng.uniform(0, 1, (5, 2))
        _, yp, free = _first(group.run(tasks.model, ('nc', 2, 2), x, y,
                                       dict(q=3), [
            ('fit', dict(method='adam', steps=6, learning_rate=1e-2)),
            ('predict', x0), ('free', None)]))
        single = lcgp_tpu.LCGP(y=y, x=x, q=3)
        single._free = P.FreeParams(*map(jnp.asarray, free))
        single._params_version += 1
        np.testing.assert_allclose(yp[0], np.asarray(single.predict(x0)[0]),
                                   rtol=1e-8, atol=1e-10)

    @pytest.mark.parametrize('kind', ['full', 'rep'])
    def test_parity_accessors_trim_q_padding(self, group, kind):
        rng = np.random.default_rng(11)
        n, p, q = 24, 6, 3
        x = rng.uniform(0, 1, (n, 2))
        if kind == 'full':
            y = rng.standard_normal((p, n))
            ctor = dict(q=q)
        else:
            x = np.repeat(x, 2, axis=0)
            y = rng.standard_normal((p, 2 * n))
            ctor = dict(q=q, submethod='rep')
        single = lcgp_tpu.LCGP(y=y, x=x, **ctor)
        _, acc = _first(group.run(tasks.model, ('nc', 2, 2), x, y, ctor, [
            ('set_mesh', None), ('accessors', None)]))
        assert acc['CinvMs'].shape == (q, n)
        np.testing.assert_allclose(acc['CinvMs'], np.asarray(single.CinvMs),
                                   rtol=1e-9, atol=1e-12)
        if kind == 'full':
            assert acc['LBs'].shape == (q, n, n)
            np.testing.assert_allclose(acc['Ths'], np.asarray(single.Ths),
                                       rtol=1e-7, atol=1e-9)
        else:
            assert acc['LTs'].shape == (q, n, n)
            np.testing.assert_allclose(acc['Tks'], np.asarray(single.Tks),
                                       rtol=1e-8, atol=1e-10)

    def test_fast_dtype_parity(self, group):
        data, jdata, free = _full_problem(q=3, p=6, n=24, d=2, seed=9)
        got = _first(group.run(tasks.loss_value, ('nc', 2, 2), data,
                               _np_free(free), compute_dtype='float32',
                               jitter=1e-6))
        ref = lik.neglpost_full(free, jdata, compute_dtype=jnp.float32,
                                jitter=1e-6)
        np.testing.assert_allclose(got, float(ref), rtol=2e-5)


def test_dryrun_multichip():
    """The port's dryrun: every mesh mode this package has on 2 gloo CPU
    ranks (the ('comp','n') modes need 4), each against one device."""
    got = dryrun.dryrun_multichip(2, device='cpu')
    assert got['modes'] == ['comp_out', 'n', 'fitc_n']
