"""The port's prediction server (``lcgp_tpu_torch/serve.py``) on the CPU.

Every behaviour of ``tests/test_serve.py`` (the JAX package's server) has a
case here, on the port's models with ``device='cpu'``, where the fused step
runs eagerly (the CUDA-graph path is held in ``tests/test_torch_gpu.py`` and
``chip_smoke.py`` phase 12).  Stated tolerances: the server against the
model it serves rtol 1e-10 (atol 1e-12 where an output can be ~0), as the
JAX tests hold theirs; HTTP answers rtol 1e-8 (JSON round trip).

Parity with the reference: the same (y, x) and free parameters (and the
same inducing set) go through ``lcgp_tpu``'s ``PredictServer`` and the
port's, full, rep and FITC: predictions within rtol 1e-9, atol 1e-12
(``tests/test_torch_predict.py``'s ``PRED_TOL``), fullcov within rtol 1e-8,
atol 1e-12.

The coalescing test counts the dispatches the dispatcher really makes, by
wrapping the function it reads at each dispatch (``_live``); the JAX test
replaces an attribute the dispatcher never reads, so it checks nothing.
"""
import json
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

import lcgp_tpu
from lcgp_tpu.serve import PredictServer as JPredictServer
from lcgp_tpu_torch import LCGP, convert, datasets
from lcgp_tpu_torch import serve as serve_mod
from lcgp_tpu_torch.serve import PredictServer

torch.set_num_threads(1)  # pytest -n workers share the host's cores

SRV_RTOL = 1e-10
HTTP_RTOL = 1e-8
PRED_TOL = dict(rtol=1e-9, atol=1e-12)
FULLCOV_TOL = dict(rtol=1e-8, atol=1e-12)


def _np(a):
    return a.detach().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


def _model_out(m, x0, **kw):
    return [None if o is None else _np(o) for o in m.predict(x0, **kw)]


def _post(url, payload, timeout=60):
    req = urllib.request.Request(
        url, data=payload if isinstance(payload, bytes)
        else json.dumps(payload).encode(),
        headers={'Content-Type': 'application/json'})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return json.load(r)


def _http_code(url, payload):
    with pytest.raises(urllib.error.HTTPError) as ei:
        _post(url, payload, timeout=30)
    return ei.value.code


def _rep_model(seed=21, fit=True, **fit_kw):
    xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=seed)
    m = LCGP(y=ytr, x=xtr, q=3, submethod='rep', device='cpu')
    if fit:
        m.fit(**(fit_kw or dict(method='scipy', maxiter=60)))
    return m


@pytest.fixture(scope='module')
def fitted_model():
    return _rep_model()


@pytest.fixture
def server_of():
    """A factory of servers that shuts every one down after the test."""
    made = []

    def make(*args, **kw):
        kw.setdefault('device', 'cpu')
        srv = PredictServer(*args, **kw)
        made.append(srv)
        return srv
    yield make
    for srv in made:
        srv.shutdown()
        assert not srv._dispatcher.is_alive()


def _full_model(seed, n=20, d=1, p=3, q=2, fit_iters=None):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 1, (n, d))
    y = rng.standard_normal((p, n))
    m = LCGP(y=y, x=x, q=q, device='cpu')
    if fit_iters:
        m.fit(maxiter=fit_iters)
    return m


# ---------------------------------------------------------------------------
# tests/test_serve.py's behaviours, on the port
# ---------------------------------------------------------------------------


class TestPredictServer:
    def test_predict_matches_model(self, fitted_model, server_of):
        srv = server_of(fitted_model, batch_size=32, warmup=False)
        x0 = np.linspace(0, 1, 50)[:, None]
        got = srv.predict(x0)
        ref = _model_out(fitted_model, x0)
        for g, r in zip(got, ref):
            assert isinstance(g, np.ndarray) and g.shape == (3, 50)
            np.testing.assert_allclose(g, r, rtol=SRV_RTOL)

    def test_load_from_saved(self, fitted_model, tmp_path, server_of):
        path = tmp_path / 'm.npz'
        fitted_model.save(path)
        srv = server_of(str(path), batch_size=16, warmup=True)
        assert srv.model.device.type == 'cpu'
        x0 = np.linspace(0, 1, 20)[:, None]
        np.testing.assert_allclose(srv.predict(x0)[0],
                                   _model_out(fitted_model, x0)[0],
                                   rtol=SRV_RTOL)

    def test_dim_mismatch_raises(self, fitted_model, server_of):
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        with pytest.raises(ValueError):
            srv.predict(np.zeros((4, 3)))

    def test_http_roundtrip(self, fitted_model, server_of):
        srv = server_of(fitted_model, batch_size=16, warmup=False)
        httpd, _ = srv.serve(port=0, background=True)
        base = f'http://127.0.0.1:{httpd.server_address[1]}'
        with urllib.request.urlopen(base + '/healthz', timeout=30) as r:
            assert json.load(r)['status'] == 'ok'
        with urllib.request.urlopen(base + '/info', timeout=30) as r:
            info = json.load(r)
        assert info['p'] == 3 and info['submethod'] == 'rep'
        x0 = np.linspace(0, 1, 10)[:, None]
        out = _post(base + '/predict', {'x': x0.tolist()})
        np.testing.assert_allclose(np.asarray(out['ypred']),
                                   _model_out(fitted_model, x0)[0],
                                   rtol=HTTP_RTOL)
        assert out['latency_s'] >= 0
        assert _http_code(base + '/predict', b'{"x": [[1, 2, 3]]}') == 400
        with pytest.raises(urllib.error.HTTPError) as ei:
            urllib.request.urlopen(base + '/nowhere', timeout=30)
        assert ei.value.code == 404

    def test_predict_after_shutdown_raises(self, fitted_model):
        srv = PredictServer(fitted_model, batch_size=8, warmup=False,
                            device='cpu')
        srv.shutdown()
        assert not srv._dispatcher.is_alive()
        with pytest.raises(RuntimeError, match='shut down'):
            srv.predict(np.zeros((2, 1)))


class TestHotReload:
    def test_param_swap_reuses_executable(self, fitted_model, server_of):
        """Same config + shapes (the periodic-refit pattern): reload must
        reuse the fused step and its state tensors and serve the new
        model's values."""
        srv = server_of(fitted_model, batch_size=16, warmup=True)
        fn, state = srv._live, srv._live.state
        x0 = np.linspace(0, 1, 20)[:, None]
        yp_old = srv.predict(x0)[0]
        m2 = _rep_model(method='adam', steps=20, learning_rate=1e-2)
        out = srv.reload(m2)
        assert out['reused_executable'] is True
        assert out['reload_count'] == 1 and out['warmup_secs'] >= 0
        assert srv._live is fn and srv._live.state is state
        yp_new = srv.predict(x0)[0]
        np.testing.assert_allclose(yp_new, _model_out(m2, x0)[0],
                                   rtol=SRV_RTOL)
        assert not np.allclose(yp_new, yp_old)
        # the reload wrote into the server's tensors, not the models'
        np.testing.assert_allclose(_model_out(fitted_model, x0)[0], yp_old,
                                   rtol=SRV_RTOL)

    def test_shape_change_recompiles(self, fitted_model, server_of):
        """New model with different n (shape change): reload still works,
        reports the step was NOT reused."""
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        fn = srv._fn
        xtr, ytr, _, _ = datasets.make_rep_data_1d(n_unique=9, seed=5)
        m2 = LCGP(y=ytr, x=xtr, q=2, submethod='rep', device='cpu')
        out = srv.reload(m2)
        assert out['reused_executable'] is False
        assert srv._fn is not fn
        x0 = np.linspace(0, 1, 7)[:, None]
        np.testing.assert_allclose(srv.predict(x0)[0],
                                   _model_out(m2, x0)[0], rtol=SRV_RTOL)

    def test_submethod_change_rebuilds(self, fitted_model, server_of):
        """Static-config change (rep -> full): the fused step is rebuilt,
        and so is fullcov's."""
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        m2 = _full_model(3)
        out = srv.reload(m2)
        assert out['reused_executable'] is False
        assert out['submethod'] == 'full'
        x0 = np.linspace(0, 1, 5)[:, None]
        np.testing.assert_allclose(srv.predict(x0)[0],
                                   _model_out(m2, x0)[0], rtol=SRV_RTOL)
        cov = srv.predict_fullcov(x0)[3]
        ref = _model_out(m2, x0, return_fullcov=True)[3]
        np.testing.assert_allclose(cov, ref, rtol=1e-8, atol=1e-12)
        # another full model of new shapes: fullcov is built again for it
        fullcov_fn = srv._fn_fullcov
        m3 = _full_model(4, n=23, p=4)
        assert srv.reload(m3)['reused_executable'] is False
        assert srv._fn_fullcov is None
        np.testing.assert_allclose(
            srv.predict_fullcov(x0)[3],
            _model_out(m3, x0, return_fullcov=True)[3], rtol=1e-8,
            atol=1e-12)
        assert srv._fn_fullcov is not fullcov_fn

    def test_d_mismatch_rejected(self, fitted_model, server_of):
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        m2 = _full_model(4, n=15, d=2)
        with pytest.raises(ValueError, match='d mismatch'):
            srv.reload(m2)

    def test_http_reload_disabled_by_default(self, fitted_model, server_of):
        """Without reload_dir=, POST /reload is a 403 (unauthenticated
        endpoint loading client-named paths must be opt-in)."""
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        httpd, _ = srv.serve(port=0, background=True)
        url = f'http://127.0.0.1:{httpd.server_address[1]}/reload'
        assert _http_code(url, {'path': 'm.npz'}) == 403

    def test_http_reload(self, fitted_model, tmp_path, server_of):
        """POST /reload with a saved-model path inside reload_dir swaps
        the served model; a missing or corrupt file is a JSON 400, a path
        escaping reload_dir a 403."""
        srv = server_of(fitted_model, batch_size=8, warmup=False,
                        reload_dir=str(tmp_path))
        httpd, _ = srv.serve(port=0, background=True)
        base = f'http://127.0.0.1:{httpd.server_address[1]}'
        m2 = _rep_model(method='adam', steps=10, learning_rate=1e-2)
        path = tmp_path / 'm2.npz'
        m2.save(path)
        out = _post(base + '/reload', {'path': str(path)}, timeout=120)
        assert out['reused_executable'] is True
        assert srv.model.device.type == 'cpu'
        x0 = np.linspace(0, 1, 6)[:, None]
        got = np.asarray(_post(base + '/predict', {'x': x0.tolist()})['ypred'])
        np.testing.assert_allclose(got, _model_out(m2, x0)[0],
                                   rtol=HTTP_RTOL)
        assert _http_code(base + '/reload',
                          b'{"path": "nonexistent.npz"}') == 400
        (tmp_path / 'corrupt.npz').write_bytes(b'not a zipfile')
        assert _http_code(base + '/reload', b'{"path": "corrupt.npz"}') == 400
        assert _http_code(base + '/reload',
                          b'{"path": "../escape.npz"}') == 403
        assert srv.info()['reload_count'] == 1

    def test_fit_on_model_does_not_reach_server_until_reload(self,
                                                             server_of):
        """The server predicts from its own copy of the state: a later fit
        on the served model object changes nothing until reload."""
        m = _rep_model(seed=23, fit=False)
        srv = server_of(m, batch_size=16, warmup=False)
        x0 = np.linspace(0, 1, 11)[:, None]
        before = srv.predict(x0)
        m.fit(method='adam', steps=15, learning_rate=1e-2)
        after_fit = _model_out(m, x0)
        assert not np.allclose(after_fit[0], before[0])
        for g, r in zip(srv.predict(x0), before):
            np.testing.assert_array_equal(g, r)
        assert srv.reload(m)['reused_executable'] is True
        for g, r in zip(srv.predict(x0), after_fit):
            np.testing.assert_allclose(g, r, rtol=SRV_RTOL)

    def test_reload_is_atomic_per_request(self, fitted_model, server_of):
        """Clients fire multi-chunk requests while the model is swapped
        back and forth: no request fails, and every answer is wholly the
        old model's or wholly the new one's."""
        m2 = _rep_model(method='adam', steps=20, learning_rate=1e-2)
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        x0 = np.linspace(0, 1, 21)[:, None]          # three chunks
        refs = [_model_out(m, x0)[0] for m in (fitted_model, m2)]
        assert not np.allclose(refs[0], refs[1])
        stop = threading.Event()
        answers, errors = [], []

        def client():
            try:
                while not stop.is_set():
                    answers.append(srv.predict(x0)[0])
            except Exception as e:        # noqa: BLE001
                errors.append(e)

        old_interval = sys.getswitchinterval()
        sys.setswitchinterval(1e-5)
        try:
            threads = [threading.Thread(target=client) for _ in range(6)]
            for t in threads:
                t.start()
            for m in (m2, fitted_model, m2, fitted_model):
                assert srv.reload(m)['reused_executable'] is True
                time.sleep(0.01)
            stop.set()
            for t in threads:
                t.join(timeout=60)
            assert not any(t.is_alive() for t in threads)
        finally:
            sys.setswitchinterval(old_interval)
        assert not errors, errors
        assert answers
        for a in answers:
            assert any(np.allclose(a, r, rtol=SRV_RTOL, atol=0)
                       for r in refs), 'an answer mixes two models'

    def test_mesh_model_raises_naming_item_17(self, fitted_model, server_of,
                                              monkeypatch):
        """A mesh model's static signature holds its mesh and selects the
        eager mesh step: an exact mesh model's latent core is the
        collective ``nshard.predict_nsharded_core`` on that mesh, run with
        no graph; a FITC mesh model keeps the replicated FITC core.  (The
        name dates from the port's refusal of a mesh model; serving one is
        ``tests/test_torch_serve_mesh.py``'s.)"""
        from lcgp_tpu_torch.parallel import nshard
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        mesh = object()

        class Meshed:
            _z = None
            _n_mesh = mesh
            _compute_dtype, _jitter = None, 0.0
            kernel, q_chunk, submethod = 'matern32', None, 'full'
            rep_standardize_ybar = True
        sig = srv._static_sig(Meshed())
        assert mesh in sig and sig != srv._static_sig(fitted_model)
        assert srv._step_collective(Meshed())
        assert not srv._step_collective(fitted_model)
        seen = []

        def mesh_core(free, data, aux, x0s, m, **kw):
            seen.append((m, kw))
            return 'ghat', 'gvar'
        monkeypatch.setattr(nshard, 'predict_nsharded_core', mesh_core)
        core = srv._latent_core(Meshed())
        assert core(dict(free=1, data=2, aux=3), 'x0s') == ('ghat', 'gvar')
        assert seen == [(mesh, dict(compute_dtype=None, jitter=0.0,
                                    kernel='matern32'))]
        Meshed._z = torch.zeros((2, 1), dtype=torch.float64)
        assert not srv._step_collective(Meshed())


class TestMicrobatching:
    def test_concurrent_clients_match_model_predict(self):
        """8 threads, request sizes 1..127: every response must equal the
        direct model.predict values (microbatcher fan-out correctness)."""
        xtr, ytr, _, _ = datasets.make_rep_data_skewed(seed=55)
        m = LCGP(y=ytr, x=xtr, q=3, submethod='rep', device='cpu')
        m.fit(method='adam', steps=30)
        srv = PredictServer(m, batch_size=64, warmup=True, device='cpu')
        rng = np.random.default_rng(0)
        sizes = [1, 3, 7, 16, 31, 64, 90, 127]
        inputs = [rng.uniform(xtr.min(), xtr.max(), (s, 1)) for s in sizes]
        expected = [_model_out(m, x) for x in inputs]
        results = [None] * len(sizes)
        errors = []

        def worker(i):
            try:
                results[i] = srv.predict(inputs[i])
            except Exception as e:       # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(len(sizes))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        srv.shutdown()
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors
        for got, exp, s in zip(results, expected, sizes):
            assert got is not None, f'request of size {s} never completed'
            for g, e in zip(got, exp):
                np.testing.assert_allclose(g, e, rtol=SRV_RTOL, atol=1e-12)

    @staticmethod
    def _count_dispatches(srv, delay):
        """Wrap the function the dispatcher reads at each dispatch; returns
        the list the wrapper appends each dispatch's batch rows to."""
        calls = []
        real_fn = srv._live

        def counting_fn(batch):
            calls.append(batch.shape[0])
            time.sleep(delay)              # widen the coalescing window
            return real_fn(batch)

        srv._live = counting_fn
        return calls

    def test_coalescing_happens(self):
        """With a slow dispatch, concurrent small requests must share
        dispatches: fewer dispatches than requests, counted on the path the
        dispatcher runs."""
        xtr, ytr, _, _ = datasets.make_rep_data_1d(n_unique=8, seed=56)
        m = LCGP(y=ytr, x=xtr, submethod='rep', device='cpu')
        srv = PredictServer(m, batch_size=32, warmup=True, device='cpu')
        calls = self._count_dispatches(srv, 0.05)
        n_req = 12
        ref = _model_out(m, np.full((2, 1), 0.5))
        results, errors = [], []

        def worker():
            try:
                results.append(srv.predict(np.full((2, xtr.shape[1]), 0.5)))
            except Exception as e:       # noqa: BLE001
                errors.append(e)

        threads = [threading.Thread(target=worker) for _ in range(n_req)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
        srv.shutdown()
        assert not errors, errors
        assert len(results) == n_req
        for got in results:
            for g, r in zip(got, ref):
                np.testing.assert_allclose(g, r, rtol=SRV_RTOL, atol=1e-12)
        assert sum(calls) == len(calls) * 32       # padded to the batch
        assert 0 < len(calls) < n_req, (len(calls), calls)

    def test_dispatch_counter_sees_every_dispatch(self):
        """The counting wrapper sits on the path that runs: requests one at
        a time give one dispatch each, and a request past the batch size
        one per chunk."""
        m = _full_model(7)
        srv = PredictServer(m, batch_size=8, warmup=False, device='cpu')
        calls = self._count_dispatches(srv, 0.0)
        fn = srv._fn
        for _ in range(3):
            srv.predict(np.full((2, 1), 0.25))
        srv.predict(np.linspace(0, 1, 20)[:, None])        # 3 chunks
        srv.shutdown()
        assert len(calls) == 6
        assert fn.calls == 6


class TestFullcovServing:
    def test_fullcov_matches_model(self, server_of):
        rng = np.random.default_rng(11)
        x = rng.uniform(0, 1, (30, 2))
        y = np.vstack([np.sin(5 * x[:, 0]), np.cos(4 * x[:, 1]),
                       x[:, 0] * x[:, 1]]) + rng.normal(0, 0.05, (3, 30))
        m = LCGP(y=y, x=x, q=3, device='cpu')     # submethod='full'
        m.fit(maxiter=30)
        srv = server_of(m, batch_size=8, warmup=False)
        x0 = rng.uniform(0, 1, (11, 2))  # exercises pad + multi-chunk
        got = srv.predict_fullcov(x0)
        ref = _model_out(m, x0, return_fullcov=True)
        assert got[3].shape == (11, 3, 3)
        for g, r in zip(got, ref):
            np.testing.assert_allclose(g, r, rtol=SRV_RTOL, atol=1e-12)

    def test_fullcov_rejected_for_rep(self, fitted_model, server_of):
        srv = server_of(fitted_model, batch_size=8, warmup=False)
        with pytest.raises(ValueError, match='full'):
            srv.predict_fullcov(np.zeros((2, 1)))

    def test_http_fullcov(self, server_of):
        rng = np.random.default_rng(12)
        x = rng.uniform(0, 1, (25, 1))
        y = np.vstack([np.sin(6 * x[:, 0]),
                       np.cos(6 * x[:, 0])]) + rng.normal(0, 0.05, (2, 25))
        m = LCGP(y=y, x=x, q=2, device='cpu')
        m.fit(maxiter=20)
        srv = server_of(m, batch_size=8, warmup=False)
        httpd, _ = srv.serve(port=0, background=True)
        out = _post(f'http://127.0.0.1:{httpd.server_address[1]}/predict',
                    {'x': x[:3].tolist(), 'fullcov': True})
        cov = np.asarray(out['yfullcov'])
        assert cov.shape == (3, 2, 2)
        np.testing.assert_allclose(
            cov, _model_out(m, x[:3], return_fullcov=True)[3],
            rtol=HTTP_RTOL, atol=1e-10)


class TestInducingServing:
    def test_serve_fitc_model(self, server_of):
        """Serving an inducing-point (FITC) model: the fused step clamps
        the variances without recording the model's clamp statistics."""
        rng = np.random.default_rng(5)
        n, d, p = 120, 2, 4
        x = rng.uniform(0, 1, (n, d))
        y = np.vstack([np.sin(4 * x[:, 0]), np.cos(3 * x[:, 1]),
                       x[:, 0] * x[:, 1], (x ** 2).sum(1)])
        y = y + 0.05 * rng.standard_normal((p, n))
        m = LCGP(y=y, x=x, q=3, inducing=16, device='cpu')
        m.fit(method='adam', steps=20)
        srv = server_of(m, batch_size=16, warmup=True)
        assert srv.info()['inducing'] == 16 and 'z' in srv._state
        x0 = rng.uniform(0, 1, (10, d))
        m._fitc_clamp_accum = None
        got = srv.predict(x0)
        assert m._fitc_clamp_accum is None
        for g, r in zip(got, _model_out(m, x0)):
            np.testing.assert_allclose(g, r, rtol=SRV_RTOL)


def test_main_serves_on_the_cpu(fitted_model, tmp_path, monkeypatch):
    """``python -m lcgp_tpu_torch.serve model.npz --cpu``: loads onto the
    CPU, warms and serves (``serve`` stubbed so it returns)."""
    path = tmp_path / 'm.npz'
    fitted_model.save(path)
    seen = {}

    def fake_serve(self, host, port):
        seen.update(host=host, port=port, device=self.model.device.type,
                    batch=self.batch_size, reload_dir=self.reload_dir)
        self.shutdown()
    monkeypatch.setattr(serve_mod.PredictServer, 'serve', fake_serve)
    serve_mod.main([str(path), '--cpu', '--port', '0', '--batch-size', '4'])
    assert seen == dict(host='127.0.0.1', port=0, device='cpu', batch=4,
                        reload_dir=None)


# ---------------------------------------------------------------------------
# parity with lcgp_tpu's PredictServer: same data, parameters, inducing set
# ---------------------------------------------------------------------------


def _parity_problem(kind, seed):
    rng = np.random.default_rng(seed)
    n, d, p, n0 = (60, 2, 5, 13) if kind == 'fitc' else (50, 3, 6, 13)
    xu = rng.uniform(0, 1, (n + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + xu[:, :1].T)) * xu[:, 1:2].T
         + np.cos(np.pi * t * xu[:, -1:].T))
    if kind == 'rep':
        reps = rng.integers(1, 4, n)
        x, y = np.repeat(xu[:n], reps, axis=0), np.repeat(f[:, :n], reps, 1)
    else:
        x, y = xu[:n], f[:, :n]
    return x, y + 0.1 * rng.standard_normal(y.shape), xu[n:]


def _parity_pair(kind, seed=0):
    """(lcgp_tpu model, the port's model with its parameters, held-out x)."""
    x, y, x0 = _parity_problem(kind, seed)
    kw = dict(submethod='rep') if kind == 'rep' else {}
    if kind == 'fitc':
        kw['inducing'] = 12
    jm = lcgp_tpu.LCGP(y, x, q=3, **kw)
    rng = np.random.default_rng(seed + 1)
    jm.set_params(lLmb=rng.uniform(0.2, 1.2, (3, x.shape[1])),
                  lLmb0=rng.uniform(0.5, 3.0, 3),
                  lnugGPs=rng.uniform(1e-6, 1e-3, 3),
                  lsigma2s=np.asarray(jm.lsigma2s) - 1.0)
    if kind == 'fitc':
        kw['inducing'] = np.asarray(jm.tx_x(jm._z))
    tm = LCGP(np.asarray(jm.y_orig), np.asarray(jm.x_orig), q=3,
              device='cpu', **kw)
    tm.free = convert.free_params_from_numpy(
        *[np.asarray(v) for v in jm._free], 'cpu')
    if kind == 'fitc':
        tm._z = convert.inducing_from_numpy(np.asarray(jm._z), 'cpu')
    return jm, tm, x0


@pytest.mark.parametrize('kind', ['full', 'rep', 'fitc'])
def test_predict_matches_jax_server(kind, server_of):
    jm, tm, x0 = _parity_pair(kind)
    jsrv = JPredictServer(jm, batch_size=8, warmup=False)
    try:
        ref = jsrv.predict(x0)
    finally:
        jsrv.shutdown()
    srv = server_of(tm, batch_size=8, warmup=False)
    got = srv.predict(x0)
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g, np.asarray(r), **PRED_TOL)


def test_fullcov_matches_jax_server(server_of):
    jm, tm, x0 = _parity_pair('full', seed=3)
    jsrv = JPredictServer(jm, batch_size=8, warmup=False)
    try:
        ref = jsrv.predict_fullcov(x0)
    finally:
        jsrv.shutdown()
    got = server_of(tm, batch_size=8, warmup=False).predict_fullcov(x0)
    for g, r in zip(got[:3], ref[:3]):
        np.testing.assert_allclose(g, np.asarray(r), **PRED_TOL)
    np.testing.assert_allclose(got[3], np.asarray(ref[3]), **FULLCOV_TOL)
