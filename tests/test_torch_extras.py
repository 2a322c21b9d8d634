"""The port's peripheral modules against lcgp_tpu's: ``datasets``,
``runner``, ``utils.profiling``, ``test()`` and the package's top level.

Stated tolerances:

- ``datasets``: every function's arrays equal lcgp_tpu's exactly, at two
  seeds;
- ``runner.LCGPRun``: a ``train(method='scipy', maxiter=5)`` ends at
  lcgp_tpu's loss within rtol 1e-8, as ``tests/test_torch_fit.py`` holds
  the same fit, and its predictions agree within rtol 1e-8, atol 1e-12;
  without a fit (the fullcov pass-through) within rtol 1e-9, atol 1e-12
  (``tests/test_torch_predict.py``'s ``PRED_TOL``);
- the harness metric variants: lcgp_tpu's values within rtol 1e-12 (the
  same NumPy formulas on the same arrays).
"""
import logging
import os

import numpy as np
import pytest
import torch

import lcgp_tpu
from lcgp_tpu import datasets as jdatasets
from lcgp_tpu import runner as jrunner
import lcgp_tpu_torch
from lcgp_tpu_torch import datasets, runner
from lcgp_tpu_torch import test as run_port_tests
from lcgp_tpu_torch.ops import _build
from lcgp_tpu_torch.utils import profiling

torch.set_num_threads(1)  # pytest -n workers share the host's cores

FIT_RTOL = 1e-8
FIT_PRED_TOL = dict(rtol=1e-8, atol=1e-12)
PRED_TOL = dict(rtol=1e-9, atol=1e-12)
METRIC_RTOL = 1e-12


# ---------------------------------------------------------------------------
# datasets
# ---------------------------------------------------------------------------


def _dataset_calls(seed):
    """name -> a function of a datasets module, called at ``seed``."""
    rng = np.random.default_rng(100 + seed)
    x4 = rng.uniform(0.5, 1.5, (20, 4))
    x1 = rng.uniform(0, 1, 30)
    x8 = rng.uniform(0, 1, (25, 8))
    return {
        'cps2001': lambda ds: ds.cps2001(
            x4, rng=np.random.default_rng(seed)),
        'forrester2008': lambda ds: ds.forrester2008(
            x1, rng=np.random.default_rng(seed)),
        'f_true_1d': lambda ds: ds.f_true_1d(x1),
        'make_rep_data_1d': lambda ds: ds.make_rep_data_1d(seed=seed),
        'make_rep_data_skewed': lambda ds: ds.make_rep_data_skewed(seed=seed),
        'make_rep_data_hotspots': lambda ds: ds.make_rep_data_hotspots(
            seed=seed),
        'borehole': lambda ds: ds.borehole(x8),
        'make_borehole_field': lambda ds: ds.make_borehole_field(
            n=40, p=12, seed=seed),
    }


@pytest.mark.parametrize('seed', [0, 7])
@pytest.mark.parametrize('name', sorted(_dataset_calls(0)))
def test_dataset_equals_jax(name, seed):
    call = _dataset_calls(seed)[name]
    got, ref = call(datasets), call(jdatasets)
    got = got if isinstance(got, tuple) else (got,)
    ref = ref if isinstance(ref, tuple) else (ref,)
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        assert isinstance(g, np.ndarray)
        assert g.dtype == r.dtype and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_forrester_clean_is_deterministic():
    x = np.linspace(0, 1, 30)
    np.testing.assert_array_equal(datasets.forrester2008(x, noisy=False),
                                  jdatasets.forrester2008(x, noisy=False))


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------


def _skewed_data():
    xtr, ytr, xte, ytrue = datasets.make_rep_data_skewed(seed=3)
    return dict(xtrain=xtr, ytrain=ytr, xtest=xte[::20], ytest=None,
                ytrue=ytrue[:, ::20])


def _runs(submethod):
    data = _skewed_data()
    tr = runner.LCGPRun(runno='t', data=data, submethod=submethod,
                        num_latent=3, device='cpu')
    jr = jrunner.LCGPRun(runno='t', data=data, submethod=submethod,
                         num_latent=3)
    tr.define_model()
    jr.define_model()
    return tr, jr


def test_runner_define_train_predict_matches_jax():
    tr, jr = _runs('rep')
    assert tr.modelname == jr.modelname == 'LCGP_robust'
    assert tr.model.device.type == 'cpu' and tr.model.submethod == 'rep'
    assert tr.ytrue.shape == jr.ytrue.shape
    tr.train(method='scipy', maxiter=5)
    jr.train(method='scipy', maxiter=5)
    np.testing.assert_allclose(float(tr.model.loss()),
                               float(jr.model.loss()), rtol=FIT_RTOL)
    for kw in ({}, {'as_pxn': True}, {'train': True}):
        got, ref = tr.predict(**kw), jr.predict(**kw)
        assert len(got) == 3
        for g, r in zip(got, ref):
            assert isinstance(g, np.ndarray)
            assert g.shape == np.asarray(r).shape
            np.testing.assert_allclose(g, np.asarray(r), **FIT_PRED_TOL)


@pytest.mark.parametrize('submethod', ['full', 'rep'])
def test_runner_fullcov_passthrough_matches_jax(submethod):
    tr, jr = _runs(submethod)
    got = tr.predict(return_fullcov=True)
    ref = jr.predict(return_fullcov=True)
    assert len(got) == len(ref) == 4
    n0 = tr.xtest.shape[0]
    if submethod == 'rep':
        assert got[3] is None and ref[3] is None
    else:
        assert got[3].shape == (n0, 3, 3)
    for g, r in zip(got, ref):
        if r is not None:
            np.testing.assert_allclose(g, np.asarray(r), **PRED_TOL)
    # as_pxn transposes the (p, n0) outputs and leaves the covariance
    t = tr.predict(return_fullcov=True, as_pxn=True)
    assert t[0].shape == (n0, 3)


def test_runner_metric_variants_match_jax():
    rng = np.random.default_rng(4)
    y = rng.standard_normal((3, 40))
    mean = y + 0.3 * rng.standard_normal((3, 40))
    var = rng.uniform(0.05, 0.5, (3, 40))
    assert runner.rmse(y, mean) == jrunner.rmse(y, mean)
    for method in ('range', 'std'):
        np.testing.assert_allclose(
            runner.normalized_rmse(y, mean, method=method),
            jrunner.normalized_rmse(y, mean, method=method),
            rtol=METRIC_RTOL)
    for z in (1.0, 1.96):
        np.testing.assert_allclose(runner.intervalstats(y, mean, var, z=z),
                                   jrunner.intervalstats(y, mean, var, z=z),
                                   rtol=METRIC_RTOL)
    var0 = var.copy()
    var0[0, 0] = 0.0                    # the harness's 1e-12 variance floor
    np.testing.assert_allclose(runner.dss(y, mean, var0),
                               jrunner.dss(y, mean, var0), rtol=METRIC_RTOL)
    with pytest.raises(ValueError):
        runner.normalized_rmse(y, mean, method='mad')


def test_superrun_hooks_are_noops():
    run = runner.SuperRun(runno='s', data=_skewed_data())
    assert run.n == run.xtrain.shape[0] and run.num_output == 3
    assert run.define_model() is None and run.train() is None
    assert run.predict() is None


# ---------------------------------------------------------------------------
# utils.profiling
# ---------------------------------------------------------------------------


def test_timed_returns_the_stats():
    x = torch.arange(1000.0, dtype=torch.float64)
    stats = profiling.timed(lambda t: torch.sum(t * t), x, iters=3)
    assert set(stats) == {'median', 'best', 'mean', 'iters'}
    assert stats['iters'] == 3 and 0 <= stats['best'] <= stats['median']
    # nested results with no CUDA tensor wait for nothing
    assert profiling._cuda_devices({'a': (x, [x])}) == set()


def test_trace_writes_a_chrome_trace(tmp_path):
    logdir = tmp_path / 'trace'
    with profiling.trace(str(logdir)) as prof:
        torch.linalg.cholesky(torch.eye(8, dtype=torch.float64) * 2.0)
    files = list(logdir.glob('trace_*.json'))
    assert len(files) == 1 and files[0].stat().st_size > 0
    assert any('cholesky' in e.key for e in prof.key_averages())


def test_log_compiles_records_builds_inside_the_block(caplog, monkeypatch,
                                                     tmp_path):
    caplog.set_level(logging.WARNING, logger='lcgp_tpu_torch.compiles')
    profiling.record_compile('outside any block', 1.0)
    assert not caplog.records
    with profiling.log_compiles() as outer:
        profiling.record_compile('a CUDA graph capture', 0.25)
        with profiling.log_compiles() as inner:
            profiling.record_compile('another capture', 0.5)
        assert inner == [('another capture', 0.5)]
    assert outer == [('a CUDA graph capture', 0.25),
                     ('another capture', 0.5)]
    assert [r.getMessage() for r in caplog.records] == [
        'Compiling a CUDA graph capture took 0.250 s',
        'Compiling another capture took 0.500 s']
    assert profiling._blocks == []

    # ops/_build.build reports its load (here of a stand-in library) once
    # per process, not on its cached calls
    class FakeLibrary:
        def __init__(self, path, build_seconds, log):
            self.path, self.build_seconds = path, build_seconds

    monkeypatch.setattr(_build, '_LIBRARY', None)
    monkeypatch.setattr(_build, 'KernelLibrary', FakeLibrary)
    monkeypatch.setattr(_build, 'BUILD_ROOT', tmp_path)
    out_dir = tmp_path / _build._source_hash()
    out_dir.mkdir()
    (out_dir / 'liblcgp_kernels.so').write_bytes(b'')
    with profiling.log_compiles() as events:
        _build.build()
        _build.build()
    assert len(events) == 1
    assert events[0][0] == (f"kernel library {out_dir / 'liblcgp_kernels.so'}"
                            " (loaded)")


# ---------------------------------------------------------------------------
# test() and the package's top level
# ---------------------------------------------------------------------------


@pytest.mark.parametrize('level', [0, 2])
def test_test_entry_runs_the_port_suite(monkeypatch, level):
    import pytest as pytest_mod
    seen = []
    monkeypatch.setattr(pytest_mod, 'main',
                        lambda args: seen.append(args) or 0)
    assert lcgp_tpu_torch.test(level) is True
    (args,) = seen
    assert args[0] == f'--verbosity={level}'
    files = args[1:]
    assert files and all(os.path.basename(f).startswith('test_torch_')
                         for f in files)
    assert os.path.abspath(__file__) in files
    monkeypatch.setattr(pytest_mod, 'main', lambda args: 1)
    assert lcgp_tpu_torch.test(level) is False


def test_test_entry_rejects_a_bad_level():
    with pytest.raises(ValueError, match='level'):
        run_port_tests(3)


def test_version_and_all_match_jax():
    assert lcgp_tpu_torch.__all__ == lcgp_tpu.__all__
    for name in lcgp_tpu_torch.__all__:
        assert hasattr(lcgp_tpu_torch, name)
    assert lcgp_tpu_torch.__version__ == lcgp_tpu.__version__
    assert isinstance(lcgp_tpu_torch.__version__, str)
    assert lcgp_tpu_torch.datasets is datasets
