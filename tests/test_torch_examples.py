"""The port's examples (``examples/torch_*.py``) on the CPU, each against
lcgp_tpu's run of the original example's computation in the same test.

Every example exposes ``main(argv) -> dict`` of its metrics and runs here
with ``--cpu``.  Stated tolerances: the metrics within
``examples/check_notebook_fresh.py``'s TOLERANCES of lcgp_tpu's (the
notebook check against ``examples/notebook_metrics.json``, its own
comparison); the fitted noise std within 0.01; rep-3d's transform check
within 1e-10.  The multichip demo runs on one 4-rank gloo ``WorkerGroup``
for the module with its steps cut to 3: the sharded loss within 1e-9
(relative) of one device's and of lcgp_tpu's single-device loss, its
gradient within 1e-7 of each leaf's largest entry, the sharded Adam fit
within 1e-6 of one device's Adam, each mesh's predictions within 1e-7 of
one device's at the same parameters.
"""
import importlib.util
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

import lcgp_tpu
from lcgp_tpu import datasets as jdatasets
from lcgp_tpu import evaluation as jev
from lcgp_tpu.runner import LCGPRun as JRun
from lcgp_tpu_torch.parallel import WorkerGroup

torch.set_num_threads(1)  # pytest -n workers share the host's cores

EXAMPLES = Path(__file__).resolve().parents[1] / 'examples'
PORTED = ('check_notebook_fresh', 'rep_1d_illustration',
          'rep_3d_illustration', 'borehole_field', 'multichip_sharded')
TOLERANCES = dict(rmse=0.02, nrmse=0.02, coverage=0.03, width=0.02,
                  dss=0.5)
NOISE = (0.05, 0.08, 0.10)


def _example(name):
    """examples/torch_<name>.py as a module."""
    path = EXAMPLES / f'torch_{name}.py'
    spec = importlib.util.spec_from_file_location(f'torch_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _within(got, ref, keys=tuple(TOLERANCES)):
    for k in keys:
        if k in ref:
            assert abs(got[k] - ref[k]) <= TOLERANCES[k], (k, got[k], ref[k])


def _jax_metrics(ytrue, ypred, var, dss=True):
    cover, width = jev.intervalstats(ytrue, ypred, var)
    out = dict(rmse=float(jev.rmse(ytrue, ypred)),
               nrmse=float(jev.normalized_rmse(ytrue, ypred)),
               coverage=float(cover), width=float(width))
    if dss:
        out['dss'] = float(jev.dss(ytrue, ypred, var, use_diag=True))
    return out


@pytest.mark.parametrize('name', PORTED)
def test_example_imports_no_jax(name):
    src = (EXAMPLES / f'torch_{name}.py').read_text()
    assert not re.search(r'^\s*(import|from)\s+jax\b', src, re.M)
    assert not re.search(r'^\s*(import|from)\s+lcgp_tpu\b(?!_torch)', src,
                         re.M)
    assert 'def main(argv=None' in src and "'--cpu'" in src


def test_reference_metrics_file_names_its_commands():
    ref = json.loads((EXAMPLES / 'torch_reference_metrics.json').read_text())
    assert set(ref['commands']) <= set(ref)
    assert ref['tolerances'] == TOLERANCES


def test_notebook_check_on_the_cpu():
    got = _example('check_notebook_fresh').main(['--cpu'])
    assert got['failures'] == []
    want = json.loads((EXAMPLES / 'notebook_metrics.json').read_text())
    _within(got, want)


def _jax_rep_1d_uniform():
    x, y, xt, yt = jdatasets.make_rep_data_1d(
        n_unique=16, rep_choices=(1, 2, 3, 4, 5), noise_std=NOISE, seed=2025)
    m = lcgp_tpu.LCGP(y=y, x=x, submethod='rep',
                      diag_error_structure=[1, 1, 1])
    m.fit()
    ypred, ypredvar, _ = map(np.asarray, m.predict(xt))
    out = _jax_metrics(yt, ypred, ypredvar)
    out['fitted_noise_std'] = np.sqrt(np.exp(np.asarray(m.lsigma2s)))
    return out


def _jax_rep_3d_uniform():
    x, y, xt, yt = jdatasets.make_rep_data_1d(
        n_unique=16, rep_choices=(1, 2, 3, 4, 5), noise_std=NOISE, seed=2025)
    run = JRun(runno='rep_3d_uniform',
               data=dict(xtrain=x, ytrain=y, xtest=xt, ytest=yt, ytrue=yt),
               num_latent=3, submethod='rep', err_struct=[1, 1, 1],
               robust=True)
    run.define_model()
    run.train()
    mean, _, confvar = run.predict()
    out = _jax_metrics(yt, np.asarray(mean), np.asarray(confvar))
    out['fitted_noise_std'] = np.sqrt(np.exp(np.asarray(
        run.model.get_param()[2])))
    return out


def _jax_borehole_small():
    x, y = jdatasets.make_borehole_field(n=200, p=20, seed=0)
    xte, yte, xtr, ytr = x[-40:], y[:, -40:], x[:-40], y[:, :-40]
    m = lcgp_tpu.LCGP(y=ytr, x=xtr, q=5, precision='high')
    m.fit(method='scipy')
    ypred, ypredvar, _ = map(np.asarray, m.predict(xte))
    return _jax_metrics(yte, ypred, ypredvar, dss=False)


@pytest.mark.parametrize('name,argv,pick,reference', [
    ('rep_1d_illustration', ['--cpu', '--case', 'uniform'],
     lambda r: r['uniform'], _jax_rep_1d_uniform),
    ('rep_3d_illustration', ['--cpu', '--case', 'uniform'],
     lambda r: r['uniform'], _jax_rep_3d_uniform),
    ('borehole_field', ['--cpu', '--n', '200', '--p', '20'],
     lambda r: r, _jax_borehole_small),
])
def test_example_matches_the_reference_run(name, argv, pick, reference):
    got = pick(_example(name).main(argv))
    ref = reference()
    _within(got, ref)
    if 'fitted_noise_std' in ref:
        np.testing.assert_allclose(got['fitted_noise_std'],
                                   ref['fitted_noise_std'], rtol=0,
                                   atol=0.01)
    if 'transform_check_max_abs' in got:
        assert got['transform_check_max_abs'] <= 1e-10


@pytest.fixture(scope='module')
def group():
    with WorkerGroup(4, device='cpu', backend='gloo') as g:
        yield g


def test_multichip_demo_on_four_cpu_ranks(group):
    got = _example('multichip_sharded').main(['--steps', '3'], group=group)
    assert got['sharded_loss_rel'] <= 1e-9
    assert got['sharded_grad_rel'] <= 1e-7
    assert got['adam_loss_rel'] <= 1e-6
    for k in ('n_predict_rel', 'fitc_predict_rel', 'nc_predict_rel'):
        assert got[k] <= 1e-7, (k, got[k])
    # the demo's data, through lcgp_tpu on one device
    rng = np.random.default_rng(0)
    x = rng.uniform(0, 1, (256, 4))
    y = (np.sin(2 * np.pi * np.linspace(0, 1, 16))[:, None] * x[:, 0][None]
         + 0.1 * rng.standard_normal((16, 256)))
    want = float(lcgp_tpu.LCGP(y=y, x=x, q=4).loss())
    assert abs(got['sharded_loss'] - want) <= 1e-9 * abs(want)
