"""Experiment run harness (counterpart of the JAX package's ``runner.py``;
behavioral spec: reference docs/call_model.py).

``LCGPRun`` wraps define/train/predict around a data dict, the same shape
the reference's illustration scripts use, and returns NumPy arrays on the
host.  The model lives on ``device`` (``'cuda'`` by default).
"""
from __future__ import annotations

import torch

from . import evaluation as _ev
from .models.lcgp import LCGP


class SuperRun:
    def __init__(self, runno: str, data, verbose: bool = False, **kwargs):
        self.data = data
        self.xtrain = data['xtrain']
        self.ytrain = data['ytrain']
        self.xtest = data['xtest']
        self.ytest = data.get('ytest')
        if 'ytrue' in data:
            self.ytrue = data['ytrue']
        if 'ystd' in data:
            self.ystd = data['ystd']
        self.runno = runno
        self.model = None
        self.modelname = ''
        self.n = self.xtrain.shape[0]
        self.num_output = self.ytrain.shape[0]
        self.verbose = verbose

    def define_model(self):
        pass

    def train(self):
        pass

    def predict(self):
        pass


def _host(t):
    """A model output as a NumPy array on the host (None stays None)."""
    if t is None:
        return None
    return t.detach().cpu().numpy() if isinstance(t, torch.Tensor) else t


class LCGPRun(SuperRun):
    def __init__(self, submethod: str = 'full', robust: bool = True,
                 err_struct=None, num_latent=None, var_threshold=None,
                 precision: str = 'high', device='cuda', **kwargs):
        super().__init__(**kwargs)
        self.modelname = 'LCGP'
        self.num_latent = num_latent
        self.var_threshold = var_threshold
        self.submethod = submethod
        self.robust = robust
        self.err_struct = err_struct
        self.precision = precision
        self.device = device
        if self.robust:
            self.modelname += '_robust'

    def define_model(self):
        self.model = LCGP(y=self.ytrain, x=self.xtrain,
                          parameter_clamp_flag=False,
                          q=self.num_latent,
                          var_threshold=self.var_threshold,
                          diag_error_structure=self.err_struct,
                          robust_mean=self.robust,
                          submethod=self.submethod,
                          precision=self.precision,
                          device=self.device)

    def train(self, **fit_kwargs):
        self.model.fit(verbose=self.verbose, **fit_kwargs)

    def predict(self, train: bool = False, return_fullcov: bool = False,
                as_pxn: bool = False):
        xtest = self.xtrain if train else self.xtest
        out = self.model.predict(xtest, return_fullcov=return_fullcov)
        arrays = [_host(o) for o in out]
        if as_pxn:
            arrays = [a.T if a is not None and a.ndim == 2 else a
                      for a in arrays]
        return tuple(arrays)


# ---------------------------------------------------------------------------
# Harness metric variants (behavioral spec: docs/call_model.py:89-126).
# The reference duplicates its metric formulas in the harness with slightly
# different semantics; here they are thin parameterizations of the port's
# evaluation module (the single implementation).
# ---------------------------------------------------------------------------

rmse = _ev.rmse


def normalized_rmse(ytrue, yhat, method: str = 'range'):
    """Per-output-normalized RMSE, averaged over outputs."""
    return _ev.normalized_rmse(ytrue, yhat, method=method,
                               aggregate='mean_per_output')


def intervalstats(ytrue, mean, var, z: float = 1.96):
    """Nominal-z predictive interval coverage/width.  Use confvar when
    comparing to noise-free truth."""
    return _ev.intervalstats(ytrue, mean, var, z=z)


def dss(ytrue, mean, var, use_diag: bool = True):
    """Mean-aggregated (per-entry) Gaussian Dawid-Sebastiani score."""
    return _ev.dss(ytrue, mean, var, use_diag=use_diag,
                   aggregate='per_entry', var_floor=1e-12)
