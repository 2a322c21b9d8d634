"""Carry parameters and data from the JAX package to the port.

Each takes NumPy arrays: the JAX package's free (unconstrained) parameters
as ``np.asarray(model._free.<field>)`` gives them, or as the fitted-parameter
npz files under ``benchmarks/`` store them (keys lLmb, lLmb0, lsigma2s,
lnugGPs).  Nothing here imports JAX.
"""
from __future__ import annotations

import numpy as np
import torch

from .models.likelihood import FullData, RepData
from .models.params import FreeParams


def _f64(a, device) -> torch.Tensor:
    # a C-ordered copy: arrays from JAX are read-only, and arrays loaded
    # from npz files may be Fortran-ordered
    return torch.as_tensor(np.array(a, dtype=np.float64, order='C'),
                           dtype=torch.float64, device=device)


def free_params_from_numpy(lLmb, lLmb0, lsigma2s, lnugGPs,
                           device) -> FreeParams:
    """Free parameters (q,d), (q,), (n_groups,), (q,) -> the port's
    :class:`FreeParams` on ``device``."""
    return FreeParams(_f64(lLmb, device), _f64(lLmb0, device),
                      _f64(lsigma2s, device), _f64(lnugGPs, device))


def _index(a, device) -> torch.Tensor:
    return torch.as_tensor(np.array(a, dtype=np.int64), device=device)


def full_data_from_numpy(xs, ys, phi, diag_D, sigma_map, device) -> FullData:
    """Full-path training tensors -> the port's :class:`FullData`."""
    return FullData(xs=_f64(xs, device),
                    ys=_f64(ys, device), phi=_f64(phi, device),
                    diag_D=_f64(diag_D, device),
                    sigma_map=_index(sigma_map, device))


def inducing_from_numpy(z, device) -> torch.Tensor:
    """The JAX package's inducing set, standardized (``np.asarray(
    model._z)``, (m, d)) -> the port's ``LCGP._z`` on ``device``."""
    return _f64(z, device)


def rep_data_from_numpy(xs, ybar, scale, r, phi, diag_D, sigma_map,
                        device) -> RepData:
    """Rep-path training tensors (the fields of the JAX package's
    ``RepData``, in its order) -> the port's :class:`RepData`."""
    return RepData(xs=_f64(xs, device), ybar=_f64(ybar, device),
                   scale=_f64(scale, device), r=_f64(r, device),
                   phi=_f64(phi, device), diag_D=_f64(diag_D, device),
                   sigma_map=_index(sigma_map, device))
