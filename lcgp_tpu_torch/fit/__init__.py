"""Optimizers over the free parameters (counterpart of ``lcgp_tpu/fit``).

Ported: scipy L-BFGS-B (:func:`minimize_lbfgs`) and Adam
(:func:`minimize_adam`).  The on-device optax L-BFGS of the JAX package
(``minimize_lbfgs_jax``) and the ``hybrid`` fit wait for ROADMAP.md Queue 1
item 12.
"""
from .adam import DeviceFitResult, PlateauTracker, minimize_adam
from .scipy_lbfgs import FitResult, minimize_lbfgs

__all__ = ["minimize_lbfgs", "FitResult", "minimize_adam",
           "DeviceFitResult", "PlateauTracker"]
