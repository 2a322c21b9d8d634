"""Optimizers over the free parameters (counterpart of ``lcgp_tpu/fit``):
scipy L-BFGS-B (:func:`minimize_lbfgs`), Adam (:func:`minimize_adam`) and
the port of the JAX package's on-device optax L-BFGS
(:func:`minimize_lbfgs_jax`, ``fit(method='lbfgs-jax')``).
"""
from .adam import DeviceFitResult, PlateauTracker, minimize_adam
from .lbfgs import minimize_lbfgs_jax
from .scipy_lbfgs import FitResult, minimize_lbfgs

__all__ = ["minimize_lbfgs", "FitResult", "minimize_adam",
           "minimize_lbfgs_jax", "DeviceFitResult", "PlateauTracker"]
