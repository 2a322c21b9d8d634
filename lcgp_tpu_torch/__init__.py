"""lcgp_tpu_torch — Latent Component Gaussian Processes in PyTorch.

The PyTorch/CUDA port of ``lcgp_tpu``.  Implemented so far: the full and
replication paths (``submethod='full'`` and ``'rep'``), every precision
(``'high'``, ``'mixed'``, ``'fast'``, ``'auto'``), the three kernels
(``kernel='matern32'``, ``'matern52'``, ``'rbf'``) — construction,
``loss()`` and its gradient, ``fit`` (scipy L-BFGS-B, Adam, the on-device
L-BFGS, hybrid, checkpoints), ``predict`` (with ``batch_size`` and
``return_fullcov``), the aux accessors and npz ``save``/``load`` compatible
with ``lcgp_tpu.LCGP``.  On CUDA every Gram build runs the kernel's
hand-written CUDA kernel (``csrc/matern32_gram.cu``,
``csrc/matern52_gram.cu``, ``csrc/rbf_gram.cu``) and the gradient's Gram
VJP its VJP kernel (``csrc/*_gram_vjp.cu``), compiled on first use.
"""
from . import config  # noqa: F401  (switches TF32 off)
from .models.lcgp import LCGP
from .ops.matern import Matern32

__all__ = ["LCGP", "Matern32"]
