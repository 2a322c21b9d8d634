"""lcgp_tpu_torch — Latent Component Gaussian Processes in PyTorch.

The PyTorch/CUDA port of ``lcgp_tpu``.  Implemented so far: the full and
replication paths (``submethod='full'`` and ``'rep'``), float64
(``precision='high'``), Matérn 3/2 — construction, ``loss()`` and its
gradient, ``fit`` (scipy L-BFGS-B, Adam, checkpoints), ``predict`` (with
``batch_size`` and ``return_fullcov``), the aux accessors and npz
``save``/``load`` compatible with ``lcgp_tpu.LCGP``.  On CUDA the Gram
builds run the hand-written kernel ``csrc/matern32_gram.cu`` and the
gradient's Gram VJP runs ``csrc/matern32_gram_vjp.cu``, both compiled on
first use.
"""
from . import config  # noqa: F401  (switches TF32 off)
from .models.lcgp import LCGP
from .ops.matern import Matern32

__all__ = ["LCGP", "Matern32"]
