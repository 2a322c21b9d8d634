"""lcgp_tpu_torch — Latent Component Gaussian Processes in PyTorch.

The PyTorch/CUDA port of ``lcgp_tpu``.  Implemented so far: the full and
replication paths (``submethod='full'`` and ``'rep'``), every precision
(``'high'`` float64, ``'mixed'``, ``'fast'`` float32, ``'auto'``), the
three kernels (``kernel='matern32'``, ``'matern52'``, ``'rbf'``), and the
FITC inducing-point approximation (``inducing=``, ``n_chunk=``,
``refine_inducing``) — construction, ``loss()`` and its gradient, ``fit``
(scipy L-BFGS-B, Adam, the on-device L-BFGS, hybrid, checkpoints),
``predict`` (with ``batch_size`` and ``return_fullcov``), the aux accessors,
npz ``save``/``load`` compatible with ``lcgp_tpu.LCGP``, the evaluation
metrics and ``utils.diagnostics.health_check``; the prediction server
(``serve.PredictServer``, ``python -m lcgp_tpu_torch.serve model.npz``) on
captured CUDA graphs; ``datasets``, ``runner``, ``utils.profiling`` and
``test()``; and the multi-device paths over ``torch.distributed``
(``parallel``: the ('comp','out'), ('n',) and ('comp','n') meshes,
``fit(mesh=...)`` and ``LCGP.set_mesh``).  On CUDA every Gram build
runs the kernel's hand-written CUDA kernel (``csrc/matern32_gram.cu``,
``csrc/matern52_gram.cu``, ``csrc/rbf_gram.cu``), a gradient's Gram VJP
its VJP kernel (``csrc/*_gram_vjp.cu``) and a gradient in the inducing
points K5 (``csrc/gram_vjp_x.cu``), compiled on first use.
"""
from . import config  # noqa: F401  (switches TF32 off)
from . import datasets
from . import evaluation
from .models.lcgp import LCGP
from .ops.matern import Matern32
from .test import test

# The version from the installed distribution's metadata when available
# (reference src/lcgp/__init__.py:5-11); the source tree's pyproject value
# when running uninstalled.
try:
    from importlib.metadata import PackageNotFoundError, version
    __version__ = version('lcgp-tpu')
except PackageNotFoundError:
    __version__ = '0.1.0'
__all__ = ['LCGP', 'Matern32', 'test', 'evaluation', 'datasets', '__version__']
