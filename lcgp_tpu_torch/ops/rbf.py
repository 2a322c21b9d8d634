"""Squared-exponential (ARD RBF) kernel, batched over latent components
(counterpart of ``lcgp_tpu/ops/rbf.py``).

    C0 = exp(-0.5 * sum_j ((x1_j - x2_j) / l_j)^2)

with the reference's nugget and amplitude rules, as for Matérn 3/2:
``amp * ((1-eta) C0 + eta I)`` when x1 and x2 are the same points,
``amp * (1-eta) C0`` for cross-covariances; the prior variance is ``amp``
(``matern32_diag``).

The functions are the ``'rbf'`` family's of ``ops/launch.py``:
:func:`rbf_gram` runs the plain version :func:`rbf_gram_plain` on CPU
tensors and the hand-written kernel K4 (``csrc/rbf_gram.cu``) on CUDA
tensors; :func:`rbf_gram_vjp` and :func:`rbf_gram_vjp_fused` run the plain
VJP on CPU tensors and K4's VJP (``csrc/rbf_gram_vjp.cu``) on CUDA tensors.
Any other device raises.  Every launch adds one to ``rbf_gram.launches`` or
``rbf_gram_vjp.launches`` (and, in f32, to ``.launches_f32``).

The plain versions keep the JAX package's GEMM form of the squared distance,
``|u|^2 + |v|^2 - 2 u.v`` clamped at 0, whose cancellation leaves
eps |u|^2 in each entry and C0 near, not at, 1 on a same-point diagonal.
The kernels subtract first.
"""
from __future__ import annotations

from .launch import FAMILIES

_F = FAMILIES['rbf']
rbf_gram_plain = _F.plain
launch_rbf = _F.launch
rbf_gram = _F.gram
rbf_gram_vjp_plain = _F.vjp_plain
rbf_gram_vjp_fused_plain = _F.fused_plain
rbf_gram_vjp_scale = _F.scale
launch_rbf_vjp = _F.launch_vjp
rbf_gram_vjp = _F.vjp
rbf_gram_vjp_fused = _F.vjp_fused
