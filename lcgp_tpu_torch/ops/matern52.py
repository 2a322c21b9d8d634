"""Matérn 5/2 separable product kernel, batched over latent components
(counterpart of ``lcgp_tpu/ops/matern52.py``).

    C0 = prod_j (1 + a s_j + (a^2/3) s_j^2) * exp(-a * sum_j s_j),
    s_j = |u_j - v_j|,  a = sqrt(5)

with the reference's nugget and amplitude rules, as for Matérn 3/2:
``amp * ((1-eta) C0 + eta I)`` when x1 and x2 are the same points,
``amp * (1-eta) C0`` for cross-covariances; the prior variance is ``amp``
(``matern32_diag``).

The functions are the ``'matern52'`` family's of ``ops/launch.py``:
:func:`matern52_gram` runs the plain version :func:`matern52_gram_plain` on
CPU tensors and the hand-written kernel K3 (``csrc/matern52_gram.cu``) on
CUDA tensors; :func:`matern52_gram_vjp` and :func:`matern52_gram_vjp_fused`
run the plain VJP on CPU tensors and K3's VJP (``csrc/matern52_gram_vjp.cu``)
on CUDA tensors.  Any other device raises.  Every launch adds one to
``matern52_gram.launches`` or ``matern52_gram_vjp.launches`` (and, in f32,
to ``.launches_f32``).  The kernels subtract before they scale; the plain
versions scale first, as the JAX package does.
"""
from __future__ import annotations

from .launch import FAMILIES

_F = FAMILIES['matern52']
matern52_gram_plain = _F.plain
launch_matern52 = _F.launch
matern52_gram = _F.gram
matern52_gram_vjp_plain = _F.vjp_plain
matern52_gram_vjp_fused_plain = _F.fused_plain
matern52_gram_vjp_scale = _F.scale
launch_matern52_vjp = _F.launch_vjp
matern52_gram_vjp = _F.vjp
matern52_gram_vjp_fused = _F.vjp_fused
