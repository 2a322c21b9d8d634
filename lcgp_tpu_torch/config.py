"""Global numeric configuration (counterpart of ``lcgp_tpu/config.py``).

Precision modes
---------------
``'high'``  : float64 end to end (parity with the reference).
``'mixed'`` : f64 data/Gram/reductions with mixed-precision factorizations
              (an f32 Cholesky refined to f64 grade, ``ops/mixed.py``):
              an f64-grade loss with f32-grade gradients.
``'fast'``  : float32 Gram construction and factorizations with a jitter
              floor.
``'auto'`` (resolved by the model once n is known): 'mixed' at n >= 2048,
'high' below.

Every f32 matmul must run in true f32.  TF32 keeps about three decimal
digits, and reduced-precision f32 GEMMs break the PSD margin of the
factorization targets (the finding recorded in ``lcgp_tpu/config.py`` for
the TPU's bf16 passes), so TF32 is switched off for both matmuls and cuDNN
when this module is imported.
"""
from __future__ import annotations

import torch

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False

_PRECISION_DTYPES = {
    "high": torch.float64,
    "mixed": "mixed",
    "fast": torch.float32,
}

# Jitter added to the diagonal of Cholesky targets; 'high' adds nothing, as
# the reference does.
_PRECISION_JITTER = {
    "high": 0.0,
    "mixed": 0.0,
    "fast": 1e-6,
}


def dtype_for(precision: str):
    try:
        return _PRECISION_DTYPES[precision]
    except KeyError:
        raise ValueError(
            f"precision must be one of {sorted(_PRECISION_DTYPES)}, got {precision!r}"
        ) from None


def jitter_for(precision: str) -> float:
    return _PRECISION_JITTER[precision]
