"""One flat float64 vector over the free parameters.

The order is the one ``jax.flatten_util.ravel_pytree`` gives a
``FreeParams``: its fields in order, each flattened row-major.  So a flat
vector, and scipy's iterates over it, mean the same in both packages."""
from __future__ import annotations

import numpy as np
import torch


class Flattener:
    """ravel / unravel between a NamedTuple of tensors and one flat vector
    on the tensors' device."""

    def __init__(self, params0):
        self.kind = type(params0)
        self.shapes = [tuple(t.shape) for t in params0]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.device = params0[0].device

    def ravel(self, params) -> torch.Tensor:
        return torch.cat([torch.as_tensor(t, dtype=torch.float64,
                                          device=self.device).reshape(-1)
                          for t in params])

    def unravel(self, flat: torch.Tensor):
        """Views of ``flat``, so a gradient taken with respect to ``flat``
        is the flat gradient."""
        return self.kind(*(part.view(shape) for part, shape in
                           zip(torch.split(flat, self.sizes), self.shapes)))

    def unravel_host(self, z):
        """A fresh NamedTuple of device tensors from a host vector."""
        flat = torch.as_tensor(np.array(z, dtype=np.float64),
                               device=self.device)
        return self.unravel(flat)
