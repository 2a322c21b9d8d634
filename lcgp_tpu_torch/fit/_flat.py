"""One flat float64 vector over the free parameters.

The order is the one ``jax.flatten_util.ravel_pytree`` gives the same tree:
a NamedTuple's fields in order, a dict's values by sorted key (the tree
``{'free': FreeParams, 'z': z}`` of ``LCGP.refine_inducing``), each tensor
flattened row-major.  So a flat vector, and scipy's iterates over it, mean
the same in both packages."""
from __future__ import annotations

import numpy as np
import torch


def _leaves(tree):
    """The tensors of a tree of NamedTuples, dicts and tensors, in
    ``ravel_pytree``'s order."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _leaves(tree[k])]
    if isinstance(tree, tuple):
        return [t for item in tree for t in _leaves(item)]
    return [tree]


def _rebuild(tree, leaves):
    """``tree``'s structure with its tensors taken in order from the
    iterator ``leaves``."""
    if isinstance(tree, dict):
        return {k: _rebuild(tree[k], leaves) for k in sorted(tree)}
    if isinstance(tree, tuple):
        items = [_rebuild(item, leaves) for item in tree]
        return type(tree)(*items) if hasattr(tree, '_fields') else tuple(items)
    return next(leaves)


class Flattener:
    """ravel / unravel between a tree of tensors (a NamedTuple, or a dict
    of NamedTuples and tensors) and one flat vector on the tensors'
    device."""

    def __init__(self, params0):
        self.tree = params0
        leaves = _leaves(params0)
        self.shapes = [tuple(t.shape) for t in leaves]
        self.sizes = [int(np.prod(s, dtype=np.int64)) for s in self.shapes]
        self.device = leaves[0].device

    def ravel(self, params) -> torch.Tensor:
        return torch.cat([torch.as_tensor(t, dtype=torch.float64,
                                          device=self.device).reshape(-1)
                          for t in _leaves(params)])

    def unravel(self, flat: torch.Tensor):
        """Views of ``flat``, so a gradient taken with respect to ``flat``
        is the flat gradient."""
        return _rebuild(self.tree, iter(
            part.view(shape) for part, shape in
            zip(torch.split(flat, self.sizes), self.shapes)))

    def unravel_host(self, z):
        """A fresh tree of device tensors from a host vector."""
        flat = torch.as_tensor(np.array(z, dtype=np.float64),
                               device=self.device)
        return self.unravel(flat)
