"""SVD latent basis (reference init_phi, lcgp.py:439-485).

A copy of ``lcgp_tpu/models/basis.py``: it is pure NumPy, and importing it
from ``lcgp_tpu`` would import JAX through that package's ``__init__``.

Convention: for standardized outputs Y (p, n) with thin SVD Y = U S V^T,
``phi = U[:, :q] * sqrt(n) / s_q`` so that ``phi^T phi = diag(D)`` with
``D_k = n / s_k^2``; latents ``g = phi^T Y`` have ~unit variance per row.

q-selection is data-dependent and therefore resolved on the host before any
jit (SURVEY §7.3 "Data-dependent shapes").
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class Basis(NamedTuple):
    phi: np.ndarray     # (p, q)
    diag_D: np.ndarray  # (q,)
    g: np.ndarray       # (q, n)
    q: int
    g_var: np.ndarray   # (q,) variance of each latent row (diagnostic; the
                        # reference prints this to stdout, lcgp.py:482-483)


def select_q(singvals, p: int, q: int | None, var_threshold: float | None) -> int:
    """Latent count: explicit q wins; else cumulative-variance threshold;
    else q = p (reference lcgp.py:466-474)."""
    if q is not None and var_threshold is not None:
        raise ValueError('Include only q or var_threshold but not both.')
    if q is not None:
        return int(q)
    if var_threshold is None:
        return int(p)
    s = np.asarray(singvals, dtype=np.float64)
    cumvar = np.cumsum(s ** 2) / np.sum(s ** 2)
    above = cumvar > var_threshold
    return int(np.argmax(above) + 1) if np.any(above) else int(p)


def init_phi(y, q: int | None = None, var_threshold: float | None = None) -> Basis:
    """Compute the basis from (standardized) Y of shape (p, n)."""
    y = np.asarray(y, dtype=np.float64)
    p, n = y.shape
    u, s, _ = np.linalg.svd(y, full_matrices=False)
    q_sel = select_q(s, p, q, var_threshold)
    if q_sel > min(n, p):
        raise ValueError(
            f"q={q_sel} exceeds min(n, p)={min(n, p)}; the SVD basis has at "
            f"most min(n, p) components.")
    phi = u[:, :q_sel] * np.sqrt(n) / s[:q_sel]
    diag_D = np.sum(phi ** 2, axis=0)
    g = phi.T @ y
    g_var = np.var(g, axis=1)
    return Basis(phi=phi, diag_D=diag_D, g=g, q=q_sel, g_var=g_var)
