"""The numbers that decide ``correct``: gaps between what the timed path
produced and what the plain reference (``reference/lcgp_ref.py``) works out
from the same raw inputs.

Leaf-wise gaps follow the benchmark's rule for a step's norms: for each
leaf (lLmb, lLmb0, lsigma2s, lnugGPs), the gap between the program's norm
and the reference's, over the reference's norm of that leaf or of the
median leaf, whichever is larger.  A leaf whose reference norm is under a
thousandth of the median leaf's moves by rounding alone and is left out.
"""
from __future__ import annotations

import contextlib

import numpy as np
import scipy.optimize
import torch

from reference import lcgp_ref as R

# the control: the reference in the nearest precision below the one the
# configuration states ('high' is float64, 'fast' float32 with TF32 off)
CONTROL = {"high": (torch.float32, False), "fast": (torch.float32, True)}


def leaf_norms(vec: np.ndarray, like: dict) -> np.ndarray:
    out, ofs = [], 0
    for k in R.LEAVES:
        size = like[k].numel()
        out.append(float(np.linalg.norm(vec[ofs:ofs + size])))
        ofs += size
    return np.asarray(out)


def norm_gap(prog: np.ndarray, ref: np.ndarray, like: dict,
             direction: bool = False) -> float:
    """The worst leaf's gap of norms between two flat vectors; with
    ``direction`` both are first scaled to unit length (the program's first
    step gives its gradient's direction, not its length).  A program
    vector of zeros reads 1."""
    prog = np.asarray(prog, dtype=np.float64)
    ref = np.asarray(ref, dtype=np.float64)
    if not np.any(prog) or not np.all(np.isfinite(prog)):
        return 1.0 if np.all(np.isfinite(prog)) else float("inf")
    if direction:
        prog = prog / np.linalg.norm(prog)
        ref = ref / np.linalg.norm(ref)
    a, b = leaf_norms(prog, like), leaf_norms(ref, like)
    med = float(np.median(b))
    keep = b >= 1e-3 * med
    return float(np.max(np.abs(a - b)[keep] / np.maximum(b[keep], med)))


def loss_gap(prog: float, ref: float, entries: int) -> float:
    """The gap between two losses per output entry (n p of them): the
    loss's terms nearly cancel as a fit goes on, so its own size is no
    scale."""
    if not np.isfinite(prog):
        return float("inf")
    return abs(prog - ref) / entries


def failing_as_inf(lossfn):
    """A stand-in whose factorization fails reads an infinite loss and a
    gradient of NaNs: it has failed, and sets no upper reading."""
    def fn(free, grad=False):
        try:
            return lossfn(free, grad)
        except torch.linalg.LinAlgError:
            return float("inf"), ({k: torch.full_like(v, float("nan"))
                                   for k, v in free.items()} if grad
                                  else None)
    return fn


@contextlib.contextmanager
def precision(dtype, tf32: bool):
    """float64 with TF32 off for the reference; the control's setting
    otherwise."""
    old = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield dtype
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = old


def reference_change(lossfn, free0: dict, iters: int,
                     method: str) -> np.ndarray:
    """The flat change from ``free0`` that ``iters`` iterations of
    ``scipy.optimize.minimize``'s ``method`` (its default options) make
    over ``lossfn(free, grad=True)``."""
    def fg(v):
        val, g = lossfn(R.unflat(v, free0), grad=True)
        if not np.isfinite(val):
            return np.inf, np.zeros_like(v)
        return val, R.flat(g).cpu().numpy()
    x0 = R.flat(free0).cpu().numpy()
    res = scipy.optimize.minimize(fg, x0, jac=True, method=method,
                                  options={"maxiter": iters})
    return np.asarray(res.x) - x0


def serve_gaps(prog, ref, ymad) -> tuple[float, float]:
    """(mean gap, variance gap) of one request's (ypred, ypredvar,
    yconfvar), each (p, n0): the mean's largest error over its output's
    spread, and the variances' largest error over the predictive
    variance."""
    yp, pv, cv = (np.asarray(a, dtype=np.float64) for a in prog)
    ry, rpv, rcv = (a.cpu().numpy() for a in ref)
    if not all(np.all(np.isfinite(a)) for a in (yp, pv, cv)):
        return float("inf"), float("inf")
    mean = float(np.max(np.abs(yp - ry) / ymad))
    var = float(np.max(np.maximum(np.abs(pv - rpv), np.abs(cv - rcv))
                       / rpv))
    return mean, var
