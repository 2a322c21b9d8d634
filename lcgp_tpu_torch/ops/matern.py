"""Matérn 3/2 separable product kernel, batched over latent components
(counterpart of ``lcgp_tpu/ops/matern.py``).

Behavioral contract of the reference ``Matern32`` (reference
covmat.py:5-55), quirks included:

- per-dimension lengthscales ``llmb`` divide the inputs directly (they are
  constrained positive values, not logs);
- ``C0 = prod_j (1 + S_j) * exp(-sum_j S_j)`` with ``S_j = |u_j - v_j|``;
- nugget ``eta = lnug / (1 + lnug)``; the full matrix is
  ``llmb0 * ((1-eta) C0 + eta I)`` when x1 and x2 are *identical*, and
  ``llmb0 * (1-eta) C0`` (no diagonal) for cross-covariances;
- ``diag_only=True`` returns ``llmb0 * ones`` (amplitude only, no nugget),
  and requires x1 ≈ x2.

:func:`matern32_gram` dispatches on the device of its inputs: CPU tensors
go to the plain version :func:`matern32_gram_plain`; CUDA tensors go to the
hand-written kernel ``csrc/matern32_gram.cu`` (K1), or the call raises.
Every launch of K1 adds one to ``matern32_gram.launches``.
"""
from __future__ import annotations

import numpy as np
import torch

_MAX_D = 32   # the kernel keeps d raw distances in registers


def matern32_gram_plain(x1, x2, lengthscales, amplitudes, nuggets, *,
                        same: bool, want_c0: bool = False):
    """Plain PyTorch Gram stack, a transcription of the JAX
    ``matern32_gram``.

    x1 (n1, d), x2 (n2, d), lengthscales (q, d), amplitudes (q,),
    nuggets (q,).  ``same`` (True iff x1 and x2 are the same points)
    switches on the nugget diagonal.  Returns the (q, n1, n2) stack, and
    ``(stack, c0)`` with the raw correlation stack when ``want_c0``.
    """
    lengthscales = torch.atleast_2d(lengthscales)
    amplitudes = torch.atleast_1d(amplitudes)
    nuggets = torch.atleast_1d(nuggets)

    d = x1.shape[1]
    inv_l = 1.0 / lengthscales  # (q, d)
    u1 = x1[None, :, :] * inv_l[:, None, :]  # (q, n1, d)
    u2 = x2[None, :, :] * inv_l[:, None, :]  # (q, n2, d)

    q, n1 = u1.shape[0], u1.shape[1]
    n2 = u2.shape[1]
    dt = u1.dtype
    prod = torch.ones((q, n1, n2), dtype=dt, device=x1.device)
    ssum = torch.zeros((q, n1, n2), dtype=dt, device=x1.device)
    for j in range(d):
        s = torch.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        prod = prod * (1.0 + s)
        ssum = ssum + s
    c0 = prod * torch.exp(-ssum)

    eta = nuggets / (1.0 + nuggets)  # (q,)
    c = (1.0 - eta)[:, None, None] * c0
    if same:
        c = c + eta[:, None, None] * torch.eye(n1, dtype=dt,
                                               device=x1.device)[None, :, :]
    c = amplitudes[:, None, None] * c
    return (c, c0) if want_c0 else c


def _check_cuda_inputs(x1, x2, lengthscales, amplitudes, nuggets,
                       row_scale, diag_vec, same):
    if x1.device.type != 'cuda':
        raise ValueError(f"matern32 kernel: expected CUDA tensors, got "
                         f"device {x1.device}")
    dt = x1.dtype
    if dt not in (torch.float64, torch.float32):
        raise TypeError(f"matern32 kernel: dtype must be float64 or float32, "
                        f"got {dt}")
    named = dict(x1=x1, x2=x2, lengthscales=lengthscales,
                 amplitudes=amplitudes, nuggets=nuggets)
    if row_scale is not None:
        named['row_scale'] = row_scale
    if diag_vec is not None:
        named['diag_vec'] = diag_vec
    for name, t in named.items():
        if t.device != x1.device:
            raise ValueError(f"matern32 kernel: {name} is on {t.device}, "
                             f"x1 on {x1.device}")
        if t.dtype != dt:
            raise TypeError(f"matern32 kernel: {name} has dtype {t.dtype}, "
                            f"x1 has {dt}")
        if not t.is_contiguous():
            raise ValueError(f"matern32 kernel: {name} must be contiguous")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"matern32 kernel: x1 {tuple(x1.shape)} and x2 "
                         f"{tuple(x2.shape)} must be (n1, d) and (n2, d)")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if not 1 <= d <= _MAX_D:
        raise ValueError(f"matern32 kernel: d={d} outside 1..{_MAX_D}")
    q = lengthscales.shape[0]
    if lengthscales.shape != (q, d):
        raise ValueError(f"matern32 kernel: lengthscales "
                         f"{tuple(lengthscales.shape)} must be (q, d={d})")
    for name in ('amplitudes', 'nuggets', 'row_scale'):
        t = named.get(name)
        if t is not None and t.shape != (q,):
            raise ValueError(f"matern32 kernel: {name} {tuple(t.shape)} must "
                             f"be (q,)=({q},)")
    if same and n1 != n2:
        raise ValueError("matern32 kernel: same=True needs n1 == n2")
    if diag_vec is not None:
        if row_scale is None or not same:
            raise ValueError("matern32 kernel: diag_vec needs row_scale and "
                             "same=True")
        if diag_vec.shape != (q, n1):
            raise ValueError(f"matern32 kernel: diag_vec {tuple(diag_vec.shape)}"
                             f" must be (q, n)=({q}, {n1})")
    if max(n1, n2, q) >= 2 ** 31:       # the C entry takes 32-bit sizes
        raise ValueError("matern32 kernel: a size exceeds 2**31 - 1")
    return q, n1, n2, d


def launch_matern32(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
                    want_c0: bool = False, row_scale=None, diag_vec=None):
    """Launch K1 on CUDA tensors and return (out, c0 or None).

    ``out`` is the Gram stack, or the factorization target
    ``row_scale_k * C_k + diag(diag_vec_k)`` when ``row_scale`` is given.
    Launches on the current stream and does not synchronise."""
    from ._build import build

    q, n1, n2, d = _check_cuda_inputs(x1, x2, lengthscales, amplitudes,
                                      nuggets, row_scale, diag_vec, same)
    lib = build().lib
    fn = (lib.lcgp_matern32_gram_f64 if x1.dtype == torch.float64
          else lib.lcgp_matern32_gram_f32)
    inv_l = (1.0 / lengthscales).contiguous()
    out = torch.empty((q, n1, n2), dtype=x1.dtype, device=x1.device)
    c0 = (torch.empty((q, n1, n2), dtype=x1.dtype, device=x1.device)
          if want_c0 else None)

    if out.numel() == 0:
        return out, c0

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = fn(ptr(x1), ptr(x2), ptr(inv_l), ptr(amplitudes), ptr(nuggets),
                 ptr(row_scale), ptr(diag_vec), int(same), q, n1, n2, d,
                 ptr(out), ptr(c0), stream)
    if err != 0:
        raise RuntimeError(f"matern32 kernel launch failed: cudaError {err}")
    matern32_gram.launches += 1
    return out, c0


def matern32_gram(x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
                  want_c0: bool = False):
    """Batched Gram stack (q, n1, n2); ``(stack, c0)`` when ``want_c0``.

    CPU tensors run :func:`matern32_gram_plain`; CUDA tensors run the K1
    kernel.  Any other device raises."""
    if x1.device.type == 'cpu':
        return matern32_gram_plain(x1, x2, lengthscales, amplitudes, nuggets,
                                   same=same, want_c0=want_c0)
    c, c0 = launch_matern32(x1, x2, torch.atleast_2d(lengthscales),
                            torch.atleast_1d(amplitudes),
                            torch.atleast_1d(nuggets), same=same,
                            want_c0=want_c0)
    return (c, c0) if want_c0 else c


matern32_gram.launches = 0


def matern32_diag(x0, amplitudes):
    """Batched prior variance at x0: ``amp * 1`` per point.  Returns (q, n0)."""
    amplitudes = torch.atleast_1d(amplitudes)
    n0 = x0.shape[0]
    return amplitudes[:, None] * torch.ones((amplitudes.shape[0], n0),
                                            dtype=amplitudes.dtype,
                                            device=amplitudes.device)


def Matern32(x1, x2, llmb, llmb0, lnug, diag_only: bool = False,
             same: bool | None = None):
    """Single-component kernel with the reference's public signature and
    validation behavior (reference covmat.py:5-55).

    ``same`` overrides the runtime x1 == x2 check.  With ``same=None`` the
    check short-circuits on object identity and otherwise compares shapes
    and then values.
    """
    if same is None and x1 is x2:
        same = True
    x1 = torch.as_tensor(x1)
    x2 = torch.as_tensor(x2, device=x1.device)
    # AssertionError as the reference's asserts raise, explicitly so that
    # the checks survive python -O
    if x1.ndim != 2:
        raise AssertionError(
            'input x1 should be 2-dimensional, (n_param, dim_param)')
    if x2.ndim != 2:
        raise AssertionError(
            'input x2 should be 2-dimensional, (n_param, dim_param)')
    if x1.shape[1] != x2.shape[1]:
        raise AssertionError(
            'the dim_param of input x1 and x2 should be the same.')

    llmb = torch.as_tensor(llmb, dtype=x1.dtype, device=x1.device)
    llmb0 = torch.as_tensor(llmb0, dtype=x1.dtype, device=x1.device)
    lnug = torch.as_tensor(lnug, dtype=x1.dtype, device=x1.device)
    if llmb.ndim == 0:
        llmb = llmb[None]

    if diag_only:
        # same tolerance rule as the reference's assert (covmat.py:25)
        a1 = x1.cpu().numpy()
        a2 = x2.cpu().numpy()
        if not np.all(np.abs(a1 - a2) <= 1e-6 + 1e-6 * np.abs(a2)):
            raise AssertionError('diag_only should only be called when x1 '
                                 'and x2 are identical.')
        return matern32_diag(x1, llmb0)[0]

    if same is None:
        if x1.shape != x2.shape:
            same = False
        else:
            same = bool(torch.equal(x1, x2))
    return matern32_gram(x1.contiguous(), x2.contiguous(), llmb[None, :],
                         llmb0[None], lnug[None], same=same)[0]
