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
Every launch of K1 adds one to ``matern32_gram.launches``, and a launch of
its f32 instantiation also to ``matern32_gram.launches_f32``.

Its VJP is dispatched the same way: :func:`matern32_gram_vjp` (any
cotangent) and :func:`matern32_gram_vjp_fused` (the loss's cotangent
``alpha_k M + beta w w^T``, never formed on CUDA) run the plain versions on
CPU tensors and the kernel ``csrc/matern32_gram_vjp.cu`` (K2) on CUDA
tensors.  Every launch of K2 adds one to ``matern32_gram_vjp.launches``
(and, in f32, to ``matern32_gram_vjp.launches_f32``).
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
    matern32_gram.launches_f32 += int(x1.dtype == torch.float32)
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
matern32_gram.launches_f32 = 0     # of those, the f32 instantiation's


def matern32_gram_vjp_plain(x1, x2, lengthscales, amplitudes, nuggets, *,
                            same: bool, cbar, c0=None):
    """Plain PyTorch VJP of :func:`matern32_gram_plain`, a transcription of
    the JAX ``matern32_gram_vjp``.

    Given the cotangent ``cbar`` (q, n1, n2) of the Gram stack, returns
    (glens (q, d), gamp (q,), gnug (q,)):

        dC/dl_j   = amp (1-eta) C0 S_j^2 / ((1+S_j) l_j)
        dC/damp   = (1-eta) C0 + eta I[same]
        dC/dnug   = amp (I[same] - C0) / (1+nug)^2

    ``c0``: the forward's raw correlation stack; when given it is not
    rebuilt."""
    lengthscales = torch.atleast_2d(lengthscales)
    amplitudes = torch.atleast_1d(amplitudes)
    nuggets = torch.atleast_1d(nuggets)
    d = x1.shape[1]
    dt = cbar.dtype

    inv_l = (1.0 / lengthscales).to(dt)
    u1 = x1.to(dt)[None, :, :] * inv_l[:, None, :]
    u2 = x2.to(dt)[None, :, :] * inv_l[:, None, :]

    if c0 is None:
        q, n1 = u1.shape[0], u1.shape[1]
        prod = torch.ones((q, n1, u2.shape[1]), dtype=dt, device=cbar.device)
        ssum = torch.zeros_like(prod)
        for j in range(d):
            s = torch.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
            prod = prod * (1.0 + s)
            ssum = ssum + s
        c0 = prod * torch.exp(-ssum)
    else:
        c0 = c0.to(dt)

    amp = amplitudes.to(dt)
    nug = nuggets.to(dt)
    eta = nug / (1.0 + nug)

    gc0 = torch.sum(cbar * c0, dim=(-2, -1))                   # (q,)
    if same:
        diag_cbar = torch.diagonal(cbar, dim1=-2, dim2=-1).sum(-1)
        # diagonal of C0 is exactly 1 (S=0 there)
        gamp = (1.0 - eta) * gc0 + eta * diag_cbar
        geta = amp * (diag_cbar - gc0)
    else:
        gamp = (1.0 - eta) * gc0
        geta = amp * (-gc0)
    gnug = geta / torch.square(1.0 + nug)

    w = cbar * (amp * (1.0 - eta))[:, None, None] * c0
    glens = []
    for j in range(d):
        s = torch.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        glens.append(torch.sum(w * s * s / (1.0 + s), dim=(-2, -1))
                     * inv_l[:, j])
    glens = torch.stack(glens, dim=-1)                         # (q, d)
    return (glens.to(lengthscales.dtype), gamp.to(amplitudes.dtype),
            gnug.to(nuggets.dtype))


def fused_cotangent(M, alpha, beta: float, w):
    """The loss's Gram cotangent ``alpha_k M_k + beta w_k w_k^T``, formed
    (q, n, n); the plain side of the fused VJP."""
    return (alpha[:, None, None] * M
            + beta * w[:, :, None] * w[:, None, :])


def matern32_gram_vjp_fused_plain(x, lengthscales, amplitudes, nuggets, *,
                                  M, alpha, beta: float, w):
    """Plain VJP of the same-point Gram at the cotangent
    ``alpha_k M_k + beta w_k w_k^T`` (the JAX package forms it at
    ``likelihood.py:231-234`` with M = B^{-1}, alpha = D/2, beta = -1/2)."""
    return matern32_gram_vjp_plain(
        x, x, lengthscales, amplitudes, nuggets, same=True,
        cbar=fused_cotangent(M, alpha, beta, w))


def matern32_gram_vjp_scale(x1, x2, lengthscales, amplitudes, nuggets, *,
                            same: bool, cbar, c0=None):
    """The magnitude each VJP output is a sum of: the VJP's terms taken with
    |cbar| and every sign made positive, so (glens, gamp, gnug) of
    non-negative sums.  A kernel's rounding error in a sum is judged
    against this, not against the sum, which cancels near an optimum."""
    amp = torch.atleast_1d(amplitudes).to(cbar.dtype)
    nug = torch.atleast_1d(nuggets).to(cbar.dtype)
    a = cbar.abs()
    # same=False leaves out the diagonal terms; their magnitudes go back in
    glens, gamp, gnug = matern32_gram_vjp_plain(
        x1, x2, lengthscales, amplitudes, nuggets, same=False, cbar=a, c0=c0)
    gnug = gnug.abs()
    if same:
        diag = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
        gamp = gamp + nug / (1.0 + nug) * diag
        gnug = gnug + amp * diag / torch.square(1.0 + nug)
    return glens, gamp, gnug


def launch_matern32_vjp(x1, x2, lengthscales, amplitudes, nuggets, *,
                        same: bool, M, alpha=None, beta: float = 0.0,
                        w=None):
    """Launch K2 on CUDA tensors; returns (glens (q,d), gamp (q,), gnug (q,)).

    The cotangent is ``alpha_k M_k + beta w_k w_k^T`` (alpha None reads as
    ones, w None drops the second term); it is never formed.  Launches on
    the current stream and does not synchronise."""
    from ._build import build

    q, n1, n2, d = _check_cuda_inputs(x1, x2, lengthscales, amplitudes,
                                      nuggets, None, None, same)
    dt = x1.dtype
    for name, t, shape in (('M', M, (q, n1, n2)), ('w', w, (q, n1)),
                           ('alpha', alpha, (q,))):
        if t is None:
            continue
        if t.device != x1.device or t.dtype != dt:
            raise TypeError(f"matern32 VJP kernel: {name} is {t.dtype} on "
                            f"{t.device}, x1 is {dt} on {x1.device}")
        if tuple(t.shape) != shape:
            raise ValueError(f"matern32 VJP kernel: {name} "
                             f"{tuple(t.shape)} must be {shape}")
        if not t.is_contiguous():
            raise ValueError(f"matern32 VJP kernel: {name} must be "
                             "contiguous")
    if w is not None and not same:
        raise ValueError("matern32 VJP kernel: w needs same=True")
    if w is None and beta != 0.0:
        raise ValueError("matern32 VJP kernel: beta without w")

    lib = build().lib
    fn = (lib.lcgp_matern32_gram_vjp_f64 if dt == torch.float64
          else lib.lcgp_matern32_gram_vjp_f32)
    inv_l = (1.0 / lengthscales).contiguous()
    glens = torch.empty((q, d), dtype=dt, device=x1.device)
    gamp = torch.empty((q,), dtype=dt, device=x1.device)
    gnug = torch.empty((q,), dtype=dt, device=x1.device)
    partials = torch.empty(
        (lib.lcgp_matern32_gram_vjp_scratch(q, n1, n2, d),),
        dtype=torch.float64, device=x1.device)

    def ptr(t):
        return None if t is None else t.data_ptr()

    with torch.cuda.device(x1.device):
        stream = torch.cuda.current_stream(x1.device).cuda_stream
        err = fn(ptr(x1), ptr(x2), ptr(inv_l), ptr(amplitudes), ptr(nuggets),
                 ptr(M), ptr(w), ptr(alpha), float(beta), int(same), q, n1,
                 n2, d, ptr(partials), ptr(glens), ptr(gamp), ptr(gnug),
                 stream)
    if err != 0:
        raise RuntimeError(f"matern32 VJP kernel launch failed: "
                           f"cudaError {err}")
    matern32_gram_vjp.launches += 1
    matern32_gram_vjp.launches_f32 += int(dt == torch.float32)
    return glens, gamp, gnug


def matern32_gram_vjp(x1, x2, lengthscales, amplitudes, nuggets, *,
                      same: bool, cbar, c0=None):
    """(glens, gamp, gnug) for a Gram-stack cotangent ``cbar``.

    CPU tensors run :func:`matern32_gram_vjp_plain`; CUDA tensors run K2,
    which recomputes C0 and ignores ``c0``.  Any other device raises."""
    if x1.device.type == 'cpu':
        return matern32_gram_vjp_plain(x1, x2, lengthscales, amplitudes,
                                       nuggets, same=same, cbar=cbar, c0=c0)
    return launch_matern32_vjp(x1, x2, torch.atleast_2d(lengthscales),
                               torch.atleast_1d(amplitudes),
                               torch.atleast_1d(nuggets), same=same, M=cbar)


matern32_gram_vjp.launches = 0
matern32_gram_vjp.launches_f32 = 0


def matern32_gram_vjp_fused(x, lengthscales, amplitudes, nuggets, *, M,
                            alpha, beta: float, w):
    """(glens, gamp, gnug) of the same-point Gram at the cotangent
    ``alpha_k M_k + beta w_k w_k^T``.

    The VJP runs in M's dtype, as the JAX ``matern32_gram_vjp`` runs in
    the cotangent's (``lcgp_tpu/ops/matern.py:108-112``), and the results
    come back in the parameters' dtypes.  CPU tensors form the cotangent
    and run the plain VJP; CUDA tensors run K2, which reads M and w and
    never forms the cotangent.  Any other device raises."""
    dt = M.dtype
    alpha, w = alpha.to(dt), w.to(dt)
    if x.device.type == 'cpu':
        return matern32_gram_vjp_fused_plain(x, lengthscales, amplitudes,
                                             nuggets, M=M, alpha=alpha,
                                             beta=beta, w=w)
    # K2 takes every operand in one dtype
    xc, ls, amp, nug = (t.to(dt).contiguous() for t in
                        (x, lengthscales, amplitudes, nuggets))
    got = launch_matern32_vjp(xc, xc, ls, amp, nug, same=True, M=M,
                              alpha=alpha.contiguous(), beta=beta,
                              w=w.contiguous())
    return tuple(g.to(p.dtype) for g, p in
                 zip(got, (lengthscales, amplitudes, nuggets)))


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
