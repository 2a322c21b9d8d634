"""The kernel families and the launches of their hand-written Gram and
Gram-VJP kernels, one code path for all of them.

Every kernel instantiates a template on a family's policy of
``csrc/gram_common.cuh``: K1/K2 for Matérn 3/2, K3 for Matérn 5/2 and K4
for the squared exponential.  The Gram stack / factor target is
``csrc/gram_kernel.cuh`` (K1, K4) or ``csrc/matern52_gram_kernel.cuh``
(K3); its VJP in the parameters ``csrc/gram_vjp_kernel.cuh`` (K2) or
``csrc/matern52_gram_vjp_kernel.cuh`` (K3, K4); its VJP in the points of
x2, K5, ``csrc/gram_vjp_x_kernel.cuh`` for every family.  Their C
entry points ``lcgp_<family>_gram_{f64,f32}``,
``lcgp_<family>_gram_vjp_{f64,f32}`` and
``lcgp_<family>_gram_vjp_x_{f64,f32}`` take the same arguments in every
family, so one launcher serves all three.

:data:`FAMILIES` is the one table of them: each :class:`Family` holds its
name (the ``kernel=`` kind and the C entry points' infix), its label and
policy, its plain versions' raw correlation, lengthscale term and slope
in the points, and the functions built on them, which ``ops/matern.py``, ``ops/matern52.py`` and
``ops/rbf.py`` export under the family's names and ``ops/gram.py``
dispatches to by kind.

A family's dispatchers (``gram``, ``vjp``, ``vjp_fused``, ``vjp_x``) run
its plain PyTorch version on CPU tensors and its kernel on CUDA tensors;
any other device raises, and nothing falls back.  The plain versions share
their bodies: a family supplies only its raw correlation, its lengthscale
term and its slope.
"""
from __future__ import annotations

import functools
import math

import torch

MAX_D = 32   # the kernels keep d raw distances in registers


def check_inputs(what, x1, x2, lengthscales, amplitudes, nuggets, row_scale,
                 diag_vec, same):
    """Validate a kernel launch's operands; returns (q, n1, n2, d).
    ``what`` names the kernel in the messages."""
    if x1.device.type != 'cuda':
        raise ValueError(f"{what}: expected CUDA tensors, got device "
                         f"{x1.device}")
    dt = x1.dtype
    if dt not in (torch.float64, torch.float32):
        raise TypeError(f"{what}: dtype must be float64 or float32, got {dt}")
    named = dict(x1=x1, x2=x2, lengthscales=lengthscales,
                 amplitudes=amplitudes, nuggets=nuggets)
    if row_scale is not None:
        named['row_scale'] = row_scale
    if diag_vec is not None:
        named['diag_vec'] = diag_vec
    for name, t in named.items():
        if t.device != x1.device:
            raise ValueError(f"{what}: {name} is on {t.device}, x1 on "
                             f"{x1.device}")
        if t.dtype != dt:
            raise TypeError(f"{what}: {name} has dtype {t.dtype}, x1 has {dt}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")
    if x1.ndim != 2 or x2.ndim != 2 or x1.shape[1] != x2.shape[1]:
        raise ValueError(f"{what}: x1 {tuple(x1.shape)} and x2 "
                         f"{tuple(x2.shape)} must be (n1, d) and (n2, d)")
    n1, d = x1.shape
    n2 = x2.shape[0]
    if not 1 <= d <= MAX_D:
        raise ValueError(f"{what}: d={d} outside 1..{MAX_D}")
    q = lengthscales.shape[0]
    if lengthscales.shape != (q, d):
        raise ValueError(f"{what}: lengthscales {tuple(lengthscales.shape)} "
                         f"must be (q, d={d})")
    for name in ('amplitudes', 'nuggets', 'row_scale'):
        t = named.get(name)
        if t is not None and t.shape != (q,):
            raise ValueError(f"{what}: {name} {tuple(t.shape)} must be "
                             f"(q,)=({q},)")
    if same and n1 != n2:
        raise ValueError(f"{what}: same=True needs n1 == n2")
    if diag_vec is not None:
        if row_scale is None or not same:
            raise ValueError(f"{what}: diag_vec needs row_scale and "
                             "same=True")
        if diag_vec.shape != (q, n1):
            raise ValueError(f"{what}: diag_vec {tuple(diag_vec.shape)} must "
                             f"be (q, n)=({q}, {n1})")
    if max(n1, n2, q) >= 2 ** 31:       # the C entry takes 32-bit sizes
        raise ValueError(f"{what}: a size exceeds 2**31 - 1")
    return q, n1, n2, d


def _ptr(t):
    return None if t is None else t.data_ptr()


def _check_operand(what, name, t, x1, shape):
    """An operand beside x1 must share its device and dtype, have
    ``shape`` and be contiguous."""
    if t.device != x1.device or t.dtype != x1.dtype:
        raise TypeError(f"{what}: {name} is {t.dtype} on {t.device}, "
                        f"x1 is {x1.dtype} on {x1.device}")
    if tuple(t.shape) != shape:
        raise ValueError(f"{what}: {name} {tuple(t.shape)} must be {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: {name} must be contiguous")


def fused_cotangent(M, alpha, beta: float, w):
    """The loss's Gram cotangent ``alpha_k M_k + beta w_k w_k^T``, formed
    (q, n, n); the plain side of the fused VJP."""
    return (alpha[:, None, None] * M
            + beta * w[:, :, None] * w[:, None, :])


# The families' plain math: the raw correlation c0(u1, u2) of the scaled
# inputs (q, n, d), and one dimension's lengthscale summand lens(w, a, b) of
# the scaled coordinates a (q, n1, 1), b (q, 1, n2) at the weight
# w = cbar amp (1-eta) C0.  The plain versions scale before they subtract,
# as the JAX package does; the kernels subtract first.

def _matern32_c0(u1, u2):
    """prod_j (1 + S_j) exp(-sum_j S_j), S_j = |u_j - v_j|."""
    q, n1, d = u1.shape
    prod = torch.ones((q, n1, u2.shape[1]), dtype=u1.dtype, device=u1.device)
    ssum = torch.zeros_like(prod)
    for j in range(d):
        s = torch.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        prod = prod * (1.0 + s)
        ssum = ssum + s
    return prod * torch.exp(-ssum)


def _matern32_lens(w, a, b):
    """w S^2 / (1 + S), S = |a - b|."""
    s = torch.abs(a - b)
    return w * s * s / (1.0 + s)


_SQRT5 = math.sqrt(5.0)     # the kernels' SQRT5 and FIVE_THIRDS, rounded
_FIVE3 = 5.0 / 3.0          # to double as here


def _matern52_c0(u1, u2):
    """prod_j (1 + a S_j + (5/3) S_j^2) exp(-a sum_j S_j), a = sqrt(5)
    (``lcgp_tpu/ops/matern52.py:27-60``)."""
    q, n1, d = u1.shape
    prod = torch.ones((q, n1, u2.shape[1]), dtype=u1.dtype, device=u1.device)
    ssum = torch.zeros_like(prod)
    for j in range(d):
        s = torch.abs(u1[:, :, j][:, :, None] - u2[:, :, j][:, None, :])
        prod = prod * (1.0 + _SQRT5 * s + _FIVE3 * s * s)
        ssum = ssum + s
    return prod * torch.exp(-_SQRT5 * ssum)


def _matern52_lens(w, a, b):
    """w (5/3) S^2 (1 + a S) / (1 + a S + (5/3) S^2), S = |a - b|
    (``lcgp_tpu/ops/matern52.py:63-123``)."""
    s = torch.abs(a - b)
    poly = 1.0 + _SQRT5 * s + _FIVE3 * s * s
    return w * _FIVE3 * s * s * (1.0 + _SQRT5 * s) / poly


def _rbf_c0(u1, u2):
    """exp(-|u - v|^2 / 2) through the JAX package's GEMM form of the
    squared distance, |u|^2 + |v|^2 - 2 u.v clamped at 0
    (``lcgp_tpu/ops/rbf.py:40-46``; TF32 stays off, ``config.py``), whose
    cancellation leaves eps |u|^2 in each entry and C0 near, not at, 1 on a
    same-point diagonal."""
    sq1 = torch.sum(u1 * u1, dim=-1)                 # (q, n1)
    sq2 = torch.sum(u2 * u2, dim=-1)                 # (q, n2)
    cross = torch.einsum('qnd,qmd->qnm', u1, u2)     # (q, n1, n2)
    d2 = sq1[:, :, None] + sq2[:, None, :] - 2.0 * cross
    d2 = torch.clamp_min(d2, 0.0)                    # fp cancellation
    return torch.exp(-0.5 * d2)


def _rbf_lens(w, a, b):
    """w (a - b)^2 (``lcgp_tpu/ops/rbf.py:57-104``)."""
    return w * torch.square(a - b)


# The families' slopes dlnC0/db_j = g(S_j) sign(a_j - b_j) of one dimension
# in the scaled coordinates a (q, n1, 1), b (q, 1, n2), with
# dC0/dS_j = -C0 g(S_j): the plain side of K5.  Each is 0 at S_j = 0 and
# divides by nothing that can vanish.

def _matern32_slope(a, b):
    """g = S / (1 + S)."""
    diff = a - b
    return diff / (1.0 + torch.abs(diff))


def _matern52_slope(a, b):
    """g = 5/3 S (1 + a S) / (1 + a S + 5/3 S^2), a = sqrt(5)."""
    diff = a - b
    s = torch.abs(diff)
    return _FIVE3 * diff * (1.0 + _SQRT5 * s) / (1.0 + _SQRT5 * s
                                                 + _FIVE3 * s * s)


def _rbf_slope(a, b):
    """g = S."""
    return a - b


def _counted(family, method: str):
    """``family``'s ``method`` as a function that carries launch counters,
    ``.launches`` and ``.launches_f32`` (the f32 instantiation's).  The
    method is looked up at each call, so a rehearsal may replace it on the
    class."""
    @functools.wraps(getattr(Family, method))
    def counted(*args, **kwargs):
        return getattr(family, method)(*args, **kwargs)
    counted.launches = counted.launches_f32 = 0
    return counted


class Family:
    """One kernel family and the functions built on it.

    ``name``: the ``kernel=`` kind and the C entry points' infix;
    ``label``: its Gram kernel's name (K1, K3, K4); ``policy``: the policy
    struct of ``csrc/gram_common.cuh`` its kernels are instantiated on;
    ``c0``, ``lens``, ``slope``: its plain versions' raw correlation,
    lengthscale summand and slope in the points.  Every launch of the Gram
    kernel adds one to ``gram.launches`` (and, in f32, to
    ``gram.launches_f32``), every launch of the VJP kernel to ``vjp``'s
    counters and every launch of K5, the VJP in the points, to
    ``vjp_x``'s; nothing else counts."""

    def __init__(self, name: str, label: str, policy: str, c0, lens, slope):
        self.name, self.label, self.policy = name, label, policy
        self.c0, self.lens, self.slope = c0, lens, slope
        self.gram = _counted(self, '_gram')
        self.vjp = _counted(self, '_vjp')
        self.vjp_x = _counted(self, '_vjp_x')

    def plain(self, x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
              want_c0: bool = False):
        """The plain PyTorch Gram stack (q, n1, n2), ``(stack, c0)`` when
        ``want_c0``, a transcription of the JAX package's.

        x1 (n1, d), x2 (n2, d), lengthscales (q, d), amplitudes (q,),
        nuggets (q,).  The family's raw correlation ``c0`` of the scaled
        inputs u = x / l, with the reference's nugget and amplitude rules:
        ``amp ((1 - eta) C0 + eta I)`` when ``same`` (x1 and x2 are the same
        points), ``amp (1 - eta) C0`` across."""
        lengthscales = torch.atleast_2d(lengthscales)
        amplitudes = torch.atleast_1d(amplitudes)
        nuggets = torch.atleast_1d(nuggets)

        inv_l = 1.0 / lengthscales  # (q, d)
        c0 = self.c0(x1[None, :, :] * inv_l[:, None, :],
                     x2[None, :, :] * inv_l[:, None, :])

        eta = nuggets / (1.0 + nuggets)  # (q,)
        c = (1.0 - eta)[:, None, None] * c0
        if same:
            c = c + eta[:, None, None] * torch.eye(
                x1.shape[0], dtype=c0.dtype, device=x1.device)[None, :, :]
        c = amplitudes[:, None, None] * c
        return (c, c0) if want_c0 else c

    def launch(self, x1, x2, lengthscales, amplitudes, nuggets, *,
               same: bool, want_c0: bool = False, row_scale=None,
               diag_vec=None):
        """Launch the Gram kernel on CUDA tensors; returns (out, c0 or
        None) and counts the launch.

        ``out`` is the Gram stack, or the factorization target
        ``row_scale_k * C_k + diag(diag_vec_k)`` when ``row_scale`` is
        given.  Launches on the current stream and does not synchronise."""
        from ._build import build

        what = f"{self.name} kernel"
        q, n1, n2, d = check_inputs(what, x1, x2, lengthscales, amplitudes,
                                    nuggets, row_scale, diag_vec, same)
        lib = build().lib
        f32 = x1.dtype == torch.float32
        fn = getattr(lib, f"lcgp_{self.name}_gram_{'f32' if f32 else 'f64'}")
        inv_l = (1.0 / lengthscales).contiguous()
        out = torch.empty((q, n1, n2), dtype=x1.dtype, device=x1.device)
        c0 = (torch.empty((q, n1, n2), dtype=x1.dtype, device=x1.device)
              if want_c0 else None)

        if out.numel() == 0:
            return out, c0

        with torch.cuda.device(x1.device):
            stream = torch.cuda.current_stream(x1.device).cuda_stream
            err = fn(_ptr(x1), _ptr(x2), _ptr(inv_l), _ptr(amplitudes),
                     _ptr(nuggets), _ptr(row_scale), _ptr(diag_vec),
                     int(same), q, n1, n2, d, _ptr(out), _ptr(c0), stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")
        self.gram.launches += 1
        self.gram.launches_f32 += int(f32)
        return out, c0

    def _gram(self, x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
              want_c0: bool = False):
        """The Gram stack (q, n1, n2), ``(stack, c0)`` when ``want_c0``:
        the plain version on CPU tensors, the kernel on CUDA tensors."""
        if x1.device.type == 'cpu':
            return self.plain(x1, x2, lengthscales, amplitudes, nuggets,
                              same=same, want_c0=want_c0)
        c, c0 = self.launch(x1, x2, torch.atleast_2d(lengthscales),
                            torch.atleast_1d(amplitudes),
                            torch.atleast_1d(nuggets), same=same,
                            want_c0=want_c0)
        return (c, c0) if want_c0 else c

    def vjp_plain(self, x1, x2, lengthscales, amplitudes, nuggets, *,
                  same: bool, cbar, c0=None):
        """The plain PyTorch VJP of :meth:`plain`, a transcription of the
        JAX package's, in cbar's dtype: (glens (q, d), gamp (q,), gnug (q,))
        for the cotangent ``cbar`` (q, n1, n2), with

            dC/dl_j   = sum lens(w, a_j, b_j) / l_j,   w = cbar amp (1-eta) C0
            dC/damp   = (1-eta) C0 + eta I[same]
            dC/dnug   = amp (I[same] - C0) / (1+nug)^2

        where ``lens`` takes the scaled coordinates of one dimension, a_j
        (q, n1, 1) and b_j (q, 1, n2).  ``c0``: the forward's raw
        correlation stack; when given it is not rebuilt."""
        lengthscales = torch.atleast_2d(lengthscales)
        amplitudes = torch.atleast_1d(amplitudes)
        nuggets = torch.atleast_1d(nuggets)
        d = x1.shape[1]
        dt = cbar.dtype

        inv_l = (1.0 / lengthscales).to(dt)
        u1 = x1.to(dt)[None, :, :] * inv_l[:, None, :]
        u2 = x2.to(dt)[None, :, :] * inv_l[:, None, :]
        c0 = self.c0(u1, u2) if c0 is None else c0.to(dt)

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
        glens = torch.stack(
            [torch.sum(self.lens(w, u1[:, :, j][:, :, None],
                                 u2[:, :, j][:, None, :]),
                       dim=(-2, -1)) * inv_l[:, j] for j in range(d)],
            dim=-1)                                                # (q, d)
        return (glens.to(lengthscales.dtype), gamp.to(amplitudes.dtype),
                gnug.to(nuggets.dtype))

    def fused_plain(self, x, lengthscales, amplitudes, nuggets, *, M, alpha,
                    beta: float, w):
        """The plain VJP of the same-point Gram at the cotangent
        ``alpha_k M_k + beta w_k w_k^T``, formed (the JAX package forms it
        at ``likelihood.py:231-234`` with M = B^{-1}, alpha = D/2,
        beta = -1/2)."""
        return self.vjp_plain(x, x, lengthscales, amplitudes, nuggets,
                              same=True,
                              cbar=fused_cotangent(M, alpha, beta, w))

    def scale(self, x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
              cbar, c0=None):
        """The magnitude each output of the VJP is a sum of: the VJP's terms
        taken with |cbar| and every sign made positive, so (glens, gamp,
        gnug) of non-negative sums.  A kernel's rounding error in a sum is
        judged against this, not against the sum, which cancels near an
        optimum.  Every family's lengthscale term is non-negative."""
        amp = torch.atleast_1d(amplitudes).to(cbar.dtype)
        nug = torch.atleast_1d(nuggets).to(cbar.dtype)
        a = cbar.abs()
        # same=False leaves out the diagonal terms; their magnitudes go back
        glens, gamp, gnug = self.vjp_plain(x1, x2, lengthscales, amplitudes,
                                           nuggets, same=False, cbar=a,
                                           c0=c0)
        gnug = gnug.abs()
        if same:
            diag = torch.diagonal(a, dim1=-2, dim2=-1).sum(-1)
            gamp = gamp + nug / (1.0 + nug) * diag
            gnug = gnug + amp * diag / torch.square(1.0 + nug)
        return glens, gamp, gnug

    def launch_vjp(self, x1, x2, lengthscales, amplitudes, nuggets, *,
                   same: bool, M, alpha=None, beta: float = 0.0, w=None):
        """Launch the VJP kernel on CUDA tensors; returns (glens (q,d),
        gamp (q,), gnug (q,)) and counts the launch.

        The cotangent is ``alpha_k M_k + beta w_k w_k^T`` (alpha None reads
        as ones, w None drops the second term); it is never formed.
        Launches on the current stream and does not synchronise."""
        from ._build import build

        what = f"{self.name} VJP kernel"
        q, n1, n2, d = check_inputs(what, x1, x2, lengthscales, amplitudes,
                                    nuggets, None, None, same)
        dt = x1.dtype
        for name, t, shape in (('M', M, (q, n1, n2)), ('w', w, (q, n1)),
                               ('alpha', alpha, (q,))):
            if t is not None:
                _check_operand(what, name, t, x1, shape)
        if w is not None and not same:
            raise ValueError(f"{what}: w needs same=True")
        if w is None and beta != 0.0:
            raise ValueError(f"{what}: beta without w")

        lib = build().lib
        f32 = dt == torch.float32
        fn = getattr(lib,
                     f"lcgp_{self.name}_gram_vjp_{'f32' if f32 else 'f64'}")
        inv_l = (1.0 / lengthscales).contiguous()
        glens = torch.empty((q, d), dtype=dt, device=x1.device)
        gamp = torch.empty((q,), dtype=dt, device=x1.device)
        gnug = torch.empty((q,), dtype=dt, device=x1.device)
        # every family's VJP takes the same scratch
        partials = torch.empty(
            (lib.lcgp_matern32_gram_vjp_scratch(q, n1, n2, d),),
            dtype=torch.float64, device=x1.device)

        with torch.cuda.device(x1.device):
            stream = torch.cuda.current_stream(x1.device).cuda_stream
            err = fn(_ptr(x1), _ptr(x2), _ptr(inv_l), _ptr(amplitudes),
                     _ptr(nuggets), _ptr(M), _ptr(w), _ptr(alpha),
                     float(beta), int(same), q, n1, n2, d, _ptr(partials),
                     _ptr(glens), _ptr(gamp), _ptr(gnug), stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")
        self.vjp.launches += 1
        self.vjp.launches_f32 += int(f32)
        return glens, gamp, gnug

    def _vjp(self, x1, x2, lengthscales, amplitudes, nuggets, *, same: bool,
             cbar, c0=None):
        """(glens, gamp, gnug) for a Gram-stack cotangent ``cbar``: the
        plain VJP on CPU tensors; on CUDA tensors the kernel, which
        recomputes C0 and ignores ``c0``."""
        if x1.device.type == 'cpu':
            return self.vjp_plain(x1, x2, lengthscales, amplitudes, nuggets,
                                  same=same, cbar=cbar, c0=c0)
        return self.launch_vjp(x1, x2, torch.atleast_2d(lengthscales),
                               torch.atleast_1d(amplitudes),
                               torch.atleast_1d(nuggets), same=same, M=cbar)

    def vjp_fused(self, x, lengthscales, amplitudes, nuggets, *, M, alpha,
                  beta: float, w):
        """(glens, gamp, gnug) of the same-point Gram at the cotangent
        ``alpha_k M_k + beta w_k w_k^T``.

        The VJP runs in M's dtype, as the JAX VJPs run in the cotangent's
        (``lcgp_tpu/ops/matern.py:108-112``), and the results come back in
        the parameters' dtypes.  CPU tensors form the cotangent and run the
        plain VJP; CUDA tensors run the kernel, which reads M and w and
        never forms the cotangent."""
        dt = M.dtype
        alpha, w = alpha.to(dt), w.to(dt)
        if x.device.type == 'cpu':
            return self.fused_plain(x, lengthscales, amplitudes, nuggets,
                                    M=M, alpha=alpha, beta=beta, w=w)
        # the kernel takes every operand in one dtype
        xc, ls, amp, nug = (t.to(dt).contiguous() for t in
                            (x, lengthscales, amplitudes, nuggets))
        got = self.launch_vjp(xc, xc, ls, amp, nug, same=True, M=M,
                              alpha=alpha.contiguous(), beta=beta,
                              w=w.contiguous())
        return tuple(g.to(p.dtype) for g, p in
                     zip(got, (lengthscales, amplitudes, nuggets)))

    def vjp_x_plain(self, x1, x2, lengthscales, amplitudes, nuggets, *, M):
        """The plain PyTorch VJP of :meth:`plain` with respect to x2, in
        M's dtype: gx2 (n2, d) for the cotangent M (q, n1, n2), with

            dC/dx2_bj = amp (1-eta) C0 slope(a_j, b_j) / l_j

        (the nugget's diagonal does not depend on x).  The VJP with respect
        to x1 is this function of (x2, x1, M^T)."""
        return self._vjp_x_sum(x1, x2, lengthscales, amplitudes, nuggets, M,
                               magnitude=False)

    def scale_x(self, x1, x2, lengthscales, amplitudes, nuggets, *, M):
        """The magnitude each entry of :meth:`vjp_x_plain` is a sum of: its
        terms taken with |M| and |slope|.  K5's rounding error is judged
        against this, as the VJP's against :meth:`scale`."""
        return self._vjp_x_sum(x1, x2, lengthscales, amplitudes, nuggets,
                               M.abs(), magnitude=True)

    def _vjp_x_sum(self, x1, x2, lengthscales, amplitudes, nuggets, M, *,
                   magnitude: bool):
        lengthscales = torch.atleast_2d(lengthscales)
        dt = M.dtype
        inv_l = (1.0 / lengthscales).to(dt)
        u1 = x1.to(dt)[None, :, :] * inv_l[:, None, :]
        u2 = x2.to(dt)[None, :, :] * inv_l[:, None, :]
        amp = torch.atleast_1d(amplitudes).to(dt)
        nug = torch.atleast_1d(nuggets).to(dt)
        w = M * (amp * (1.0 - nug / (1.0 + nug)))[:, None, None] \
            * self.c0(u1, u2)
        cols = []
        for j in range(x1.shape[1]):
            slope = self.slope(u1[:, :, j][:, :, None], u2[:, :, j][:, None, :])
            if magnitude:
                slope = slope.abs()
            cols.append(torch.einsum('kab,kab,k->b', w, slope, inv_l[:, j]))
        return torch.stack(cols, dim=-1)

    def launch_vjp_x(self, x1, x2, lengthscales, amplitudes, nuggets, *, M):
        """Launch K5 on CUDA tensors: gx2 (n2, d) for the cotangent M
        (q, n1, n2); counts the launch.  Launches on the current stream and
        does not synchronise."""
        from ._build import build

        what = f"{self.name} VJP-x kernel"
        q, n1, n2, d = check_inputs(what, x1, x2, lengthscales, amplitudes,
                                    nuggets, None, None, False)
        _check_operand(what, 'M', M, x1, (q, n1, n2))
        lib = build().lib
        f32 = x1.dtype == torch.float32
        fn = getattr(lib,
                     f"lcgp_{self.name}_gram_vjp_x_{'f32' if f32 else 'f64'}")
        inv_l = (1.0 / lengthscales).contiguous()
        gx = torch.empty((n2, d), dtype=x1.dtype, device=x1.device)
        partials = torch.empty((lib.lcgp_gram_vjp_x_scratch(n1, n2, d),),
                               dtype=torch.float64, device=x1.device)
        with torch.cuda.device(x1.device):
            stream = torch.cuda.current_stream(x1.device).cuda_stream
            err = fn(_ptr(x1), _ptr(x2), _ptr(inv_l), _ptr(amplitudes),
                     _ptr(nuggets), _ptr(M), q, n1, n2, d, _ptr(partials),
                     _ptr(gx), stream)
        if err != 0:
            raise RuntimeError(f"{what} launch failed: cudaError {err}")
        self.vjp_x.launches += 1
        self.vjp_x.launches_f32 += int(f32)
        return gx

    def _vjp_x(self, x1, x2, lengthscales, amplitudes, nuggets, *, M):
        """gx2 (n2, d) for a Gram-stack cotangent M: the plain version on
        CPU tensors, K5 on CUDA tensors."""
        if x1.device.type == 'cpu':
            return self.vjp_x_plain(x1, x2, lengthscales, amplitudes,
                                    nuggets, M=M)
        return self.launch_vjp_x(x1, x2, torch.atleast_2d(lengthscales),
                                 torch.atleast_1d(amplitudes),
                                 torch.atleast_1d(nuggets), M=M)


FAMILIES = {f.name: f for f in (
    Family('matern32', 'K1', 'Matern32', _matern32_c0, _matern32_lens,
           _matern32_slope),
    Family('matern52', 'K3', 'Matern52', _matern52_c0, _matern52_lens,
           _matern52_slope),
    Family('rbf', 'K4', 'SE', _rbf_c0, _rbf_lens, _rbf_slope),
)}


def family(kind: str) -> Family:
    """The family of a ``kernel=`` kind; an unknown kind raises
    ``ValueError``."""
    if kind not in FAMILIES:
        raise ValueError(f"unknown kernel kind {kind!r}")
    return FAMILIES[kind]
