"""The LCGP model class (counterpart of ``lcgp_tpu/models/lcgp.py``).

Same constructor surface, parameter accessors, ``loss``/``fit``/``predict``,
aux accessors, npz ``save``/``load`` format and fit checkpoints as
``lcgp_tpu.LCGP``, for ``submethod='full'`` and ``'rep'``, every
``precision`` (``'high'`` float64, ``'mixed'`` refined f32 factors,
``'fast'`` float32, ``'auto'``) and every ``kernel`` (``'matern32'``,
``'matern52'``, ``'rbf'``), and the FITC inducing-point approximation
(``inducing=``, ``n_chunk=``, :meth:`LCGP.refine_inducing`; its npz files
too), and the multi-device paths over ``torch.distributed``
(``lcgp_tpu_torch/parallel``): ``fit(mesh=...)`` on a ('comp','out'),
('n',) or ('comp','n') mesh and :meth:`LCGP.set_mesh`, the exact path and
FITC (``parallel/fitc_shard.py``) alike.  NumPy or tensors in, tensors on
``device`` out (float64, or float32 latents under ``'fast'``).

On a mesh every rank runs the same program: each constructs the same model
and makes the same calls in the same order, and every call that reaches the
mesh (``fit(mesh=)``, :meth:`LCGP.set_mesh`, and with a mesh ``loss()``,
the aux accessors, ``predict``, ``refine_inducing`` and ``save``) is a
collective that every rank of the mesh must make.
"""
from __future__ import annotations

import json
import math
import os
from typing import Optional

import numpy as np
import torch

from ..config import dtype_for, jitter_for
from ..fit import minimize_adam, minimize_lbfgs, minimize_lbfgs_jax
from ..ops import linalg
from ..ops import mixed as mixed_ops
from . import basis as basis_mod
from . import likelihood as lik
from . import params as P
from . import predict as pred
from . import sparse
from . import transforms as tx
from .replication import group_replicates

_F64 = torch.float64


def _resolve_device(device) -> torch.device:
    device = torch.device(device)
    if device.type == 'cuda' and not torch.cuda.is_available():
        raise RuntimeError(
            "LCGP(device='cuda'): CUDA is not available.  Pass device='cpu' "
            "to run the plain PyTorch path on the CPU.")
    return device


def _same_device(a: torch.device, b: torch.device) -> bool:
    """a and b name one device ('cuda' is the current card)."""
    def full(d):
        if d.type == 'cuda' and d.index is None:
            return torch.device('cuda', torch.cuda.current_device())
        return d
    return full(torch.device(a)) == full(torch.device(b))


class LCGP:
    """Latent Component Gaussian Process in PyTorch."""

    def __init__(self,
                 y=None,
                 x=None,
                 q: Optional[int] = None,
                 var_threshold: Optional[float] = None,
                 diag_error_structure: Optional[list] = None,
                 parameter_clamp_flag: bool = False,
                 robust_mean: bool = True,
                 submethod: str = 'full',
                 rep_standardize_ybar: bool = True,
                 verbose: bool = False,
                 precision: str = 'high',
                 q_chunk: Optional[int] = None,
                 kernel: str = 'matern32',
                 inducing=None,
                 n_chunk: Optional[int] = None,
                 device='cuda'):
        if y is None or x is None:
            raise ValueError('LCGP requires both y (p, n) and x (n, d).')
        if submethod not in ('full', 'rep'):
            raise ValueError("Invalid submethod. Choices are 'full' or 'rep'.")
        if kernel not in ('matern32', 'matern52', 'rbf'):
            raise ValueError("kernel must be 'matern32', 'matern52', or 'rbf'")

        self.device = _resolve_device(device)
        self.verbose = verbose
        self.robust_mean = robust_mean
        self.rep_standardize_ybar = rep_standardize_ybar
        self.parameter_clamp_flag = parameter_clamp_flag
        # precision='auto' resolves to 'mixed' at n >= _AUTO_MIXED_N and
        # 'high' below, once n is known (the rep grouping can shrink it)
        self.precision = precision
        if precision == 'auto':
            self._compute_dtype = None
            self._jitter = jitter_for('high')
        else:
            self._compute_dtype = (None if precision == 'high'
                                   else dtype_for(precision))
            self._jitter = jitter_for(precision)
        self._q_chunk_arg = q_chunk
        self.q_chunk = q_chunk
        self._n_chunk_arg = n_chunk
        self.kernel = kernel
        self.method = 'LCGP'
        self.submethod = submethod

        self.x = self._verify_data_types(x)
        self.y = self._verify_data_types(y)

        if (q is not None) and (var_threshold is not None):
            raise ValueError('Include only q or var_threshold but not both.')
        self.q = q
        self.var_threshold = var_threshold

        self.n, self.d, self.p = self.verify_dim(self.y, self.x)

        self.x_orig = self.x
        self.y_orig = self.y

        # x is standardized on the full inputs in both submethods; xnorm
        # (an O(n^2) host diagnostic nothing reads) is formed on access
        self.x, self.x_min, self.x_max = tx.standardize_x(self.x)
        self._xnorm_cache = None
        if self.submethod == 'rep':
            # self.y stays the raw (p, N) y: the noise init reads it
            (self.x_unique, self.x_unique_s, self.group_ids, self.r,
             self.ybar, self.ybar_s, self.ybar_mean,
             self.ybar_std) = self._group(self.x_orig, self.y_orig)
            self.n = int(self.x_unique.shape[0])
        else:
            self.y, self.ymean, self.ystd, _ = self.init_standard_y(self.y)

        if self.precision == 'auto':
            self.precision = ('mixed' if self.n >= self._AUTO_MIXED_N
                              else 'high')
            self._compute_dtype = (None if self.precision == 'high'
                                   else dtype_for(self.precision))
            self._jitter = jitter_for(self.precision)
            if self.verbose:
                print(f"[lcgp_tpu_torch] precision='auto' -> "
                      f"{self.precision!r} (n={self.n})")

        # SVD basis on the host; q is resolved there, shapes fixed after
        b = basis_mod.init_phi(self._get_phi_input().cpu().numpy(), q=self.q,
                               var_threshold=var_threshold)
        self.g = self._tensor(b.g)
        self.phi = self._tensor(b.phi)
        self.diag_D = self._tensor(b.diag_D)
        self.q = b.q
        self.g_var = self._tensor(b.g_var)
        if self.verbose:
            print('variance of latent g:', b.g_var)

        if self._q_chunk_arg is None:
            self.q_chunk = self._auto_q_chunk(int(self.q), int(self.n),
                                              self.device, self.precision)
        elif self._q_chunk_arg <= 0:
            self.q_chunk = None

        if diag_error_structure is None:
            self.diag_error_structure = [1] * int(self.p)
        else:
            self.diag_error_structure = list(diag_error_structure)
        self.verify_error_structure(self.diag_error_structure, self.y)
        self._sigma_map = P.sigma_index_map(self.diag_error_structure,
                                            self.device)

        self._free = P.init_values(self.x.cpu().numpy(), self.y.cpu().numpy(),
                                   self.q, self.diag_error_structure,
                                   self.device)
        self._params_version = 0
        self._aux = None
        self._aux_version = -1
        # the ('n',) or ('comp','n') mesh of fit(mesh=...) or set_mesh; with
        # one, loss, aux and predict run n-sharded (parallel/nshard.py)
        self._n_mesh = None
        # FITC's variance-clamp statistics of the last predict, as device
        # scalars (count, worst, total) read only by _fitc_clamp_stats; None
        # on the exact path or before a predict
        self._fitc_clamp_accum = None
        self._in_batched_predict = False
        self._predict_pad_cols = 0
        self._data = self._build_data()

        # FITC/Nystrom inducing points, standardized: an int m (greedy
        # farthest-point rows of the standardized design) or an (m, d)
        # array in original x units
        self._z = None
        if inducing is not None:
            xs_std = self._data.xs.cpu().numpy()
            if np.ndim(inducing) == 0:
                m = int(inducing)
                if m >= xs_std.shape[0]:
                    raise ValueError(
                        f'inducing={m} must be < n={xs_std.shape[0]} '
                        '(use the exact path instead)')
                z = sparse.select_inducing(xs_std, m)
            else:
                z = np.asarray(inducing, dtype=np.float64)
                if z.ndim < 2:
                    z = z[:, None]
                z = ((z - self.x_min.cpu().numpy())
                     / (self.x_max - self.x_min).cpu().numpy())
            self._z = self._tensor(z)

        # FITC n-axis streaming (sparse._fitc_stream): None = auto (stream
        # when the (q, n, m) panels outgrow the memory budget), an int = the
        # block size, 0 or negative = never stream
        self._n_chunk_arg = n_chunk
        self.n_chunk = None
        if self._z is not None:
            self.n_chunk = self._resolve_n_chunk()

    def _resolve_n_chunk(self):
        if self._n_chunk_arg is None:
            return self._auto_n_chunk(int(self.q), int(self.n),
                                      int(self._z.shape[0]), self.device,
                                      self.precision)
        return int(self._n_chunk_arg) if self._n_chunk_arg > 0 else None

    def _build_data(self):
        if self.submethod == 'rep':
            use_std = self.rep_standardize_ybar
            scale = (self.ybar_std[:, 0] if use_std
                     else torch.ones(int(self.p), dtype=_F64,
                                     device=self.device))
            return lik.RepData(xs=self.x_unique_s,
                               ybar=self.ybar_s if use_std else self.ybar,
                               scale=scale, r=self.r.to(_F64), phi=self.phi,
                               diag_D=self.diag_D, sigma_map=self._sigma_map)
        return lik.FullData(xs=self.x, ys=self.y, phi=self.phi,
                            diag_D=self.diag_D, sigma_map=self._sigma_map)

    # ------------------------------------------------------------------
    # Display
    # ------------------------------------------------------------------
    def __repr__(self):
        lLmb, lLmb0, lsigma2s, lnugGPs = self.get_param()

        def fmt(a):
            return np.array2string(a.cpu().numpy(), precision=4, threshold=8)

        params = (f"\t\tLatent GP lengthscale (lLmb):\t{fmt(lLmb)}\n"
                  f"\t\tLatent GP scale (lLmb0):\t{fmt(lLmb0)}\n"
                  f"\t\tDiagonal error log-variance:\t{fmt(lsigma2s)}\n"
                  f"\t\tLatent GP nugget scale:\t{fmt(lnugGPs)}")
        return ('LCGP(\n'
                f'\tsubmethod:\t{self.submethod}\n'
                f'\toutput dimension:\t{int(self.p)}\n'
                f'\tnumber of latent components:\t{int(self.q)}\n'
                f'\tparameter_clamping:\t{self.parameter_clamp_flag}\n'
                f'\trobust_standardization:\t{self.robust_mean}\n'
                f'\tdiagonal_error structure:\t{self.diag_error_structure}\n'
                f'\tparameters:\t\n{params}\n)')

    # ------------------------------------------------------------------
    # Utils: type checks, dims, transforms
    # ------------------------------------------------------------------
    def _tensor(self, a) -> torch.Tensor:
        # a copy: arrays from JAX or np.load may be read-only
        return torch.as_tensor(np.array(a, dtype=np.float64), dtype=_F64,
                               device=self.device)

    def _param(self, v) -> torch.Tensor:
        # C-contiguous: the CUDA kernel takes the (q, d) lengthscales as a
        # dense row-major block, and NumPy arrays may arrive Fortran-ordered
        return torch.as_tensor(v, dtype=_F64, device=self.device).contiguous()

    def _verify_data_types(self, t) -> torch.Tensor:
        if isinstance(t, torch.Tensor):
            t = t.to(device=self.device, dtype=_F64)
        else:
            t = self._tensor(t)
        if t.ndim < 2:
            t = t[:, None]
        return t.contiguous()

    # The checks below raise AssertionError, as lcgp_tpu's asserts do, but
    # explicitly so that they survive python -O.
    def verify_dim(self, y, x):
        p, ny = y.shape[0], y.shape[1]
        nx, d = x.shape[0], x.shape[1]
        if ny != nx:
            raise AssertionError('Number of inputs (x) differs from number of '
                                 'outputs (y), y.shape[1] != x.shape[0]')
        return int(nx), int(d), int(p)

    @staticmethod
    def verify_error_structure(diag_error_structure, y):
        if sum(diag_error_structure) != y.shape[0]:
            raise AssertionError(
                'Sum of error_structure should equal the output dimension.')
        if not all(g > 0 for g in diag_error_structure):
            raise AssertionError('Error structure groups must be positive.')

    def tx_x(self, xs):
        return xs * (self.x_max - self.x_min) + self.x_min

    @property
    def xnorm(self):
        """Per-dimension mean positive pairwise |x_i - x_j| of the raw x
        (reference lcgp.py:304-310), computed on first access."""
        if self._xnorm_cache is None:
            self._xnorm_cache = self._tensor(
                tx.xnorm(self.x_orig.cpu().numpy()))
        return self._xnorm_cache

    @staticmethod
    def init_standard_x(x):
        """(xs, x_min, x_max, x, xnorm) of x (n, d): x min-max scaled to
        [0, 1]^d and the per-dimension mean pairwise distance, on x's
        device."""
        x = torch.as_tensor(x, dtype=_F64)
        xs, x_min, x_max = tx.standardize_x(x)
        xnorm = torch.as_tensor(tx.xnorm(x.cpu().numpy()), dtype=_F64,
                                device=x.device)
        return xs, x_min, x_max, x, xnorm

    def init_standard_y(self, y):
        """(ys, center, spread, y): y (p, n) standardized per output row by
        median/MAD (robust_mean) or mean/std."""
        ys, c, sp = tx.standardize_y(y, self.robust_mean)
        return ys, c, sp, y

    def tx_y(self, ys):
        """Inverse y-standardization: by ymean/ystd on the full path, by
        ybar_mean/ybar_std on the rep path (the identity when
        rep_standardize_ybar is off)."""
        if self.submethod == 'rep':
            if self.rep_standardize_ybar:
                return ys * self.ybar_std + self.ybar_mean
            return ys
        return ys * self.ystd + self.ymean

    # ------------------------------------------------------------------
    # Replication structures (reference lcgp.py:397-434)
    # ------------------------------------------------------------------
    @property
    def R(self):
        """diag(r) as a dense matrix, formed on demand."""
        return torch.diag(self.r.to(_F64))

    def _group(self, x_raw, y_raw):
        """Group on the host; (x_unique, x_unique_s, group_ids, r, ybar,
        ybar_s, ybar_mean, ybar_std) on the device.  x_unique_s is scaled
        by the min/max of the full x; ybar is standardized per output row
        with zero spreads floored to 1."""
        rep = group_replicates(x_raw.cpu().numpy(), y_raw.cpu().numpy())
        x_unique = self._tensor(rep.x_unique)
        x_unique_s = ((x_unique - self.x_min)
                      / (self.x_max - self.x_min)).contiguous()
        ybar = self._tensor(rep.ybar)
        ybar_mean, ybar_std = tx.center_spread(ybar, self.robust_mean,
                                               floor_zero_spread=True)
        return (x_unique, x_unique_s,
                torch.as_tensor(rep.group_ids, device=self.device),
                torch.as_tensor(rep.r, device=self.device), ybar,
                (ybar - ybar_mean) / ybar_std, ybar_mean, ybar_std)

    def preprocess(self, y_raw=None, x_raw=None):
        """Replication structures as the reference's 12-tuple
        (lcgp.py:397-426): x_unique, x_unique_s, group_ids, r, R, ybar,
        ybar_s, ybar_mean, ybar_std, n_unique, d, p."""
        x_raw = self.x_orig if x_raw is None else self._verify_data_types(x_raw)
        y_raw = self.y_orig if y_raw is None else self._verify_data_types(y_raw)
        g = self._group(x_raw, y_raw)
        x_unique, r, ybar = g[0], g[3], g[4]
        return (*g[:4], torch.diag(r.to(_F64)), *g[4:],
                int(x_unique.shape[0]), int(x_unique.shape[1]),
                int(ybar.shape[0]))

    def _get_phi_input(self):
        """What the SVD basis is built from: standardized y (full), ybar_s
        or ybar (rep)."""
        if self.submethod != 'rep':
            return self.y
        return self.ybar_s if self.rep_standardize_ybar else self.ybar

    # ------------------------------------------------------------------
    # Parameters
    # ------------------------------------------------------------------
    @property
    def free(self) -> P.FreeParams:
        """The unconstrained parameters (the source of truth)."""
        return self._free

    @free.setter
    def free(self, value: P.FreeParams):
        self._free = P.FreeParams(*(self._param(v) for v in value))
        self._params_version += 1

    @property
    def lLmb(self):
        return P.constrain(self._free)[0]

    @property
    def lLmb0(self):
        return P.constrain(self._free)[1]

    @property
    def lsigma2s(self):
        return P.constrain(self._free)[2]

    @property
    def lnugGPs(self):
        return P.constrain(self._free)[3]

    def get_param(self):
        """(lLmb, lLmb0, per-output lsigma2s, lnugGPs) — grouped error
        log-variances expanded to (p,)."""
        lLmb, lLmb0, lsig_g, lnug = P.constrain(self._free)
        return lLmb, lLmb0, P.expand_sigma(lsig_g, self._sigma_map), lnug

    def set_params(self, lLmb=None, lLmb0=None, lsigma2s=None, lnugGPs=None):
        """Assign constrained parameter values (grouped lsigma2s)."""
        cur = P.constrain(self._free)
        new = (lLmb, lLmb0, lsigma2s, lnugGPs)
        vals = [c if v is None else self._param(v) for c, v in zip(cur, new)]
        self._free = P.unconstrain(*vals)
        self._params_version += 1

    def init_params(self):
        """Re-run the data-driven init (reference lcgp.py:490-513)."""
        self._free = P.init_values(self.x.cpu().numpy(), self.y.cpu().numpy(),
                                   self.q, self.diag_error_structure,
                                   self.device)
        self._params_version += 1

    # ------------------------------------------------------------------
    # Loss and fit
    # ------------------------------------------------------------------
    def loss(self) -> torch.Tensor:
        """Negative log marginal posterior at the current parameters (the
        rep loss is divided by the number of unique sites).  Under 'mixed'
        the refinement first ratchets up to the step count the current
        parameters' conditioning calls for (never down)."""
        if self.precision == 'mixed':
            self._sync_refine_steps()
        return (self.neglpost_rep() if self.submethod == 'rep'
                else self.neglpost())

    def neglpost(self) -> torch.Tensor:
        """The full-path loss at the current parameters: FITC's with
        inducing points, the exact one otherwise."""
        if self._z is not None:
            return self._fitc_loss(self._compute_dtype)(self._free, self._z)
        if self._n_mesh is not None:
            from ..parallel import nshard
            return nshard.neglpost_full_nsharded(
                self._free, self._data, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        return lik.neglpost_full(self._free, self._data,
                                 compute_dtype=self._compute_dtype,
                                 jitter=self._jitter, q_chunk=self.q_chunk,
                                 kernel=self.kernel)

    def neglpost_rep(self) -> torch.Tensor:
        """The rep-path loss at the current parameters: FITC's with
        inducing points, the exact one otherwise."""
        if self._z is not None:
            return self._fitc_loss(self._compute_dtype)(self._free, self._z)
        if self._n_mesh is not None:
            from ..parallel import nshard
            return nshard.neglpost_rep_nsharded(
                self._free, self._data, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        return lik.neglpost_rep(self._free, self._data,
                                compute_dtype=self._compute_dtype,
                                jitter=self._jitter, q_chunk=self.q_chunk,
                                kernel=self.kernel)

    def set_mesh(self, mesh):
        """Attach (or detach, with None) an ('n',) or ('comp','n') mesh
        (``parallel.nshard.make_n_mesh`` / ``make_nc_mesh``): ``loss()``,
        the aux and ``predict`` then run n-sharded (``parallel/nshard.py``,
        or ``parallel/fitc_shard.py`` for an inducing-point model), and
        each is a collective.  The mesh's device must be the model's; any
        other axis names raise ``ValueError``.  An inducing-point model
        takes the mesh's first rank's inducing points, so that every rank
        holds the same bits: attaching a mesh to it is a collective."""
        if mesh is not None:
            from ..parallel import nshard
            if not nshard.is_n_mesh(mesh):
                raise ValueError(
                    "set_mesh needs an ('n',) or ('comp','n') mesh "
                    "(parallel.nshard.make_n_mesh / make_nc_mesh); got "
                    f"axis names {tuple(mesh.axis_names)!r}")
            self._check_mesh_device(mesh)
            if self._z is not None:
                self._z = mesh.from_first(self._z)
        self._n_mesh = mesh
        self._aux = None
        self._aux_version = -1

    def _check_mesh_device(self, mesh):
        if not _same_device(mesh.device, self.device):
            raise ValueError(f'the mesh computes on {mesh.device}, the '
                             f'model lives on {self.device}; construct '
                             'the model on the mesh\'s device')

    def _sync_refine_steps(self):
        cur = mixed_ops.parse_refine(self._compute_dtype)
        rec = self.recommended_refine_steps()
        if cur is not None and rec > cur:
            self._set_refine_steps(rec)

    def recommended_refine_steps(self) -> int:
        """Refinement steps the conditioning of the current parameters
        calls for on the 'mixed' path (``lcgp_tpu/models/lcgp.py:518-546``).

        Proxy: a per-component bound on the factorization target's
        condition number, full: 1 + D_k amp_k n; rep: (amp_k n + max
        lam_k) / min lam_k.  One step contracts the factor error by
        ~eps32 cond, so one more step is needed per ~1/eps32 factor."""
        _, lLmb0, _, _ = P.constrain(self._free)
        amp = lLmb0.detach().cpu().numpy().astype(float)
        D = self.diag_D.cpu().numpy().astype(float)
        n = float(self.n)
        if self.submethod == 'rep':
            r = self.r.cpu().numpy().astype(float)
            lam = 1.0 / (D[:, None] * r[None, :])          # (q, n)
            cond = np.max((amp * n + lam.max(axis=1)) / lam.min(axis=1))
        else:
            cond = float(np.max(1.0 + D * amp * n))
        if not math.isfinite(cond) or cond <= 3e5:
            return 2
        if cond <= 3e7:
            return 3
        if cond <= 3e9:
            return 4
        return 5

    def _set_refine_steps(self, k: int):
        self._compute_dtype = ('mixed' if k == mixed_ops.DEFAULT_REFINE_STEPS
                               else f'mixed:{int(k)}')

    def _loss_fn(self, compute_dtype='model', jitter=None):
        """Loss closure; compute_dtype and jitter default to the model's
        precision, and the hybrid fit's f32 stage overrides them."""
        if compute_dtype == 'model':
            compute_dtype = self._compute_dtype
        if jitter is None:
            jitter = self._jitter
        if self._z is not None:
            fitc = self._fitc_loss(compute_dtype)
            return lambda free: fitc(free, self._z)
        return lik.make_loss(self.submethod, self._data,
                             compute_dtype=compute_dtype, jitter=jitter,
                             q_chunk=self.q_chunk, kernel=self.kernel)

    def _fitc_loss(self, compute_dtype):
        """(free, z) -> the FITC loss of the submethod: n-sharded on a
        mesh (``parallel/fitc_shard.py``, where a rank holds its whole
        block and ``n_chunk`` is not used), else one device's."""
        rep = self.submethod == 'rep'
        mesh = self._n_mesh
        if mesh is not None:
            from ..parallel import fitc_shard
            fitc = (fitc_shard.neglpost_rep_fitc_nsharded if rep
                    else fitc_shard.neglpost_full_fitc_nsharded)

            def loss(free, z):
                return fitc(free, self._data, z, mesh,
                            compute_dtype=compute_dtype, kernel=self.kernel)
            return loss
        fitc = sparse.neglpost_rep_fitc if rep else sparse.neglpost_full_fitc

        def loss(free, z):
            return fitc(free, self._data, z, compute_dtype=compute_dtype,
                        kernel=self.kernel, n_chunk=self.n_chunk)
        return loss

    # at this n, method='auto' stops letting the optimizer run unbounded
    _AUTO_ONDEVICE_N = 512
    # precision='auto' resolves to 'mixed' at this n (lcgp_tpu's threshold)
    _AUTO_MIXED_N = 2048

    def fit(self, verbose: bool = False, method: str = 'auto', **kwargs):
        """Optimize hyperparameters.

        method='auto'     : 'scipy' uncapped (parity semantics) for n < 512
                            (n counts unique sites on the rep path).  At
                            n >= 512, precision='fast' runs 'lbfgs-jax'
                            with plateau_rtol=1e-8; 'high' and 'mixed' run
                            'scipy' with a plateau stop (halt when the
                            relative loss decrease over the last
                            plateau_patience=20 iterations is below
                            plateau_rtol=1e-8) and maxiter=2000 as a
                            safety cap, whose stop is announced and
                            recorded in ``_fit_result.stop_reason``.
        method='scipy'    : scipy L-BFGS-B over the loss and its gradient
                            (the reference's semantics; kwargs: scipy
                            options, plateau_patience, plateau_rtol,
                            callback).
        method='adam'     : Adam on the device (kwargs: steps,
                            learning_rate, block_steps, callback).
        method='lbfgs-jax': the port of lcgp_tpu's on-device optax L-BFGS
                            (``fit/lbfgs.py``; kwargs: maxiter, tol,
                            block_iters, linesearch, plateau_rtol,
                            callback).
        method='hybrid'   : an f32 'lbfgs-jax' stage (jitter 1e-6, maxiter
                            200 unless given), then a 'lbfgs-jax' polish in
                            the model's precision (polish_maxiter=60).

        Under precision='mixed' the fit starts at the refinement steps the
        current conditioning calls for, and re-runs (up to 3 times) with
        more steps when the fitted conditioning calls for them.

        checkpoint_path=... saves the free parameters, step and loss at
        every callback (each L-BFGS iteration or block, each Adam block);
        restore with :meth:`restore_checkpoint`.

        mesh=... (``lcgp_tpu_torch.parallel``) runs the fit over a mesh, a
        collective that every rank of the mesh calls alike.  An ('n',) or
        ('comp','n') mesh shards the n axis (``parallel/nshard.py``) and
        attaches the mesh (:meth:`set_mesh`), with the same
        ``method='auto'`` choice ('mixed' runs in f64 there); an
        inducing-point model runs n-sharded FITC
        (``parallel/fitc_shard.py``).  On a
        ('comp','out') mesh (``parallel.make_mesh``) method='auto' or
        'adam' runs ``parallel.fit_sharded`` (kwargs: steps,
        learning_rate, block_steps, plateau_rtol, plateau_patience,
        callback), and 'scipy' or 'lbfgs-jax' the single-device drivers
        over ``parallel.mesh.make_sharded_loss``; the fitted parameters are
        alike on every rank, and the model keeps no mesh.  Any other axis
        names raise ``ValueError``, as does an inducing-point model on a
        ('comp','out') mesh.  Checkpoints are written by the mesh's first
        rank only.
        """
        mesh = kwargs.pop('mesh', None)
        checkpoint_path = kwargs.pop('checkpoint_path', None)
        if checkpoint_path is not None:
            # np.savez appends '.npz' when missing; normalize once so
            # restore_checkpoint(same_path) finds the file
            checkpoint_path = self._norm_ckpt_path(checkpoint_path)
            user_cb = kwargs.pop('callback', None)

            # on a mesh every rank holds the same parameters: one writes
            writer = mesh is None or mesh.is_first

            def _ckpt_cb(step, loss, params):
                def host(t):
                    return t.detach().cpu().numpy()
                if writer:
                    np.savez(checkpoint_path, step=step, loss=loss,
                             free_lLmb=host(params.lLmb),
                             free_lLmb0=host(params.lLmb0),
                             free_lsigma2s=host(params.lsigma2s),
                             free_lnugGPs=host(params.lnugGPs))
                if user_cb is not None:
                    user_cb(step, loss, params)

            kwargs['callback'] = _ckpt_cb

        if mesh is not None:
            return self._fit_mesh(mesh, verbose, method, **kwargs)
        if method == 'auto':
            if self.n >= self._AUTO_ONDEVICE_N:
                if self.precision == 'fast':
                    method = 'lbfgs-jax'
                    kwargs.setdefault('plateau_rtol', 1e-8)
                else:
                    # convergence-based stop instead of a hand-tuned
                    # maxiter; maxiter stays only as a safety cap
                    method = 'scipy'
                    kwargs.setdefault('plateau_patience', 20)
                    kwargs.setdefault('plateau_rtol', 1e-8)
                    kwargs.setdefault('maxiter', 2000)
                if self.precision == 'high' and \
                        self.n >= self._AUTO_MIXED_N and \
                        (verbose or self.verbose) and \
                        not getattr(self, '_mixed_hint_shown', False):
                    self._mixed_hint_shown = True
                    print(f"[lcgp_tpu_torch.fit] hint: at n={self.n}, "
                          "precision='mixed' (or 'auto') gives an f64-grade "
                          "loss with f32-grade gradients; on an NVIDIA H100 "
                          "80GB HBM3 (700 W) its loss+grad took 3.4x the "
                          "f64 time at n=4096 (PERF.md)")
            else:
                method = 'scipy'
            if verbose or self.verbose:
                print(f'[lcgp_tpu_torch.fit] auto-selected method={method!r} '
                      f'(n={self.n}, {kwargs})')
        if method == 'hybrid':
            fast_loss = self._loss_fn(compute_dtype=torch.float32,
                                      jitter=1e-6)
            polish_maxiter = kwargs.pop('polish_maxiter', 60)
            # the f32 stage only needs to get close; the polish finishes the
            # convergence in model precision, so the cheap stage is capped
            kwargs.setdefault('maxiter', 200)
            res1 = minimize_lbfgs_jax(fast_loss, self._free, **kwargs)
            # the polish keeps the callback (checkpoints cover both stages)
            res = minimize_lbfgs_jax(self._loss_fn(), res1.params,
                                     maxiter=polish_maxiter,
                                     callback=kwargs.get('callback'))
            self._free = res.params
            self._params_version += 1
            self._fit_result = res
            return
        if self.precision == 'mixed':
            # start at the step count the current conditioning calls for
            self._set_refine_steps(max(
                self.recommended_refine_steps(),
                mixed_ops.parse_refine(self._compute_dtype)))
        self._run_optimizer(self._loss_fn(), method, verbose, **kwargs)
        if self.precision == 'mixed':
            # conditioning grows as amplitudes fit: escalate the refinement
            # and re-converge until the fitted conditioning is within it
            for _ in range(3):
                cur = mixed_ops.parse_refine(self._compute_dtype)
                rec = self.recommended_refine_steps()
                if rec <= cur:
                    break
                self._set_refine_steps(rec)
                if verbose or self.verbose:
                    print(f'[lcgp_tpu_torch.fit] mixed refinement escalated '
                          f'to {rec} steps (fitted conditioning); '
                          're-converging')
                self._run_optimizer(self._loss_fn(), method, verbose,
                                    **kwargs)

    def _run_optimizer(self, loss_fn, method, verbose, **kwargs):
        if method == 'scipy':
            res = minimize_lbfgs(loss_fn, self._free,
                                 verbose=verbose or self.verbose, **kwargs)
        elif method == 'adam':
            res = minimize_adam(loss_fn, self._free, **kwargs)
        elif method == 'lbfgs-jax':
            res = minimize_lbfgs_jax(loss_fn, self._free, **kwargs)
        else:
            raise ValueError(f'Unknown fit method {method!r}.')
        self._free = res.params
        self._params_version += 1
        self._fit_result = res
        reason = getattr(res, 'stop_reason', None)
        if reason == 'cap':
            # a budget-capped stop is always announced, never silent
            print(f'[lcgp_tpu_torch.fit] stopped on the iteration cap '
                  f'(nit={int(res.nit)}) before convergence; pass maxiter= '
                  'to raise the budget or method="scipy" for an uncapped '
                  'parity run.')
        elif (verbose or self.verbose) and reason is not None:
            print(f'[lcgp_tpu_torch.fit] converged: stop_reason={reason!r} '
                  f'nit={int(res.nit)} loss={float(res.fun):.8g}')
        return res

    def _fit_mesh(self, mesh, verbose, method, **kwargs):
        from ..parallel import mesh as mesh_mod
        from ..parallel import nshard
        axes = tuple(mesh.axis_names)
        if nshard.is_n_mesh(mesh):
            return self._fit_nsharded(mesh, verbose, method, **kwargs)
        if axes != ('comp', 'out'):
            raise ValueError(
                "fit(mesh=...) needs axis names ('n',), ('comp','n') or "
                f"('comp','out'); got {axes!r}.  Build one with "
                'parallel.make_mesh, parallel.nshard.make_n_mesh or '
                'parallel.nshard.make_nc_mesh.')
        if self._z is not None:
            raise ValueError(
                "inducing-point (FITC) models don't support the "
                "('comp','out') mesh (parallel.fit_sharded optimizes the "
                "exact loss)")
        self._check_mesh_device(mesh)
        opts = dict(compute_dtype=self._compute_dtype, jitter=self._jitter,
                    kernel=self.kernel)
        if method not in ('auto', 'adam'):
            self._run_optimizer(mesh_mod.make_sharded_loss(
                mesh, self._data, **opts), method, verbose, **kwargs)
            return
        kwargs.setdefault('verbose', verbose or self.verbose)
        free, res = mesh_mod.fit_sharded(self._data, self._free, mesh,
                                         **opts, **kwargs)
        self._free = free
        self._params_version += 1
        self._fit_result = res

    def _fit_nsharded(self, mesh, verbose=False, method='auto', **kwargs):
        """Fit with the n axis distributed over an ('n',) or ('comp','n')
        mesh: the loss and gradient of ``parallel/nshard.py`` (or
        ``parallel/fitc_shard.py`` for an inducing-point model), under the
        single-device optimizer loop (callbacks and checkpoints included).
        Attaches the mesh (:meth:`set_mesh`).  precision='mixed' runs in
        f64 here; 'fast' runs in f32."""
        from ..parallel import nshard
        self.set_mesh(mesh)
        if self._z is not None:
            loss_fn = self._loss_fn()
        else:
            loss_fn = nshard.make_loss(self.submethod, self._data, mesh,
                                       compute_dtype=self._compute_dtype,
                                       jitter=self._jitter,
                                       kernel=self.kernel)
        if method == 'auto':
            if self.precision == 'fast':
                method = 'lbfgs-jax'
                kwargs.setdefault('plateau_rtol', 1e-8)
            else:
                method = 'scipy'
                kwargs.setdefault('plateau_patience', 20)
                kwargs.setdefault('plateau_rtol', 1e-8)
                kwargs.setdefault('maxiter', 2000)
            if verbose or self.verbose:
                print(f'[lcgp_tpu_torch.fit] n-sharded over '
                      f'{mesh.size_total} ranks; auto-selected '
                      f'method={method!r}')
        return self._run_optimizer(loss_fn, method, verbose, **kwargs)

    @staticmethod
    def _norm_ckpt_path(path):
        path = str(path)
        return path if path.endswith('.npz') else path + '.npz'

    def restore_checkpoint(self, path):
        """Load free parameters from a fit(checkpoint_path=...) snapshot
        (either package's); returns (step, loss) recorded at the
        snapshot."""
        with np.load(self._norm_ckpt_path(path), allow_pickle=False) as z:
            self.free = P.FreeParams(z['free_lLmb'], z['free_lLmb0'],
                                     z['free_lsigma2s'], z['free_lnugGPs'])
            return int(z['step']), float(z['loss'])

    # Working-set fraction of the device memory the chunk planners size
    # against, and the budget where there is no device to ask (the CPU)
    _MEM_BUDGET_FRACTION = 10e9 / 15.75e9
    _MEM_BUDGET_DEFAULT = 10e9

    @classmethod
    def _mem_budget_bytes(cls, device: torch.device) -> float:
        """The working-set budget of the chunk planners, as lcgp_tpu's
        ``_hbm_budget_bytes`` resolves it: ``LCGP_TPU_HBM_BUDGET_BYTES``
        when set; on CUDA the fraction of the card's total memory (a fixed
        figure, as the TPU's ``bytes_limit`` is, so a decision does not
        depend on what the caching allocator holds); else the default."""
        env = os.environ.get('LCGP_TPU_HBM_BUDGET_BYTES')
        if env:
            return float(env)
        if device.type == 'cuda':
            total = torch.cuda.get_device_properties(device).total_memory
            return cls._MEM_BUDGET_FRACTION * float(total)
        return cls._MEM_BUDGET_DEFAULT

    @classmethod
    def _auto_q_chunk(cls, q: int, n: int, device: torch.device,
                      precision: str = 'high'):
        """Component-chunk size so the working set fits device memory, with
        the JAX package's peak model of ~8 transient (qc, n, n) stacks plus
        a (q, n, n) term: (8 qc + q) n^2 * itemsize, itemsize 4 under
        'fast' and 8 otherwise.  None = unchunked."""
        itemsize = 4 if precision == 'fast' else 8
        budget = cls._mem_budget_bytes(device)

        def peak(qc):
            return (8 * qc + q) * n * n * itemsize

        if peak(q) <= budget:
            return None
        for qc in range(q - 1, 0, -1):
            if q % qc == 0 and peak(qc) <= budget:
                return qc
        return 1

    @classmethod
    def _auto_n_chunk(cls, q: int, n: int, m: int, device: torch.device,
                      precision: str = 'high'):
        """The FITC n-axis block size (``sparse._fitc_stream``), as
        lcgp_tpu chooses it: the un-chunked backward holds about 4
        (q, n, m) panels, so stream once those outgrow the budget, in
        power-of-two blocks of about 256 MiB of panel (at least 4096
        points).  None = un-chunked."""
        itemsize = 4 if precision == 'fast' else 8
        if 4 * q * n * m * itemsize <= cls._mem_budget_bytes(device):
            return None
        per_point = q * m * itemsize
        block = max(4096, int(2 ** np.floor(
            np.log2(256 * 2**20 / per_point))))
        return min(block, n)

    def refine_inducing(self, steps: int = 200, learning_rate: float = 5e-3,
                        joint: bool = True, verbose: bool = False):
        """Gradient-refine the FITC inducing locations z (greedy
        farthest-point init) by minimizing the FITC loss with Adam.

        joint=True optimizes z together with the hyperparameters;
        joint=False holds the hyperparameters fixed and moves only z.
        Returns the final loss.  z stays unconstrained: the kernel is
        defined everywhere, and projecting back to [0, 1]^d would undo the
        optimization.  On CUDA the gradient in z is K5's.  On a mesh the
        loss is n-sharded FITC's, K5 runs on each rank's block and z's
        gradient is summed over the ranks (a collective)."""
        if self._z is None:
            raise ValueError('refine_inducing requires an inducing-point '
                             'model (construct with inducing=...)')
        fitc = self._fitc_loss(self._compute_dtype)
        if joint:
            def loss(tree):
                return fitc(tree['free'], tree['z'])
            tree0 = {'free': self._free, 'z': self._z}
        else:
            def loss(tree):
                return fitc(self._free, tree['z'])
            tree0 = {'z': self._z}
        res = minimize_adam(loss, tree0, steps=steps,
                            learning_rate=learning_rate, verbose=verbose)
        self._z = res.params['z'].contiguous()
        if joint:
            self._free = res.params['free']
        self._params_version += 1
        return float(res.fun)

    # ------------------------------------------------------------------
    # Prediction
    # ------------------------------------------------------------------
    def _ensure_aux(self):
        """The predictive aux (FullAux, RepAux, FitcAux or, on an n-mesh,
        NShardAux, or FitcAux built n-sharded) at the current parameters,
        rebuilt after any parameter change.  FITC and the n-mesh under
        'mixed' build it in f64: FITC's (m, m) systems are f64 by design,
        and the distributed factor takes no refinement."""
        if self._aux is None or self._aux_version != self._params_version:
            self._aux = None   # free the old factor before building the new
            if self._z is not None and self._n_mesh is not None:
                from ..parallel import fitc_shard
                self._aux = fitc_shard.compute_aux_fitc_nsharded(
                    self._free, self._data, self._z, self.submethod,
                    self._n_mesh,
                    compute_dtype=(None if self.precision == 'mixed'
                                   else self._compute_dtype),
                    kernel=self.kernel)
            elif self._n_mesh is not None:
                from ..parallel import nshard
                self._aux = nshard.compute_aux_nsharded(
                    self._free, self._data, self._n_mesh,
                    compute_dtype=(None if self.precision == 'mixed'
                                   else self._compute_dtype),
                    jitter=self._jitter, kernel=self.kernel)
            elif self._z is not None:
                aux_dtype = (None if self.precision == 'mixed'
                             else self._compute_dtype)
                self._aux = sparse.compute_aux_fitc(
                    self._free, self._data, self._z, self.submethod,
                    compute_dtype=aux_dtype, kernel=self.kernel,
                    n_chunk=self.n_chunk)
            else:
                compute = (pred.compute_aux_rep if self.submethod == 'rep'
                           else pred.compute_aux_full)
                self._aux = compute(self._free, self._data,
                                    compute_dtype=self._compute_dtype,
                                    jitter=self._jitter, kernel=self.kernel,
                                    q_chunk=self.q_chunk)
            self._aux_version = self._params_version
        return self._aux

    def compute_aux_predictive_quantities(self):
        self._aux = None
        self._ensure_aux()

    # The aux accessors of lcgp_tpu (lcgp.py:1066-1152); each returns None
    # on the submethod it does not belong to, and every dense factor's
    # returns None on an inducing-point model.  They dispatch on the aux's
    # type, as the reference's _is_nshard_aux does: on an exact n-mesh the
    # factor and dual weights are gathered from the ranks (a collective)
    # and trimmed of the n padding and of the 'comp' axis's q padding; a
    # FITC model's aux is a replicated FitcAux on a mesh too.
    @staticmethod
    def _is_nshard_aux(aux) -> bool:
        from ..parallel.nshard import NShardAux
        return isinstance(aux, NShardAux)

    @property
    def CinvMs(self):
        """(q, n) dual weights (FITC's ``u``)."""
        aux = self._ensure_aux()
        if self._is_nshard_aux(aux):
            from ..parallel import nshard
            u = nshard.gather_u(self._n_mesh, aux)
            return u[:int(self.q), :int(self.n)]
        return aux.u if self._z is not None else aux.CinvM

    def _dense_factor(self):
        """The (q, n, n) factor on every path: on an n-mesh gathered and
        trimmed (the leading block of the padded factor is the unpadded
        factor, its pad rows decoupled identity rows, and the padded
        components trail)."""
        aux = self._ensure_aux()
        if self._is_nshard_aux(aux):
            from ..parallel import nshard
            n = int(self.n)
            L = nshard.gather_factor(self._n_mesh, aux)
            return L[:int(self.q), :n, :n]
        return aux.LB if self.submethod != 'rep' else aux.LT

    @property
    def LBs(self):
        """Full path: chol(I + D_k C_k), the factor the predictions use."""
        if self.submethod == 'rep' or self._z is not None:
            return None
        return self._dense_factor()

    @property
    def Ths(self):
        """Full path: the reference's Th_k (lcgp.py:709-715), the symmetric
        square root of D_k (I + D_k C_k)^{-1}, rebuilt from ``LBs`` by one
        batched eigh.  The predictions never form it."""
        if self.submethod == 'rep' or self._z is not None:
            return None
        LB = self._dense_factor()
        wB, U = torch.linalg.eigh(LB @ LB.mT)           # B = U diag(wB) U^T
        scal = torch.sqrt(self.diag_D[:, None].to(wB.dtype) / wB)
        return torch.einsum('qij,qj,qkj->qik', U, scal, U)

    @property
    def LTs(self):
        """Rep path: chol(C_k + diag(1/(d_k r)))."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        return self._dense_factor()

    @property
    def Tks(self):
        """Rep path: the reference's T_k (lcgp.py:783-788), equal to
        (C_k + (d_k R)^{-1})^{-1}, rebuilt from ``LTs`` on access."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        LT = self._dense_factor()
        eye = torch.eye(LT.shape[-1], dtype=LT.dtype, device=LT.device)
        return linalg.cho_solve(LT, eye.expand_as(LT))

    @property
    def mks(self):
        """Rep path: (q, n) latent means at the training sites (None on an
        exact n-mesh, which does not form them)."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        return None if self._is_nshard_aux(aux) else aux.mks

    @property
    def psi_c(self):
        """Rep path: (q, p) Phi^T Sigma_used^{-1/2} (None on an exact
        n-mesh)."""
        if self.submethod != 'rep' or self._z is not None:
            return None
        aux = self._ensure_aux()
        return None if self._is_nshard_aux(aux) else aux.psi_c

    def predict(self, x0, return_fullcov: bool = False,
                batch_size: Optional[int] = None):
        """Predict at x0 (n0, d) -> tuple of (p, n0) tensors.

        batch_size: evaluate test points in fixed-shape chunks of this many
        (the last chunk is padded by repeating its final row); None predicts
        in one shot.  Not combined with return_fullcov.  On an
        inducing-point model the clamp statistics of the variances cover
        the user's points of the whole call, not the padding.
        """
        x0 = self._verify_data_types(x0)
        predict_call = (self.predict_rep if self.submethod == 'rep'
                        else self.predict_full)
        if batch_size is None:
            return predict_call(x0=x0, return_fullcov=return_fullcov)
        if return_fullcov:
            raise ValueError('batch_size is not supported with '
                             'return_fullcov=True.')
        n0 = x0.shape[0]
        self._fitc_clamp_accum = None
        self._in_batched_predict = True
        try:
            chunks = []
            for s in range(0, n0, batch_size):
                blk = x0[s:s + batch_size]
                pad = batch_size - blk.shape[0]
                if pad:
                    blk = torch.cat([blk, blk[-1:].repeat(pad, 1)])
                self._predict_pad_cols = pad
                out = predict_call(x0=blk, return_fullcov=False)
                chunks.append([o[:, :batch_size - pad] if pad else o
                               for o in out])
        finally:
            self._in_batched_predict = False
            self._predict_pad_cols = 0
        return tuple(torch.cat([c[i] for c in chunks], dim=1)
                     for i in range(3))

    def _standardize_x0(self, x0):
        x0 = self._verify_data_types(x0)
        return ((x0 - self.x_min) / (self.x_max - self.x_min)).contiguous()

    def _record_clamp_stats(self, count, worst, total: int):
        """Accumulate FITC's variance-clamp statistics on the device; the
        host reads them only through ``_fitc_clamp_stats``."""
        prev = self._fitc_clamp_accum
        if prev is None:
            self._fitc_clamp_accum = (count, worst, int(total))
        else:
            self._fitc_clamp_accum = (prev[0] + count,
                                      torch.minimum(prev[1], worst),
                                      prev[2] + int(total))

    @property
    def _fitc_clamp_stats(self):
        """FITC's clamped predictive variances in the last predict call:
        dict(n_clamped, total, frac, worst), or None."""
        acc = self._fitc_clamp_accum
        if acc is None:
            return None
        count, worst, total = int(acc[0]), float(acc[1]), int(acc[2])
        return dict(n_clamped=count, total=total,
                    frac=count / total if total else 0.0, worst=worst)

    def _latent_predict(self, aux, x0s):
        if self._z is not None:
            ghat, gvar = sparse.predict_fitc_core(
                self._free, self._data, aux, self._z, x0s,
                compute_dtype=self._compute_dtype, kernel=self.kernel)
            # statistics over the user's columns only, not batch padding
            pad = self._predict_pad_cols
            stats_src = gvar[:, :gvar.shape[-1] - pad] if pad else gvar
            _, count, worst = sparse.clamp_variance(stats_src)
            self._record_clamp_stats(count, worst, stats_src.numel())
            return ghat, torch.clamp_min(gvar, 0.0)
        if self._is_nshard_aux(aux):
            from ..parallel import nshard
            return nshard.predict_nsharded_core(
                self._free, self._data, aux, x0s, self._n_mesh,
                compute_dtype=self._compute_dtype, jitter=self._jitter,
                kernel=self.kernel)
        core = (pred.predict_rep_core if self.submethod == 'rep'
                else pred.predict_full_core)
        return core(self._free, self._data, aux, x0s,
                    compute_dtype=self._compute_dtype, jitter=self._jitter,
                    kernel=self.kernel, q_chunk=self.q_chunk)

    def predict_full(self, x0, return_fullcov: bool = False):
        aux = self._ensure_aux()
        if not self._in_batched_predict:
            self._fitc_clamp_accum = None
        x0s = self._standardize_x0(x0)
        ghat, gvar = self._latent_predict(aux, x0s)
        self.ghat, self.gvar = ghat, gvar
        ypred, ypredvar, yconfvar = pred.recombine_full(
            self._free, self._data, ghat, gvar, self.ymean, self.ystd)
        if return_fullcov:
            yfullpredcov = pred.fullcov_full(self._free, self._data, gvar,
                                             self.ystd)
            return ypred, ypredvar, yconfvar, yfullpredcov
        return ypred, ypredvar, yconfvar

    def predict_rep(self, x0, return_fullcov: bool = False):
        aux = self._ensure_aux()
        if not self._in_batched_predict:
            self._fitc_clamp_accum = None
        x0s = self._standardize_x0(x0)
        ghat, gvar = self._latent_predict(aux, x0s)
        self.ghat, self.gvar = ghat, gvar
        if self.rep_standardize_ybar:
            mean, std = self.ybar_mean, self.ybar_std
        else:
            mean = torch.zeros_like(self.ybar_mean)
            std = torch.ones_like(self.ybar_std)
        ypred, ypredvar, yconfvar = pred.recombine_rep(
            self._free, self._data, ghat, gvar, mean, std)
        if return_fullcov:
            # the full predictive covariance is full-path only
            # (reference lcgp.py:928-929)
            return ypred, ypredvar, yconfvar, None
        return ypred, ypredvar, yconfvar

    # ------------------------------------------------------------------
    # Persistence: the npz format of lcgp_tpu.LCGP.save/load
    # ------------------------------------------------------------------
    def save(self, path):
        """Write the npz of ``lcgp_tpu.LCGP.save``.  On an n-mesh (a
        collective) the mesh's first rank writes and every rank waits for
        it: the parameters are alike on every rank."""
        mesh = self._n_mesh
        if mesh is not None and not mesh.is_first:
            mesh.barrier()
            return
        lLmb, lLmb0, lsig_g, lnug = P.constrain(self._free)
        cfg = dict(q=int(self.q), var_threshold=self.var_threshold,
                   diag_error_structure=list(self.diag_error_structure),
                   parameter_clamp_flag=self.parameter_clamp_flag,
                   robust_mean=self.robust_mean, submethod=self.submethod,
                   rep_standardize_ybar=self.rep_standardize_ybar,
                   precision=self.precision, kernel=self.kernel,
                   q_chunk=self.q_chunk, n_chunk=self._n_chunk_arg)

        def host(t):
            return t.cpu().numpy()

        extra = {}
        if self._z is not None:
            extra['inducing_z_std'] = host(self._z)
        np.savez(path,
                 config=json.dumps(cfg),
                 x_orig=host(self.x_orig),
                 y_orig=host(self.y_orig),
                 **extra,
                 # free (unconstrained) values are the source of truth so the
                 # roundtrip is exact; constrained values stored for inspection
                 free_lLmb=host(self._free.lLmb),
                 free_lLmb0=host(self._free.lLmb0),
                 free_lsigma2s=host(self._free.lsigma2s),
                 free_lnugGPs=host(self._free.lnugGPs),
                 lLmb=host(lLmb), lLmb0=host(lLmb0),
                 lsigma2s=host(lsig_g), lnugGPs=host(lnug))
        if mesh is not None:
            mesh.barrier()

    @classmethod
    def load(cls, path, device='cuda'):
        with np.load(path, allow_pickle=False) as npz:
            z = dict(npz)
        cfg = json.loads(str(z['config']))
        model = cls(y=z['y_orig'], x=z['x_orig'],
                    q=cfg['q'], var_threshold=None,
                    diag_error_structure=cfg['diag_error_structure'],
                    parameter_clamp_flag=cfg['parameter_clamp_flag'],
                    robust_mean=cfg['robust_mean'], submethod=cfg['submethod'],
                    rep_standardize_ybar=cfg['rep_standardize_ybar'],
                    precision=cfg.get('precision', 'high'),
                    kernel=cfg.get('kernel', 'matern32'),
                    q_chunk=cfg.get('q_chunk'), device=device)
        model.free = P.FreeParams(z['free_lLmb'], z['free_lLmb0'],
                                  z['free_lsigma2s'], z['free_lnugGPs'])
        if 'inducing_z_std' in z:
            model._z = model._tensor(z['inducing_z_std'])
            # the constructor saw no inducing set; resolve n_chunk now that
            # the (q, n, m) panel's size is known
            model._n_chunk_arg = cfg.get('n_chunk')
            model.n_chunk = model._resolve_n_chunk()
        return model
