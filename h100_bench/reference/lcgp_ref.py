"""Plain reference of the LCGP model: standardisation, the SVD basis, the
data-driven init, the Matérn 3/2 Gram, the exact and the FITC negative log
posterior with their gradients, and the exact and FITC predictive mean and
variances.

Written from the model's equations (the LCGP paper's and the published
``lcgp`` package's conventions), in plain PyTorch and NumPy, with no kernel,
cache or batching of the package under test; it imports nothing of it.

- Standardisation: x min-max scaled to [0, 1]^d; each output row of y
  centred by its median and scaled by its median absolute deviation.
- Basis: Y = U S V^T (thin SVD of the standardised outputs), phi = U_q
  sqrt(n) / s_q, D_k = |phi_k|^2.
- Kernel: C(u, v) = amp ((1 - eta) prod_j (1 + S_j) e^{-sum_j S_j} + eta
  [same points]), S_j = |u_j - v_j| / l_j, eta = nug / (1 + nug).
- Exact loss: with a_k = Y^T phi_k / sqrt(sigma) and B_k = D_k C_k + I,
  sum_k [0.5 logdet B_k - 0.5 a_k^T C_k B_k^{-1} a_k] + 0.5 n sum log sigma
  + 0.5 |Y / sqrt(sigma)|^2.
- FITC: C replaced by Q = Knm Kmm^{-1} Kmn plus the diagonal correction,
  through W = Knm Lmm^{-T} and Woodbury, summed over blocks of rows.

Every function takes the compute dtype: float64 is the reference; a lower
dtype gives the control of the benchmark's correctness check.
"""
from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch
from torch.utils.checkpoint import checkpoint

F64 = torch.float64
LEAVES = ("lLmb", "lLmb0", "lsigma2s", "lnugGPs")
# the constraint intervals (SoftClip with hinge softness 1) of lcgp's
# lengthscales, amplitudes and nugget scales; error log-variances are free
CLIP = {"lLmb": (1e-6, 1e4), "lLmb0": (1e-4, 1e4),
        "lnugGPs": (math.exp(-16.0), math.exp(-2.0))}
# FITC: jitter on Kmm's diagonal relative to the amplitude, and the floor
# of the corrected diagonal
KMM_JITTER = 1e-8
LAM_FLOOR = 1e-10
# rows of a FITC panel block (each block's W is q * BLOCK * m entries), and
# of the sub-blocks whose products are summed in float64: the model states
# that FITC's n-length reductions accumulate in float64, so a lower-precision
# control lowers the products and keeps that accumulation
BLOCK = 32768
SUB = 1024


class Problem(NamedTuple):
    """The standardised data and basis of one configuration, on a device."""
    xs: torch.Tensor        # (n, d) in [0, 1]^d
    ys: torch.Tensor        # (p, n) standardised outputs
    x_min: torch.Tensor     # (d,)
    x_max: torch.Tensor     # (d,)
    ymed: torch.Tensor      # (p, 1)
    ymad: torch.Tensor      # (p, 1)
    phi: torch.Tensor       # (p, q)
    D: torch.Tensor         # (q,)


def prepare(x: torch.Tensor, y: torch.Tensor, q: int) -> Problem:
    """Standardise x (n, d) and y (p, n) and build the q-component basis
    (SVD on the host, in float64)."""
    x = x.to(F64)
    x_min, x_max = x.min(0).values, x.max(0).values
    xs = (x - x_min) / (x_max - x_min)
    yh = y.to(F64).cpu().numpy()
    med = np.median(yh, axis=1, keepdims=True)
    mad = np.median(np.abs(yh - med), axis=1, keepdims=True)
    ysh = (yh - med) / mad
    n = ysh.shape[1]
    u, s, _ = np.linalg.svd(ysh, full_matrices=False)
    phi = u[:, :q] * np.sqrt(n) / s[:q]
    dev = x.device

    def t(a):
        return torch.as_tensor(np.ascontiguousarray(a), dtype=F64, device=dev)
    return Problem(xs=xs, ys=t(ysh), x_min=x_min, x_max=x_max, ymed=t(med),
                   ymad=t(mad), phi=t(phi), D=t(np.sum(phi ** 2, axis=0)))


def _softplus(x):
    return torch.logaddexp(x, torch.zeros_like(x))


def _clip(x, lo, hi):
    return torch.clamp(lo + _softplus(x - lo) - _softplus(x - hi), lo, hi)


def _unclip(y, lo, hi):
    u = y - lo
    return lo + u + torch.log1p(-torch.exp(-u)) - torch.log1p(
        -torch.exp(u - (hi - lo)))


def constrain(free: dict) -> dict:
    """Unconstrained leaves -> the model's parameters."""
    return {k: (_clip(v, *CLIP[k]) if k in CLIP else v)
            for k, v in free.items()}


def init_free(prob: Problem) -> dict:
    """The data-driven init, unconstrained: lengthscales sqrt(d) times each
    input's spread, amplitudes 1, nuggets e^-10, and each output's error
    log-variance the log of its standardised variance (one group an
    output)."""
    xs = prob.xs.cpu().numpy()
    ys = prob.ys.cpu().numpy()
    q, d = prob.phi.shape[1], xs.shape[1]
    dev = prob.xs.device
    ll = np.tile(np.sqrt(d) * np.std(xs, axis=0), (q, 1))
    con = {"lLmb": ll, "lLmb0": np.ones(q),
           "lsigma2s": np.log(np.var(ys, axis=1)),
           "lnugGPs": np.full(q, math.exp(-10.0))}
    return {k: (_unclip(torch.as_tensor(v, dtype=F64, device=dev), *CLIP[k])
                if k in CLIP else torch.as_tensor(v, dtype=F64, device=dev))
            for k, v in con.items()}


def gram(x1, x2, ls, amp, nug, same: bool):
    """Matérn 3/2 Gram stack (q, n1, n2) of x1 (n1, d) and x2 (n2, d) at
    lengthscales (q, d), amplitudes and nuggets (q,), in x1's dtype."""
    u1 = x1[None] / ls[:, None, :]
    u2 = x2[None] / ls[:, None, :]
    prod = None
    ssum = None
    for j in range(x1.shape[1]):
        s = torch.abs(u1[:, :, j, None] - u2[:, None, :, j])
        prod = 1.0 + s if prod is None else prod * (1.0 + s)
        ssum = s if ssum is None else ssum + s
    c0 = prod * torch.exp(-ssum)
    eta = nug / (1.0 + nug)
    c = (1.0 - eta)[:, None, None] * c0
    if same:
        c = c + eta[:, None, None] * torch.eye(
            x1.shape[0], dtype=c.dtype, device=c.device)
    return amp[:, None, None] * c


def _sigma(con):
    return torch.exp(con["lsigma2s"])


def _noise_terms(con, prob, dt):
    lsig = con["lsigma2s"]
    n = prob.ys.shape[1]
    ys = prob.ys.to(dt)
    return (0.5 * n * torch.sum(lsig)
            + 0.5 * torch.sum(torch.square(ys / torch.sqrt(
                _sigma(con).to(dt))[:, None])))


def _a(con, prob, dt, k=None):
    """a_k = Y^T phi_k / sqrt(sigma): (q, n), or (n,) for one component."""
    psi = prob.phi / torch.sqrt(_sigma(con))[:, None]
    if k is not None:
        return prob.ys.to(dt).T @ psi[:, k].to(dt)
    return (prob.ys.to(dt).T @ psi.to(dt)).T


def _leaves(free: dict, grad: bool, dt):
    return {k: v.detach().to(dt).clone().requires_grad_(grad)
            for k, v in free.items()}


def _result(loss, leaves, grad: bool):
    g = ({k: leaves[k].grad.to(F64) for k in LEAVES} if grad else None)
    return float(loss.detach()) if torch.is_tensor(loss) else float(loss), g


def exact_loss(free: dict, prob: Problem, dt=F64, grad: bool = False):
    """(loss, gradient by leaf or None) of the exact negative log posterior,
    one component at a time (its gradient accumulates into the leaves, so
    that one (n, n) Gram and its factor live at a time)."""
    lv = _leaves(free, grad, dt)
    xs, D = prob.xs.to(dt), prob.D.to(dt)
    n = xs.shape[0]
    eye = torch.eye(n, dtype=dt, device=xs.device)
    total = 0.0
    with torch.set_grad_enabled(grad):
        for k in range(prob.phi.shape[1]):
            con = constrain(lv)
            C = gram(xs, xs, con["lLmb"][k:k + 1], con["lLmb0"][k:k + 1],
                     con["lnugGPs"][k:k + 1], same=True)[0]
            L = torch.linalg.cholesky(D[k] * C + eye)
            a = _a(con, prob, dt, k)
            w = torch.cholesky_solve(a[:, None], L)[:, 0]
            t = (torch.sum(torch.log(torch.diagonal(L)))
                 - 0.5 * torch.dot(a, C @ w))
            if grad:
                t.backward()
            total += float(t.detach())
            del C, L
        tail = _noise_terms(constrain(lv), prob, dt)
        if grad:
            tail.backward()
    return _result(total + float(tail.detach()), lv, grad)


def _kmm_chol(con, z):
    """chol(Kmm + KMM_JITTER amp I) in float64, Kmm = C(z, z) without the
    nugget's diagonal."""
    z64 = z.to(F64)
    amp = con["lLmb0"].to(F64)
    Kmm = gram(z64, z64, con["lLmb"].to(F64), amp, con["lnugGPs"].to(F64),
               same=False)
    eye = torch.eye(z.shape[0], dtype=F64, device=z.device)
    return torch.linalg.cholesky(Kmm + KMM_JITTER * amp[:, None, None] * eye)


def _panel(con, xs_b, z, Lmm, lam, dt):
    """W = Knm Lmm^{-T} (q, nb, m) and the corrected diagonal Lam~ (q, nb)
    of one block of rows, in dt."""
    Knm = gram(xs_b.to(dt), z.to(dt), con["lLmb"].to(dt),
               con["lLmb0"].to(dt), con["lnugGPs"].to(dt), same=False)
    W = torch.linalg.solve_triangular(Lmm.to(dt), Knm.mT, upper=False).mT
    qd = torch.sum(W * W, dim=-1)
    amp = con["lLmb0"].to(dt)[:, None]
    lam_t = torch.clamp(lam.to(dt)[:, None]
                        + torch.clamp(amp - qd, min=0.0), min=LAM_FLOOR)
    return W, lam_t


def _sum_products(a, b):
    """sum_rows a^T b of a (q, nb, m) and b (q, nb, k): each SUB rows' product
    in their dtype, the products added in float64."""
    q, nb, m = a.shape
    k = b.shape[-1]
    full = nb - nb % SUB
    out = torch.sum(a[:, :full].reshape(q, -1, SUB, m).mT
                    @ b[:, :full].reshape(q, -1, SUB, k), dim=1, dtype=F64)
    if full < nb:
        out = out + (a[:, full:].mT @ b[:, full:]).to(F64)
    return out


def _fitc_block(lam, dt, z, Lmm, xs_b, b_b, *free_vals):
    """One block's sums: G = W^T Lam~^{-1} W, t = W^T (lam b / Lam~),
    sum log Lam~, sum lam b^2, sum lam b^2 lam / Lam~ (float64)."""
    con = constrain(dict(zip(LEAVES, free_vals)))
    W, lam_t = _panel(con, xs_b, z, Lmm, lam, dt)
    lb = lam.to(dt)[:, None] * b_b.to(dt)
    vi = lb / lam_t
    G = _sum_products(W, W / lam_t[..., None])
    t = _sum_products(W, vi[..., None])[..., 0]
    return (G, t, torch.sum(torch.log(lam_t.to(F64)), dim=-1),
            torch.sum((lb * b_b.to(dt)).to(F64), dim=-1),
            torch.sum((lb * vi).to(F64), dim=-1))


def _fitc_sums(con, lv, prob, z, dt, grad):
    """The block sums over all rows, each block rematerialised in the
    backward; and Lmm."""
    Lmm = _kmm_chol(con, z)
    lam = 1.0 / prob.D
    b = _a(con, prob, F64)
    sums = None
    n = prob.xs.shape[0]
    for s in range(0, n, BLOCK):
        args = (lam, dt, z, Lmm, prob.xs[s:s + BLOCK], b[:, s:s + BLOCK],
                *(lv[k] for k in LEAVES))
        part = (checkpoint(_fitc_block, *args, use_reentrant=False)
                if grad else _fitc_block(*args))
        sums = part if sums is None else tuple(
            a + p for a, p in zip(sums, part))
    return Lmm, sums


def fitc_loss(free: dict, prob: Problem, z: torch.Tensor, dt=F64,
              grad: bool = False):
    """(loss, gradient by leaf or None) of the FITC negative log posterior
    at inducing points z (m, d), standardised.  The n-sized work runs in dt
    over blocks of BLOCK rows; the (m, m) systems in float64."""
    lv = _leaves(free, grad, F64)
    n = prob.xs.shape[0]
    with torch.set_grad_enabled(grad):
        con = constrain(lv)
        _, (G, t, sumlog, bb, bu) = _fitc_sums(con, lv, prob, z, dt, grad)
        eye = torch.eye(z.shape[0], dtype=F64, device=z.device)
        LM = torch.linalg.cholesky(G + eye)
        s = torch.cholesky_solve(t[..., None], LM)[..., 0]
        quad = bb - bu + torch.sum(t * s, dim=-1)
        ld = sumlog + 2.0 * torch.sum(
            torch.log(torch.diagonal(LM, dim1=-2, dim2=-1)), dim=-1)
        loss = (torch.sum(0.5 * (n * torch.log(prob.D) + ld) - 0.5 * quad)
                + _noise_terms(con, prob, F64))
        if grad:
            loss.backward()
    return _result(loss, lv, grad)


def _recombine(con, prob, ghat, gvar):
    """Latent mean and variance (q, n0) -> (ypred, ypredvar, yconfvar),
    each (p, n0), in the output's units."""
    sigma = _sigma(con)
    psi = prob.phi.T * torch.sqrt(sigma)[None, :]               # (q, p)
    mean = psi.T @ ghat.to(F64)
    conf = (gvar.to(F64).T @ torch.square(psi)).T
    s2 = torch.square(prob.ymad)
    return (mean * prob.ymad + prob.ymed, (conf + sigma[:, None]) * s2,
            conf * s2)


def _std_x(prob, x0):
    return (x0.to(F64) - prob.x_min) / (prob.x_max - prob.x_min)


@torch.no_grad()
def exact_predict(free: dict, prob: Problem, x0: torch.Tensor, dt=F64):
    """Exact predictive (ypred, ypredvar, yconfvar) at x0 (n0, d), raw
    units: latent mean K0 B^{-1} a and variance amp - D |L_B^{-1} K0^T|^2."""
    con = {k: v.to(dt) for k, v in constrain(free).items()}
    xs, D = prob.xs.to(dt), prob.D.to(dt)
    x0s = _std_x(prob, x0).to(dt)
    n = xs.shape[0]
    a = _a(constrain(free), prob, dt)
    eye = torch.eye(n, dtype=dt, device=xs.device)
    ghat, gvar = [], []
    for k in range(prob.phi.shape[1]):
        sl = slice(k, k + 1)
        args = (con["lLmb"][sl], con["lLmb0"][sl], con["lnugGPs"][sl])
        L = torch.linalg.cholesky(D[k] * gram(xs, xs, *args, same=True)[0]
                                  + eye)
        K0 = gram(x0s, xs, *args, same=False)[0]
        ghat.append(K0 @ torch.cholesky_solve(a[k][:, None], L)[:, 0])
        M = torch.linalg.solve_triangular(L, K0.T, upper=False)
        gvar.append(con["lLmb0"][k] - D[k] * torch.sum(M * M, dim=0))
        del L, K0, M
    return _recombine(constrain(free), prob, torch.stack(ghat),
                      torch.stack(gvar))


@torch.no_grad()
def fitc_predict(free: dict, prob: Problem, z: torch.Tensor,
                 x0: torch.Tensor, dt=F64):
    """FITC predictive (ypred, ypredvar, yconfvar) at x0 (n0, d), raw
    units: latent mean W0 (t - G M^{-1} t), variance amp - diag(W0 G M^{-1}
    W0^T) clamped at 0, with W0 = K0m Lmm^{-T} and M = I + G."""
    con = constrain(free)
    Lmm, (G, t, _, _, _) = _fitc_sums(con, free, prob, z, dt, False)
    eye = torch.eye(z.shape[0], dtype=F64, device=z.device)
    LM = torch.linalg.cholesky(G + eye)
    s = torch.cholesky_solve(t[..., None], LM)[..., 0]
    alpha = t - (G @ s[..., None])[..., 0]
    inner = G @ torch.cholesky_inverse(LM)
    inner = 0.5 * (inner + inner.mT)
    x0s = _std_x(prob, x0)
    K0m = gram(x0s.to(dt), z.to(dt), con["lLmb"].to(dt),
               con["lLmb0"].to(dt), con["lnugGPs"].to(dt), same=False)
    W0 = torch.linalg.solve_triangular(Lmm.to(dt), K0m.mT, upper=False).mT
    ghat = (W0 @ alpha.to(dt)[..., None])[..., 0]
    W0 = W0.to(F64)
    red = torch.sum((W0 @ inner) * W0, dim=-1)
    gvar = torch.clamp(con["lLmb0"][:, None] - red, min=0.0)
    return _recombine(con, prob, ghat, gvar)


def select_inducing(xs: np.ndarray, m: int) -> np.ndarray:
    """Greedy farthest-point choice of m rows of xs (n, d): first the row
    nearest the mean, then each time the row farthest from those chosen.
    Returns the (m, d) rows in the order chosen."""
    xs = np.asarray(xs, dtype=np.float64)
    idx = [int(np.argmin(np.linalg.norm(xs - xs.mean(0), axis=1)))]
    d2 = np.sum((xs - xs[idx[0]]) ** 2, axis=1)
    for _ in range(m - 1):
        nxt = int(np.argmax(d2))
        idx.append(nxt)
        d2 = np.minimum(d2, np.sum((xs - xs[nxt]) ** 2, axis=1))
    return xs[np.asarray(idx)]


def flat(tree: dict) -> torch.Tensor:
    """The leaves in the model's order, flattened row-major."""
    return torch.cat([tree[k].reshape(-1).to(F64) for k in LEAVES])


def unflat(vec, like: dict) -> dict:
    """A flat vector back into leaves shaped as ``like``."""
    out, ofs = {}, 0
    vec = torch.as_tensor(vec, dtype=F64, device=like["lLmb"].device)
    for k in LEAVES:
        size = like[k].numel()
        out[k] = vec[ofs:ofs + size].reshape(like[k].shape)
        ofs += size
    return out
