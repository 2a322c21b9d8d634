"""Batched Cholesky primitives (counterpart of ``lcgp_tpu/ops/linalg.py``).

Thin ``torch.linalg`` wrappers over a leading component/batch axis.  From
two 512-blocks up, the factor (outside autograd), the triangular inverse
and B^{-1} are blocked, in place, in gemms that follow the operands'
triangles; below, they are single cuSOLVER/cuBLAS calls.  The structured triangular
products at the end (syrk, trmm, ...) are ported with their 512-blocking:
the mixed-precision refinement (``ops/mixed.py``) is made of them.
"""
from __future__ import annotations

import torch


def add_diag(mats: torch.Tensor, vals) -> torch.Tensor:
    """mats (..., n, n) plus vals on the diagonal; vals is a scalar or
    broadcastable to (..., n).  Returns a new tensor."""
    out = mats.clone()
    out.diagonal(dim1=-2, dim2=-1).add_(
        torch.as_tensor(vals, dtype=mats.dtype, device=mats.device))
    return out


def cholesky(mats: torch.Tensor, overwrite: bool = False) -> torch.Tensor:
    """Batched lower Cholesky; only the lower triangle of ``mats`` is read,
    and the factor's strict upper triangle is zero.

    Keeps the JAX contract for a matrix that is not positive definite: the
    lower triangle of its factor comes back NaN, and nothing raises.
    ``torch.linalg.cholesky`` would raise instead, and on CUDA would
    synchronise with the host to find out.

    From two blocks up (n >= ``_BLOCKED_MIN_N``), in f64 or f32, and where
    autograd does not record the input, the factor is the blocked
    right-looking form of ``_cholesky_blocked_`` (its n^3/3 flops in
    gemms), formed in one (..., n, n) buffer: with ``overwrite=True``, for
    a caller that gives the input up, the input's own storage (when it is
    contiguous), otherwise a copy.  Below, or under autograd (the FITC
    losses differentiate through their (m, m) factors): one
    ``cholesky_ex`` call, whose NaN mask is written in place except where
    autograd records the factor.  The counters ``cholesky.blocked`` and
    ``.dense`` count the calls that took each path."""
    n = mats.shape[-1]
    if (n < _BLOCKED_MIN_N or mats.dtype not in _CHOL_BLOCKED_DTYPES
            or (torch.is_grad_enabled() and mats.requires_grad)):
        _CHOLESKY.dense += 1
        L, info = torch.linalg.cholesky_ex(mats, check_errors=False)
        lower = torch.ones((n, n), dtype=torch.bool,
                           device=mats.device).tril_()
        mask = (info > 0)[..., None, None] & lower
        if L.requires_grad:
            return L.masked_fill(mask, float('nan'))
        return L.masked_fill_(mask, float('nan'))
    _CHOLESKY.blocked += 1
    buf = (mats if overwrite and mats.is_contiguous()
           else mats.clone(memory_format=torch.contiguous_format))
    _cholesky_blocked_(buf.view(-1, n, n))
    return buf


def chol_logdet(chols: torch.Tensor) -> torch.Tensor:
    """logdet(A) from L with A = L L^T, batched; the n-length sum is taken
    in f64 even for f32 factors."""
    diag = torch.diagonal(chols, dim1=-2, dim2=-1)
    return 2.0 * torch.sum(torch.log(diag).to(torch.float64), dim=-1)


def solve_tri_lower(chols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """L^{-1} rhs with lower-triangular L; rhs (..., n, m)."""
    return torch.linalg.solve_triangular(chols, rhs, upper=False, left=True)


def cho_solve(chols: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs; rhs (..., n, m)."""
    z = torch.linalg.solve_triangular(chols, rhs, upper=False, left=True)
    return torch.linalg.solve_triangular(chols.mT, z, upper=True, left=True)


def cho_solve_vec(chols: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} v with v (..., n)."""
    return cho_solve(chols, vecs[..., :, None])[..., :, 0]


def tri_inverse_lower(chols: torch.Tensor) -> torch.Tensor:
    """L^{-1} for lower-triangular L, batched; a fresh tensor, lower
    triangular (L's strict upper triangle is not read).

    From two blocks up (n >= ``_BLOCKED_MIN_N``) the blocked inverse of
    ``_tri_inverse_blocked_`` (~n^3/3 flops, in gemms); below, one
    triangular solve against I (n^3 flops, cuBLAS trsm on CUDA).  The
    counters ``tri_inverse_lower.blocked`` and ``.dense`` count the calls
    that took each path."""
    if chols.shape[-1] < _BLOCKED_MIN_N:
        _TRI_INVERSE_LOWER.dense += 1
        return _tri_inverse_solve(chols)
    _TRI_INVERSE_LOWER.blocked += 1
    n = chols.shape[-1]
    return _tri_inverse_blocked_(
        torch.tril(chols).reshape(-1, n, n)).reshape(chols.shape)


def chol_inverse(chols: torch.Tensor, overwrite: bool = False
                 ) -> torch.Tensor:
    """(L L^T)^{-1} = L^{-T} L^{-1} from the lower factor L, batched: the
    loss gradient's B^{-1}.  Exactly symmetric and row-major contiguous,
    which the K2 kernel needs.

    From two blocks up (n >= ``_BLOCKED_MIN_N``) it is formed in place in
    one (..., n, n) buffer: L^{-1} by the blocked triangular inverse, then
    the triangular Gram L^{-T} L^{-1} over it, 2n^3/3 flops in all against
    the dense form's 3n^3.  ``overwrite=True`` is for a caller that gives
    the factor up: the buffer is then L's own storage, and the result may
    share it.  Otherwise the buffer is a copy of L.  Only L's lower
    triangle is read.  Below two blocks: one triangular solve against I
    and one matmul.  The counters ``chol_inverse.blocked`` and ``.dense``
    count the calls that took each path.

    On an H100 (700 W) at (20, 4096, 4096) f64 the blocked form took
    33.0 ms in the factor's storage, the dense form 95.8 ms and
    ``torch.cholesky_inverse``, which computes the same, 307.2 ms
    (PERF.md)."""
    if chols.shape[-1] < _BLOCKED_MIN_N:
        _CHOL_INVERSE.dense += 1
        linv = _tri_inverse_solve(chols)
        inv = linv.mT @ linv
    else:
        _CHOL_INVERSE.blocked += 1
        # the port updates in place here to save memory: L, then L^{-1},
        # then B^{-1} live in one buffer
        n = chols.shape[-1]
        buf = (chols if overwrite else chols.clone()).reshape(-1, n, n)
        inv = _gram_tri_lower_(_tri_inverse_blocked_(buf)).reshape(
            chols.shape)
    # on CUDA the result can be column-major (the factor's or the
    # product's layout); the matrix is symmetric, so its transpose is the
    # same inverse with row-major strides (no copy)
    return inv if inv.is_contiguous() else inv.mT.contiguous()


# the path counters; the bodies reach them through these private names,
# so that a wrapper put in place of the module's attribute still counts
_CHOLESKY, _CHOL_INVERSE, _TRI_INVERSE_LOWER = (cholesky, chol_inverse,
                                                tri_inverse_lower)
cholesky.blocked = cholesky.dense = 0
chol_inverse.blocked = chol_inverse.dense = 0
tri_inverse_lower.blocked = tri_inverse_lower.dense = 0


def _tri_inverse_solve(chols: torch.Tensor) -> torch.Tensor:
    """L^{-1}: one triangular solve against I."""
    n = chols.shape[-1]
    eye = torch.eye(n, dtype=chols.dtype, device=chols.device)
    return torch.linalg.solve_triangular(chols, eye.expand_as(chols),
                                         upper=False, left=True)


# The blocked forms of L, L^{-1} and B^{-1} (counterparts of lcgp_tpu's
# cholesky_blocked, tri_inverse_lower/_tri_inverse_combine and
# gram_tri_lower).  Each works in place on one (b, n, n) buffer over
# _TRI_INV_BLOCK-blocks; what else they allocate is (b, nb, nb), and the
# factor's panel (b, n - e, nb).  An n that is not a block multiple ends in
# one narrower block (no zero padding, which would take a padded copy and
# a contiguous copy of its slice).
#
# _BLOCKED_MIN_N: the dense forms are used below it.  B^{-1} on an H100
# (700 W) at q = 20, f64, blocked against dense: 2.135 against 2.915 ms at
# n = 1024, 7.082 against 14.924 at 2048, 33.217 against 95.839 at 4096
# (PERF.md).  FITC's (m, m) inverses at m <= 512 stay dense.

_TRI_INV_BLOCK = 512
_BLOCKED_MIN_N = 2 * _TRI_INV_BLOCK


# The blocked factor against one batched cholesky_ex at (10, 4096, 4096)
# on an H100 (700 W): f64 15.8 against 36.4 ms, f32 16.5 against 27.9
# (PERF.md), so both dtypes take it.
_CHOL_BLOCKED_DTYPES = (torch.float64, torch.float32)


def _block_bounds(n: int, nb: int) -> list[int]:
    return list(range(0, n, nb)) + [n]


def _cholesky_blocked_(X: torch.Tensor) -> torch.Tensor:
    """Overwrite symmetric X (b, n, n), of which only the lower triangle is
    read, with its lower Cholesky factor and return it.

    Right-looking over the blocks [s, e): the diagonal block is factored
    by one batched ``cholesky_ex``; the panel below it becomes
    ``X[e:, s:e] L_kk^{-T}``, one bmm by the block's inverse (a solve
    against a block-sized I); then each block column j of the trailing
    matrix takes ``X[sj:, sj:ej] -= panel[sj:] panel[sj:ej]^T``, one
    in-place baddbmm into its lower strip, n^3/3 flops in all.  The strict
    upper triangle is zeroed.  A matrix whose ``info`` is positive at any
    step comes back with its whole lower triangle NaN, flagged on the
    device: nothing synchronises with the host.

    On an H100 (700 W) at (10, 4096, 4096) f64: the batched factor of a
    (10, 512, 512) block took 0.71 ms, one matrix at a time 2.23; the first
    panel by the inverse 0.49 + 0.33 ms, by a batched triangular solve
    1.39 (the whole factor 15.8 against 17.6 ms, with the same residual).
    Smaller blocks, or the diagonal block factored blocked in turn, were
    no faster (PERF.md)."""
    n = X.shape[-1]
    b = _block_bounds(n, _TRI_INV_BLOCK)
    bad = torch.zeros((X.shape[0], 1, 1), dtype=torch.bool, device=X.device)
    eye = torch.eye(_TRI_INV_BLOCK, dtype=X.dtype, device=X.device)
    for k, (s, e) in enumerate(zip(b[:-1], b[1:])):
        Lkk, info = torch.linalg.cholesky_ex(X[:, s:e, s:e],
                                             check_errors=False)
        X[:, s:e, s:e] = Lkk
        bad |= (info > 0)[:, None, None]
        if e == n:
            break
        X[:, s:e, e:].zero_()
        inv = torch.linalg.solve_triangular(
            Lkk, eye[:e - s, :e - s].expand_as(Lkk), upper=False)
        panel = X[:, e:, s:e] @ inv.mT
        X[:, e:, s:e] = panel
        for sj, ej in zip(b[k + 1:-1], b[k + 2:]):
            X[:, sj:, sj:ej].baddbmm_(panel[:, sj - e:],
                                      panel[:, sj - e:ej - e].mT, alpha=-1)
        del panel   # before the next step's, which is one block shorter
    lower = torch.ones((_TRI_INV_BLOCK,) * 2, dtype=torch.bool,
                       device=X.device).tril_()
    for s, e in zip(b[:-1], b[1:]):
        X[:, s:e, s:e].masked_fill_(bad & lower[:e - s, :e - s],
                                    float('nan'))
        X[:, e:, s:e].masked_fill_(bad, float('nan'))
    return X


def _tri_inverse_blocked_(X: torch.Tensor) -> torch.Tensor:
    """Overwrite lower-triangular X (b, n, n) with X^{-1} and return it.

    The diagonal blocks are inverted first, by solves against a
    block-sized I.  Then block (i, k) below the diagonal, taken column by
    column and downwards, is ``-inv_i @ (L[i, k:i] @ X[k:i, k])``: it
    reads row i of L left of the diagonal, still unwritten, and the
    blocks of column k above it, already inverted.  Only the lower
    triangle is read; above the diagonal only the diagonal blocks are
    written, with zeros."""
    _invert_diag_blocks_(X)
    b = _block_bounds(X.shape[-1], _TRI_INV_BLOCK)
    for k in range(len(b) - 2):
        ck = slice(b[k], b[k + 1])
        for i in range(k + 1, len(b) - 1):
            ci = slice(b[i], b[i + 1])
            acc = X[:, ci, b[k]:b[i]] @ X[:, b[k]:b[i], ck]
            torch.bmm(X[:, ci, ci], acc.neg_(), out=X[:, ci, ck])
    return X


def _invert_diag_blocks_(X: torch.Tensor) -> torch.Tensor:
    """Replace each diagonal block of lower-triangular X (b, n, n) by its
    inverse.  The whole blocks go two to a batched solve, a view of X with
    the blocks' stride.  On an H100 at (10, 4096, 4096) f64 the eight took
    4.04 ms in eight solves, 2.74 in four, 1.92 in one (PERF.md); two a
    solve keep the solve's copies of its operands at a 16th of X at
    n = 4096."""
    nb = _TRI_INV_BLOCK
    n = X.shape[-1]
    nd = n // nb
    sr, sc = X.stride(-2), X.stride(-1)
    step = nb * (sr + sc)
    eye = torch.eye(nb, dtype=X.dtype, device=X.device)
    for j in range(0, nd, 2):
        blocks = X.as_strided((X.shape[0], min(2, nd - j), nb, nb),
                              (X.stride(0), step, sr, sc),
                              X.storage_offset() + j * step)
        blocks.copy_(torch.linalg.solve_triangular(
            blocks, eye.expand_as(blocks), upper=False, left=True))
    if n % nb:
        tail = X[:, nd * nb:, nd * nb:]
        tail.copy_(_tri_inverse_solve(tail))
    return X


def _gram_tri_lower_(M: torch.Tensor) -> torch.Tensor:
    """Overwrite lower-triangular M (b, n, n) with M^T M, exactly
    symmetric, and return it (n^3/3 flops, as ``gram_tri_lower``).

    Block row i of the result's lower triangle contracts only over M's
    rows >= ib.  Its transpose, the block column above the diagonal block,
    is one gemm ``M[ib:, :ib]^T @ M[ib:, ib:ib+nb]`` written straight
    into M's upper triangle, which no later block reads; the diagonal block
    goes through a block-sized temporary.  The upper triangle is then
    mirrored into the lower one."""
    b = _block_bounds(M.shape[-1], _TRI_INV_BLOCK)
    for s, e in zip(b[:-1], b[1:]):
        col = M[:, s:, s:e]
        diag = col.mT @ col
        if s:
            torch.bmm(M[:, s:, :s].mT, col, out=M[:, :s, s:e])
        lower = torch.ones((e - s, e - s), dtype=torch.bool,
                           device=M.device).tril_()
        M[:, s:e, s:e] = torch.where(lower, diag, diag.mT)
    for s, e in zip(b[1:-1], b[2:]):
        M[:, s:e, :s] = M[:, :s, s:e].mT
    return M


def quad_chol(chols: torch.Tensor, vecs: torch.Tensor) -> torch.Tensor:
    """v^T (L L^T)^{-1} v, batched; v (..., n)."""
    z = solve_tri_lower(chols, vecs[..., :, None])[..., :, 0]
    return torch.sum(z * z, dim=-1)


# ---------------------------------------------------------------------------
# Structured triangular products (counterparts of lcgp_tpu/ops/linalg.py
# :231-412), the GEMMs of the mixed-precision refinement (ops/mixed.py).
# Each works on 512-blocks and does only the block products its operands'
# triangles need; the products inside are torch.matmul, as the JAX package
# left them to XLA.  Non-block-divisible n is zero-padded to the next block
# multiple (see _pad_nn), except in gram_tri_lower, which shares B^{-1}'s
# Gram and its narrower last block; n below two blocks falls back to the
# dense matmul.
# ---------------------------------------------------------------------------

_TRI_SYRK_BLOCK = 512


def _pad_nn(A: torch.Tensor, np_: int) -> torch.Tensor:
    """Zero-pad the trailing (n, n) dims to (np_, np_).

    Every structured product below is zero-padding-equivariant: padding a
    lower-triangular operand with zero rows and columns leaves the top-left
    n x n block of the product equal to the unpadded product."""
    return torch.nn.functional.pad(A, (0, np_ - A.shape[-1],
                                       0, np_ - A.shape[-2]))


def _next_mult(n: int, nb: int) -> int:
    return -(-n // nb) * nb


def _sym_from_block_lower(S: torch.Tensor, nd: int, nb: int) -> torch.Tensor:
    """Full symmetric matrix from its block-lower representation S (the
    diagonal blocks included, themselves symmetric; zero block-above).
    S + S^T counts each diagonal block twice, so one copy is taken back."""
    A = S + S.mT
    for j in range(nd):
        cj = slice(j * nb, (j + 1) * nb)
        A[..., cj, cj] -= S[..., cj, cj]
    return A


def syrk_tri_lower(L: torch.Tensor) -> torch.Tensor:
    """L @ L^T for LOWER-TRIANGULAR L (n^3/3 flops against the dense 2n^3):
    block-column j of the lower triangle is one GEMM
    ``L[jb:, :w] @ L[jb:jb+nb, :w]^T`` with w = (j+1) nb, and the symmetric
    matrix is assembled from the strips.  The refinement's exact residual
    ``B - L L^T`` is this product."""
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return L @ L.mT
    if n % nb:
        return syrk_tri_lower(_pad_nn(L, _next_mult(n, nb)))[..., :n, :n]
    return _sym_from_block_lower(mul_t_block_lower(L, L), n // nb, nb)


def gram_tri_lower(M: torch.Tensor) -> torch.Tensor:
    """M^T @ M for LOWER-TRIANGULAR M (n^3/3 flops): B^{-1}'s Gram,
    ``_gram_tri_lower_``, on a copy of M; exactly symmetric."""
    n = M.shape[-1]
    if n < _BLOCKED_MIN_N:
        return M.mT @ M
    return _gram_tri_lower_(M.clone().reshape(-1, n, n)).reshape(M.shape)


def trmm_lower(L: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """L @ X with LOWER-TRIANGULAR L and dense X (n^3 flops against 2n^3):
    block-row i is one GEMM ``L[ib:ib+nb, :w] @ X[:w, :]``."""
    n = L.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return L @ X
    if n % nb:
        np_ = _next_mult(n, nb)
        Xp = torch.nn.functional.pad(X, (0, 0, 0, np_ - n))
        return trmm_lower(_pad_nn(L, np_), Xp)[..., :n, :]
    return torch.cat([L[..., i * nb:(i + 1) * nb, :(i + 1) * nb]
                      @ X[..., :(i + 1) * nb, :] for i in range(n // nb)],
                     dim=-2)


def mul_t_block_lower(Y: torch.Tensor, M: torch.Tensor) -> torch.Tensor:
    """Block-lower triangle of Y @ M^T with LOWER-TRIANGULAR M (n^3/3):
    block-column j is one GEMM ``Y[jb:, :w] @ M[jb:jb+nb, :w]^T``.

    CONTRACT: only entries on or below the diagonal are specified.  The
    blocked path leaves the strict block-upper region ZERO; the small-n
    dense fallback returns the full product (a superset).  Callers read at
    most ``tril`` of the result, as the refinement's projector does."""
    n = M.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return Y @ M.mT
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_t_block_lower(_pad_nn(Y, np_),
                                 _pad_nn(M, np_))[..., :n, :n]
    S = torch.zeros_like(Y)
    for j in range(n // nb):
        w = (j + 1) * nb
        S[..., j * nb:, j * nb:w] = (Y[..., j * nb:, :w]
                                     @ M[..., j * nb:w, :w].mT)
    return S


def mul_lower_lower(A: torch.Tensor, B: torch.Tensor) -> torch.Tensor:
    """A @ B with BOTH operands lower triangular (the product is lower
    triangular): block-row i is one GEMM ``A[ib:ib+nb, :w] @ B[:w, :w]``
    and zeros beyond column w, 2n^3/3 flops."""
    n = A.shape[-1]
    nb = _TRI_SYRK_BLOCK
    if n < 2 * nb:
        return A @ B
    if n % nb:
        np_ = _next_mult(n, nb)
        return mul_lower_lower(_pad_nn(A, np_), _pad_nn(B, np_))[..., :n, :n]
    out = torch.zeros_like(A)
    for i in range(n // nb):
        w = (i + 1) * nb
        out[..., i * nb:w, :w] = A[..., i * nb:w, :w] @ B[..., :w, :w]
    return out
