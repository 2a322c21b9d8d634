"""The yardstick's arithmetic: the card's peaks, each Gram kernel's
operations and bytes, and the FLOPs of a loss+grad and of a served
dispatch, all from shapes.

The peaks and the per-entry operation counts are frozen copies of
``chip_smoke.py`` (``HBM_BYTES_PER_S``, ``F64_INSTR_PER_S``,
``F32_INSTR_PER_S``, ``k1_ops_per_entry``, ``k2_ops_per_entry``,
``entries``, ``bound``); the step counts are new here, each with its
derivation in its docstring.  Operations count what the inputs need, each
product at its least (a symmetric or triangular result counts the entries
it needs once), whatever the program computes again.
"""
from __future__ import annotations

# NVIDIA's H100 SXM data sheet, 700 W: HBM3 3.35 TB/s; f64 outside the
# tensor cores 34 TFLOP/s, i.e. 17e12 f64 instructions/s (a DFMA counts as
# two flops and a DMUL or DADD takes the same slot); f32 outside the tensor
# cores 67 TFLOP/s, 33.5e12 instructions/s
HBM_BYTES_PER_S = 3.35e12
F64_INSTR_PER_S = 17e12
F32_INSTR_PER_S = 33.5e12
# the rate a whole step's FLOPs are held to: the data sheet's f64 tensor-core
# rate, which is also its f32 rate outside the tensor cores (TF32 off)
STEP_PEAK_FLOPS = 67e12


def k1_ops_per_entry(d, epilogue):
    """K1's f64 instructions per entry and component: S (d), the product
    as fma (d), the sum (d - 1), exp (~16), C0 (1), C (2) and the factor
    target's row scale (1)."""
    return 3 * d + 18 + int(epilogue)


def k2_ops_per_entry(d):
    """K2's: the cotangent (2), S, product and sum (3d), exp (~16), the G0
    term (2) and ~5 per lengthscale sum (5d)."""
    return 8 * d + 20


def entries(n1, n2, same):
    """Entries per component the function needs: one triangle, with the
    diagonal, of a same-point Gram (it is exactly symmetric)."""
    return n1 * (n1 + 1) // 2 if same else n1 * n2


def bound(nbytes, ops, rate=F64_INSTR_PER_S):
    """The least time the card could take, in seconds: each input read and
    each output written once at the HBM rate, or the instructions at their
    dtype's rate, whichever is longer."""
    return max(nbytes / HBM_BYTES_PER_S, ops / rate)


def _size_rate(dtype: str):
    return (8, F64_INSTR_PER_S) if dtype == "f64" else (4, F32_INSTR_PER_S)


def k1_square_bound(qc, n, d, dtype):
    """K1 writing the factor target B = D C + diag of qc components at n
    points (one launch of the exact loss)."""
    size, rate = _size_rate(dtype)
    nbytes = qc * n * n * size + (n * d + qc * d + 3 * qc + qc * n) * size
    return bound(nbytes, qc * entries(n, n, True) * k1_ops_per_entry(d, True),
                 rate)


def k2_fused_bound(qc, n, d, dtype):
    """K2 at the loss's fused cotangent alpha B^{-1} + beta w w^T: B^{-1}
    read once, w, the points and the parameters read, the d + 2 sums
    written."""
    size, rate = _size_rate(dtype)
    nbytes = (qc * n * n + qc * n + n * d + 5 * qc + qc * d
              + qc * (d + 2)) * size
    return bound(nbytes, qc * entries(n, n, True) * k2_ops_per_entry(d), rate)


def k1_cross_bound(q, n1, n2, d, dtype):
    """K1 writing a (q, n1, n2) cross Gram."""
    size, rate = _size_rate(dtype)
    ins = (n1 * d + n2 * d + q * d + 2 * q) * size
    return bound(q * n1 * n2 * size + ins,
                 q * n1 * n2 * k1_ops_per_entry(d, False), rate)


def k2_cross_bound(q, n1, n2, d, dtype):
    """K2 at a (q, n1, n2) cross cotangent, read once."""
    size, rate = _size_rate(dtype)
    ins = (n1 * d + n2 * d + q * d + 2 * q) * size
    return bound(q * n1 * n2 * size + ins + q * (d + 2) * size,
                 q * n1 * n2 * (k2_ops_per_entry(d) - 2), rate)


def _dtype(cfg):
    return "f32" if cfg["model"]["precision"] == "fast" else "f64"


def _sizes(cfg) -> dict:
    """The configuration's data sizes and model arguments in one dict."""
    return {**cfg, **cfg["model"]}


def gram_launches(cfg) -> list[tuple[str, float]]:
    """The Gram (K1) and Gram-VJP (K2) launches of one loss+grad of the
    configuration, as (kernel, least seconds), in the order the program
    makes them.

    Exact path: per chunk of q_chunk components, one K1 writing the factor
    target and one K2 at the fused cotangent.  FITC (dense, n_chunk 0): K1
    for Kmm in f64 and for Knm in the compute dtype, and K2 at each of
    their cotangents; the points carry no gradient, so K5 does not run."""
    dt = _dtype(cfg)
    cfg = _sizes(cfg)
    n, d, q = int(cfg["n"]), int(cfg["d"]), int(cfg["q"])
    m = cfg.get("inducing")
    if m:
        m = int(m)
        return [("K1", k1_cross_bound(q, m, m, d, "f64")),
                ("K1", k1_cross_bound(q, n, m, d, dt)),
                ("K2", k2_cross_bound(q, n, m, d, dt)),
                ("K2", k2_cross_bound(q, m, m, d, "f64"))]
    qc = int(cfg.get("q_chunk") or q)
    out = []
    for _ in range(q // qc):
        out += [("K1", k1_square_bound(qc, n, d, dt)),
                ("K2", k2_fused_bound(qc, n, d, dt))]
    return out


def loss_grad_flops(cfg) -> float:
    """FLOPs one loss and its gradient need.

    Exact path, per component at n points: the Cholesky of B, n^3/3; B^{-1}
    from the factor, 2n^3/3 (the triangular inverse n^3/3 and the product
    L^{-T} L^{-1}, symmetric, n^3/3); the two triangular solves of B w = a,
    2n^2; the Gram and its VJP at their operations per entry (one triangle).

    FITC, dense, per component at n points and m inducing points: forward
    the panel solve W = Knm Lmm^{-T}, n m^2, and G = W^T Lam~^{-1} W,
    symmetric, n m^2; backward dW from dG, 2 n m^2, the panel solve of
    dKnm, n m^2, and dLmm, lower triangular, n m^2: 6 n m^2; and the Gram
    and its VJP over the (n, m) panel.  The (m, m) work, O(m^3), is left
    out (under 0.1% at n/m = 781)."""
    cfg = _sizes(cfg)
    n, d, q = int(cfg["n"]), int(cfg["d"]), int(cfg["q"])
    m = cfg.get("inducing")
    if m:
        m = int(m)
        per = 6.0 * n * m * m + n * m * (k1_ops_per_entry(d, False)
                                         + k2_ops_per_entry(d) - 2)
        return q * per
    per = (n ** 3 + 2.0 * n * n
           + entries(n, n, True) * (k1_ops_per_entry(d, True)
                                    + k2_ops_per_entry(d)))
    return q * per


def dispatch_flops(cfg, batch: int) -> float:
    """FLOPs one served dispatch of ``batch`` points needs.

    Exact path, per component: the cross Gram (batch, n); the mean, a
    product with the dual weights, 2 batch n; the variance's triangular
    solve L_B^{-1} K0^T, n^2 batch, and its column sums of squares,
    2 n batch.  FITC, per component: the cross Gram (batch, m); W0 = K0m
    Lmm^{-T}, batch m^2; the mean, 2 batch m; the variance's W0 times the
    (m, m) kernel, 2 batch m^2, and its row dot products, 2 batch m.  Both:
    the recombination into p outputs, 4 batch q p."""
    cfg = _sizes(cfg)
    n, d, q, p = (int(cfg[k]) for k in ("n", "d", "q", "p"))
    m = cfg.get("inducing")
    g = k1_ops_per_entry(d, False)
    if m:
        m = int(m)
        per = batch * m * (g + 3.0 * m + 4)
    else:
        per = batch * n * (g + float(n) + 4)
    return q * per + 4.0 * batch * q * p
