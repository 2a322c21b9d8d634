#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lcgp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py
    python3 chip_smoke.py --against DIR   # kernel times and bits against DIR's

Phases, each printing its own lines:

1. fail unless CUDA is available; print the card's name and power limit;
2. build the hand-written CUDA kernels from the sources in this checkout,
   one nvcc per source: K1 (csrc/matern32_gram.cu) and K2
   (csrc/matern32_gram_vjp.cu), K3 (csrc/matern52_gram.cu and its VJP),
   K4 (csrc/rbf_gram.cu and its VJP) and K5 (csrc/gram_vjp_x.cu): K1 and
   K4's Gram instantiate csrc/gram_kernel.cuh, K3's
   csrc/matern52_gram_kernel.cuh, K2 csrc/gram_vjp_kernel.cuh, K3's and
   K4's VJP csrc/matern52_gram_vjp_kernel.cuh and K5
   csrc/gram_vjp_x_kernel.cuh; print the build time and ptxas's registers,
   spills and shared memory per instantiation (142 of them; a spill at
   MAXD <= 16 fails);
3. hold K1 against its plain PyTorch version on the card at the main path's
   shapes (f64 square with epilogue and C0, exactly symmetric; the rep
   path's epilogue, row scale 1 and a diagonal 1/(D_k r_i) that varies per
   entry, exactly symmetric; f64 rectangular), one ragged shape and the
   f32 instantiation; hold K2 against its plain version at the loss
   gradient's shape (fused cotangent from a real B^{-1} and w, two launches
   bit for bit equal, and a random non-symmetric cotangent), at moderate
   and at the fitted config-4 parameters, at the rep loss gradient's
   operating point (alpha 1/2, M = (C + Lam)^{-1}, w = u), and at one
   ragged cross shape; time both kernels against their plain versions with
   CUDA events and print each kernel's bound;
4. run the port on the card at n=300 against the NumPy oracle
   ``tests/oracle.py`` (losses rtol 1e-9, predictions rtol 1e-7, the loss
   gradient against central differences of the oracle rtol 1e-6), and the
   rep path (``submethod='rep'``) at 200 unique sites with 1-5 replicates,
   with and without ``rep_standardize_ybar`` and with a grouped error
   structure, the same way;
5. serving at BASELINE config 4 (n=4096, p=1000, q=20, d=8) with the fitted
   parameters in ``benchmarks/``: ``loss()``, the predictive aux, four
   ``predict(batch_size=64)`` requests and one ``return_fullcov`` request,
   counting K1 launches;
6. training at config 4 from the data-driven init: one loss+grad
   evaluation timed and checked against the plain kernels' gradient and
   central differences, then ``fit(method='scipy', maxiter=20)``, counting
   K1 and K2 launches (one each per evaluation) and the factor's and
   B^-1's paths (every call blocked), the peak memory, the held-out RMSE
   of the short fit and a profile of one loss+grad evaluation; then B^-1
   and the factor of B timed alone (``time_inverse``, ``time_cholesky``:
   the blocked forms against cuSOLVER's, each beside its bound, and the
   factor's residual at the init and at the committed fit);
7. rep serving at BASELINE config 5 (1000 unique sites x 10 replicates,
   p=3, q=3, d=4) with its fitted parameters in ``benchmarks/``: ``loss()``,
   the aux and ``predict`` at 400 held-out points on the card against the
   same model on the CPU (the loss rtol 1e-9; outputs, factor and mks to
   1e-9 of their largest entry, since cond(C + Lam) reaches 2.5e7 there)
   and against lcgp_tpu's recorded loss and held-out RMSE;
8. the rep path at full width (4096 unique sites x 10 replicates, N=40,960
   raw rows, p=1000, q=20, d=8): construction with the grouping, one
   loss+grad evaluation timed and checked against the plain kernels and
   central differences, ``fit(method='scipy', maxiter=10)`` with K1 and K2
   launches equal to nfev, the aux, 64-point requests, peak memory, the
   held-out RMSE and a profile of one loss+grad evaluation;
9. the precision modes at config 4: K1 f32 (square with the 'fast' loss's
   epilogue, and the 64-point request shape) and K2 f32 (at the 'fast'
   and the 'mixed' operating points) against their plain f32 versions,
   timed with their bounds; 'mixed' at the committed fit (the ratchet,
   the loss within rtol 1e-9 of 'high', refined predictions within 1e-7
   of each output's largest entry, one K2 f32 launch per loss+grad);
   'mixed''s gradient at the init within 5e-4 of 'high''s per leaf; a
   'fast' ``fit(method='auto', maxiter=FAST_MAXITER)`` that must run
   'lbfgs-jax' with K1 and K2 f32 launches equal to nfev, its aux and 20
   requests; precision='auto' resolving to 'mixed'; and the three modes
   timed side by side with a profile of a 'mixed' and a 'fast' loss+grad
   evaluation;
10. Matern 5/2 (K3) and the squared exponential (K4) at config 4, each
   kind in turn: its Gram kernel against the plain version, f64 and f32
   (square with the loss's and the rep epilogue, exactly symmetric with C0
   exactly 1 on the diagonal; the request shape; a ragged shape), its VJP
   (the fused cotangent at a real B^-1 and w, two launches bit for bit
   equal; a random non-symmetric cotangent; f32 at the 'fast' operating
   point), each timed in turns with its plain version and its bound (K4
   also beside the GEMM-form composition the JAX package runs); the Gram
   at the fitted config-4 lengthscales (1e-6 floor) against an
   extended-precision recomputation; then the main path with the kind's
   counts set to 0: the f64 model from its init (one loss+grad evaluation
   checked against the plain kernels and central differences,
   ``fit(method='scipy', maxiter=KIND_MAXITER)`` with both kernels launched
   once per evaluation, the aux, 20 requests, one ``return_fullcov``
   request, peak memory, RMSE), one 'fast' loss+grad evaluation on the f32
   instantiations, 'mixed' against 'high' at the init, and the rep path at
   phase 4's size against the CPU;
11. the FITC inducing-point path (``inducing=``, ``n_chunk=``,
   ``refine_inducing``) at benchmarks/run_configs.py's configs 6-8: K1 and
   K4's Gram at Knm's rectangular shape, K2 and K4's VJP at a random cross
   cotangent (two launches bit for bit equal) and K5 (the Gram VJP in the
   inducing points, csrc/gram_vjp_x.cu) of each family against their
   plain versions at config 6's (4, 50000, 256), f64 and f32, at a ragged
   tall shape too, timed with their bounds; K1 at config 7's one-device
   Knm and K2 at a random cotangent of its shape, (4, 400000, 512), f32
   and f64, against their plain versions (over 100,000-row blocks), timed
   with their bounds (rows matern32_gram_fitc7 and
   matern32_gram_vjp_fitc7, which take every launch at that shape); then
   the main path with every count set to 0: the loss gradient in (free,
   z) on the card against the CPU at a cut of config 6 (n=2000, m=64) for each
   family, dense and streamed; config 6 (n=50,000, m=256): the f64
   loss+grad dense against streamed (n_chunk=8192) to machine precision
   with their launches, one loss+grad in (free, z) per Matern 5/2 and SE,
   f64 and 'fast', then the 'fast' model: fit(method='adam', steps=200),
   500 held-out predictions against lcgp_tpu's recorded rmse, nrmse and
   coverage (failing above twice its rmse), refine_inducing(steps=20)
   with K5 launched and the loss not raised; config 7 (n=400,000, m=512,
   un-chunked) and config 8 (n=2,000,000, m=512, n_chunk automatic:
   32768, 62 blocks): construction, one timed loss+grad with its launches
   and peak memory (config 8 under a quarter of the un-chunked panels'
   4 q n m itemsize), the aux and a 500-point predict, then the same
   model in f64 ('high'): config 7's 'fast' loss, each gradient leaf and
   64-point predictions, and config 8's 'fast' loss, within
   FITC7_FAST_BOUNDS of it (4x the reference's own 'fast' error);
12. the prediction server (lcgp_tpu_torch/serve.py) with every count set
   to 0: a PredictServer over phase 5's config-4 model at batch 256 (one
   CUDA-graph capture, timed), 64-, 256- and 300-point requests against
   model.predict (rtol 1e-10), one replay against the eager fused step
   (1e-12 of each output's largest entry), K1 in a profiled replay, the
   device time of a dispatch; single-client 64-point latency (p50, p95 of
   50) through the graph, the eager step and model.predict, at batch 256
   and 64; 8 concurrent clients of serve_concurrency.py's sizes for 5
   rounds (every answer against model.predict, fewer dispatches than
   chunks); a same-shape reload under a firing client (reused, no
   capture, every answer wholly the old or the new model's, the peak
   memory with both states alive), then a kernel='rbf' reload (a new
   capture, K4 in a profiled replay); fullcov through a server at batch 8
   (rtol 1e-8) and a rep model's refused; phase 11's config-6 'fast'
   FITC model served (500 points, rtol 1e-6; K1 at Knm in a replay);
   HTTP on 127.0.0.1 (/healthz, /info, a 64-point /predict equal to the
   in-process answer, /reload 403, an 8-point fullcov /predict) and
   shutdown() joining each dispatcher.  Every line of numbers carries the
   card's name and power limit.
13. the mesh paths (``lcgp_tpu_torch/parallel``) at config 4, f64: first a
   world of one NCCL rank in this process (a ``FileStore`` rendezvous):
   the ('n',) mesh's loss+grad at the init and at the committed fit against
   one device (loss rtol 1e-9, gradient GRAD_RTOL of each leaf's max |g|),
   its aux (LBs to 1e-9 of the largest entry) and a 64-point predict (1e-7
   of each output's largest entry), ``kernel='rbf'`` (K4) and a
   ('comp','out') 1x1 loss+grad the same way, and
   ``fit(mesh=..., method='scipy', maxiter=5)`` with K1 and K2 launched once
   per evaluation; the warm loss+grad beside one device's, the aux, the
   request and the peak memory; K1 and K2 in cross mode at the ('n',) 4
   block shape (20, 1024, 4096) against their plain versions, timed with
   their bounds.  Then four gloo ranks that compute on the card
   (``parallel.WorkerGroup``; the compute mode must be Default), their
   collectives staged through the host: ('n',) 4, ('comp','n') 2x2 and
   ('comp','out') 2x2 at config 4, each rank's loss+grad, sampled factor
   rows and predictions against one device, a two-iteration ('comp','out')
   fit whose parameters are the same bits on every rank, the seconds,
   staged bytes and peak memory of each rank, and the memory of one
   loss+grad on a rank at ('n',) 4 under half of the same code's on the
   one NCCL rank above (same card, same measure: peak less resident).
   When one ('n',) 4 loss+grad takes over 60 s, the four ranks' run is cut
   to n=2048, and ('n',) 1 then runs in the group at that n as the
   yardstick.  The K1 and K2 rows gain ``launches_mesh`` (the mesh paths'
   launches that row's shape takes), ``launches_mesh_by_shape`` and
   ``launches_per_call["mesh_loss_grad"]``; the block rows take the
   ('n',) 4 ranks' launches at their shape, the config-4 rows every other
   mesh launch, each launch counted on one row only.
14. n-sharded FITC (``lcgp_tpu_torch/parallel/fitc_shard.py``) at
   benchmarks/run_configs.py's config 7 (n=400,000, m=512, d=2, p=20, q=4,
   'fast', farthest-point inducing points chosen once) and served mesh
   models (``serve.py``'s ``follow()``): first a world of one NCCL rank in
   this process: the ('n',) mesh's loss+grad at the init against one
   device's dense FITC (loss within 1e-12 relative, each gradient leaf
   within 1e-6 of its max |g|), the aux and a 64-point predict (1e-6),
   ``refine_inducing(steps=5)`` with K5 launched 3 times a step, the warm
   loss+grad and the memory one takes; config 4's exact model at the
   committed fit served on that mesh (request p50 and p95, held to the mesh
   ``model.predict`` and one device's).  K1, K2 and K5 at the ('n',) 4
   block, (4, 100000, 512) with d=2, f32 and f64, against their plain
   versions, timed with their bounds.  Then four gloo ranks sharing the
   card on ('n',) 4 and ('comp','n') 2x2 at config 7: an f64 loss+grad
   against one device's f64 (loss 1e-9 relative, gradient leaves 1e-7 of
   their max |g|); each rank's 'fast' loss+grad, aux and predict the same
   bits on every rank and held to one device's f64 answer within the
   smaller of FITC7_FAST_BOUNDS and FITC_MESH_ERR_RATIO x one device's
   own 'fast' error, a 2-step Adam fit (and on ('n',) 4 ``refine_inducing(steps=2)``) whose
   parameters and z are the same bits on every rank, seconds, staged
   bytes, and a rank's loss+grad memory under half the one NCCL rank's;
   then config 4's exact model and config 6's 'fast' FITC model served on
   ('n',) 4 (followers in ``follow()``), held to the mesh
   ``model.predict``, with coalesced clients, a refused bad request and
   request p50 and p95.  New rows ``matern32_gram_fitc_block``,
   ``matern32_gram_vjp_fitc_block`` and ``gram_vjp_x_fitc_block`` (f32 in
   the main keys, f64 under ``*_f64``); every launch of the phase is filed
   on one row by shape (``launches_fitc_mesh_by_shape``): the block rows
   take the ('n',) 4 ranks' f32 launches at the block, the FITC rows of
   phase 11 the other FITC launches by dtype (the one NCCL rank's f32
   launches at config 7's panel on the config-7 rows), the config-4 K1
   row the served exact model's.
15. the examples (examples/torch_*.py), each main() at its default size
   on the card with its K1 and K2 launches: the notebook check within its
   TOLERANCES of examples/notebook_metrics.json; the three rep-1d cases,
   the three rep-3d cases (the transform check within 1e-10) and the
   borehole field at BASELINE config 3 ('scipy', 'high'), each within
   those TOLERANCES of examples/torch_reference_metrics.json (the
   reference's runs); the multichip demo on four gloo ranks sharing the
   card (compute mode Default), its differences from one device within
   MULTICHIP_BOUNDS and K1 and K2 launched on every rank.  Then K1 and K2
   against their plain versions (f64) at every one-card example's fitted
   model and at the multichip demo's shapes, and timed at the borehole
   field's (5, 800, 800) with d=8: new rows ``matern32_gram_examples`` and
   ``matern32_gram_vjp_examples``, which take the phase's launches
   (``launches_by_example``).

The line before the last is a JSON object with the kernel table (each
kernel's times, bound, launches on the main paths and per call, the f32
instantiations in rows of their own); the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before those lines are printed.  With ``--against DIR`` (another checkout,
e.g. the parent commit unpacked with ``git archive``) it builds both
checkouts' kernels and times each kernel of both in turns, f64 and f32:
K1, K2, K3, K4 (Gram and VJP) at config 4's square and fused shapes and
at FITC's (4, 50000, 256) (Knm, a random cross cotangent), K1 at the
request shape, and K5 of every family at FITC's shape.  It fails unless
every kernel gives the other's bits (a kernel redesigned against the
parent, listed in ``AGAINST_REDESIGNED``, is held within its bounds of
its plain version and to the same bits on two launches instead); it
holds K3's Gram at the fitted config-4 lengthscales, K3's and K4's fused
VJP (component 0) and K4's
fused VJP at the fitted parameters (the components at the 1e-6 floor)
against extended precision, prints one JSON line and stops; a kernel the
other checkout lacks is left out.  Imports nothing of JAX.
"""
from __future__ import annotations

import contextlib
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FITTED = ROOT / "benchmarks" / "fitted_params_large_field_n4096_p1000_q20.npz"
FITTED_REP = ROOT / "benchmarks" / "fitted_params_rep_heavy_10k.npz"
# lcgp_tpu's loss and held-out RMSE at config 5 with FITTED_REP, f64 on the
# CPU; the NumPy oracle is not the yardstick there (its Woodbury
# cancellation and explicit inv(C) lose ~1e-2 at amplitudes ~3e3)
CONFIG5_LOSS = -4.393535528164473
CONFIG5_RMSE = 0.013530078231167635
# the rep fit's iteration cap at full width (phase 8)
REP_MAXITER = 10
# the 'fast' fit's iteration cap at config 4 (phase 9)
FAST_MAXITER = 20
# the Matern 5/2 and squared-exponential fits' iteration cap (phase 10)
KIND_MAXITER = 10
K1_SOURCE = "lcgp_tpu_torch/csrc/matern32_gram.cu"
K1_REPLACES = "lcgp_tpu/ops/matern_pallas.py:200 (_fwd_call, deleted in b21a99c; live successor lcgp_tpu/ops/matern.py:27)"
K2_SOURCE = "lcgp_tpu_torch/csrc/matern32_gram_vjp.cu"
K2_REPLACES = "lcgp_tpu/ops/matern_pallas.py:233 (_bwd_call, deleted in b21a99c; live successor lcgp_tpu/ops/matern.py:86)"
# phase 10's kernel families: kind -> what its Gram and VJP kernels
# replace; neither was ever a Pallas kernel
REPLACES = {
    "matern52": ("none (jnp): lcgp_tpu/ops/matern52.py:27 (matern52_gram)",
                 "none (jnp): lcgp_tpu/ops/matern52.py:63 (matern52_gram_vjp)"),
    "rbf": ("none (jnp): lcgp_tpu/ops/rbf.py:22 (rbf_gram)",
            "none (jnp): lcgp_tpu/ops/rbf.py:57 (rbf_gram_vjp)"),
}
# sqrt(5) and 5/3 as the kernels and the plain versions round them
SQRT5, FIVE_THIRDS = 5.0 ** 0.5, 5.0 / 3.0
F64_RTOL, F64_ATOL = 1e-12, 1e-14
F32_RTOL, F32_ATOL = 1e-4, 1e-6
# the H100 SXM's published peaks (NVIDIA data sheet, 700 W): HBM3 3.35 TB/s;
# f64 outside the tensor cores 34 TFLOP/s, i.e. 17e12 f64 instructions/s,
# a DFMA counting as two flops and a DMUL or DADD taking the same slot
HBM_BYTES_PER_S = 3.35e12
F64_INSTR_PER_S = 17e12
# float32 outside the tensor cores: 67 TFLOP/s, 33.5e12 f32 instructions/s
F32_INSTR_PER_S = 33.5e12
# K2's error in each of its sums, as a share of the sum of the magnitudes
# of the sum's terms (matern32_gram_vjp_scale): the sums cancel near an
# optimum, so an rtol on the result would say nothing
VJP_BOUND = 1e-12
# the same for K2's f32 instantiation (per-entry arithmetic in f32, sums in
# f64; tests/test_torch_gpu.py's VJP_BOUND[float32])
VJP_BOUND_F32 = 1e-5
# the port's gradient against the plain kernels' gradient on the card: max
# error per leaf, as a share of the leaf's max |g|
GRAD_RTOL = 1e-9


def say(msg: str):
    print(msg, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def k1_ops_per_entry(d, epilogue):
    """K1's f64 instructions per entry and component: S (d), the product
    as fma (d), the sum (d - 1), exp (~16), C0 (1), C (2) and the factor
    target's row scale (1)."""
    return 3 * d + 18 + int(epilogue)


def k2_ops_per_entry(d):
    """K2's: the cotangent (2), S, product and sum (3d), exp (~16), the G0
    term (2) and ~5 per lengthscale sum (5d)."""
    return 8 * d + 20


def k3_ops_per_entry(d, epilogue):
    """K3's (Matern 5/2): S (d), the factor's fma, multiply and fma into the
    product (3d), the sum (d - 1), sqrt5 times it (1), exp (~16), C0 (1),
    C (2) and the row scale (1)."""
    return 5 * d + 19 + int(epilogue)


def k3_vjp_ops_per_entry(d):
    """K3's VJP, as the function needs it: the cotangent (2), S, factor,
    product and sum (5d), sqrt5 times the sum and exp (~16), C0 and the G0
    term (2) and per lengthscale sum 7 (1 + sqrt5 S, S^2, their product,
    the prefix times the suffix, that times the term, the sum, and one fma
    of the factor into the suffix)."""
    return 12 * d + 20


def k4_ops_per_entry(d, epilogue):
    """K4's (squared exponential): S (d), S^2 summed by fma (d), -1/2 times
    it (1), exp (~16), C (2) and the row scale (1)."""
    return 2 * d + 19 + int(epilogue)


def k4_vjp_ops_per_entry(d):
    """K4's VJP: the cotangent (3), per dimension the raw difference, its
    square, the fma into the decay's argument and the fma into the
    lengthscale sum (4d), exp on the lean loop (~10) and the G0 term (2)."""
    return 4 * d + 15


# each family's Gram and VJP kernel templates (ptxas's names): K1 and K4's
# Gram instantiate csrc/gram_kernel.cuh, K3's csrc/matern52_gram_kernel.cuh;
# K2 csrc/gram_vjp_kernel.cuh, K3's and K4's VJP
# csrc/matern52_gram_vjp_kernel.cuh; K5 of every family
# csrc/gram_vjp_x_kernel.cuh
KERNEL_TEMPLATES = {
    "matern32": ("gram_kernel", "gram_vjp_partials_kernel"),
    "matern52": ("gram_staged_kernel", "gram_vjp_tma_kernel"),
    "rbf": ("gram_kernel", "gram_vjp_tma_kernel")}
K5_TEMPLATE = "gram_vjp_x_tma_kernel"

OPS_PER_ENTRY = {"matern32": (k1_ops_per_entry, k2_ops_per_entry),
                 "matern52": (k3_ops_per_entry, k3_vjp_ops_per_entry),
                 "rbf": (k4_ops_per_entry, k4_vjp_ops_per_entry)}


def family_of(kind):
    """A kernel kind's family (lcgp_tpu_torch/ops/launch.py): its label,
    policy, plain versions, wrappers and launch counters."""
    from lcgp_tpu_torch.ops.launch import family
    return family(kind)


def c0_extended(kind, S):
    """C0 from the scaled distances S (..., d), in NumPy's dtype of S (the
    extended-precision references), with the kernels' rounded constants."""
    if kind == "rbf":
        return np.exp(-0.5 * np.sum(S * S, axis=-1))
    if kind == "matern52":
        a, f3 = S.dtype.type(SQRT5), S.dtype.type(FIVE_THIRDS)
        return (np.prod(1 + a * S + f3 * S * S, axis=-1)
                * np.exp(-a * np.sum(S, axis=-1)))
    return np.prod(1 + S, axis=-1) * np.exp(-np.sum(S, axis=-1))


def lens_extended(kind, S):
    """dlnC0/dlnS_t per dimension, the lengthscale sums' factor of C0."""
    if kind == "rbf":
        return S * S
    if kind == "matern52":
        a, f3 = S.dtype.type(SQRT5), S.dtype.type(FIVE_THIRDS)
        return f3 * S * S * (1 + a * S) / (1 + a * S + f3 * S * S)
    return S * S / (1 + S)


def entries(n1, n2, same):
    """Entries per component the function needs: one triangle, with the
    diagonal, of a same-point Gram (it is exactly symmetric)."""
    return n1 * (n1 + 1) // 2 if same else n1 * n2


def bound(nbytes, ops, rate=F64_INSTR_PER_S):
    """The least time the card could take, in ms, and what sets it: each
    input read and each output written once at the HBM rate, or the
    instructions at their dtype's rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = ops / rate * 1e3
    if by_bytes >= by_ops:
        return by_bytes, "bytes"
    return by_ops, "operations"


def say_bound(label, ms, nbytes, ops, rate=F64_INSTR_PER_S):
    """Prints a kernel's bound and the share of it the kernel reached."""
    b_ms, by = bound(nbytes, ops, rate)
    kind = "f64" if rate == F64_INSTR_PER_S else "f32"
    say(f"  bound {label}: {b_ms:.4f} ms, set by {by} ({nbytes:.4e} bytes "
        f"at 3.35 TB/s, {ops:.4e} {kind} instructions at {rate:.4g}/s); the "
        f"kernel's {ms:.4f} ms is {b_ms / ms:.1%} of the bound")
    return b_ms, by


def ptxas_report(log):
    """Registers, spills and shared memory of each kernel instantiation,
    from nvcc's ``-Xptxas -v`` log, named as in ``gram_kernel<double,
    MAXD=8, Matern32>``; fails on a spill at MAXD <= 16."""
    import re
    rows, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            name = m.group(1)
            k = re.search(r"(gram_[a-z_]*kernel)I([df])(?:Li(\d+)E)?", name)
            # the policy, a length-prefixed name in namespace lcgp (K5's
            # finish kernel has none)
            p = re.search(r"N4lcgp(\d+)", name)
            policy = name[p.end():p.end() + int(p.group(1))] if p else "any"
            cur = rows.setdefault(
                f"{k.group(1)}<{'double' if k.group(2) == 'd' else 'float'}"
                + (f", MAXD={k.group(3)}" if k.group(3) else "")
                + f", {policy}>", {"maxd": int(k.group(3) or 0)})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            cur["spill_bytes"] = int(m.group(1)) + int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            cur["registers"] = int(m.group(1))
        m = re.search(r"(\d+) bytes smem", line)
        if m:
            cur["smem"] = int(m.group(1))
    for name, r in sorted(rows.items()):
        say(f"  ptxas {name}: {r.get('registers')} registers, "
            f"{r.get('spill_bytes', 0)} bytes spilled, "
            f"{r.get('smem', 0)} bytes static smem")
    check(len(rows) >= 142, f"ptxas reported {len(rows)} kernels, expected "
          "142 in 2 dtypes: K1's and K4's Gram (4 MAXD each), K3's Gram (5 "
          "MAXD), K2 (4 MAXD and its finish kernel), K3's and K4's VJP (5 "
          "MAXD with tensor copies, 5 without, and the finish kernel each), "
          "K5 of 3 families (5 MAXD with tensor copies, 5 without) and K5's "
          "finish kernel")
    spills = [n for n, r in rows.items()
              if r["maxd"] <= 16 and r.get("spill_bytes", 0)]
    check(not spills, f"spills at MAXD <= 16: {spills}")
    return {n: r.get("registers") for n, r in rows.items()}


def cuda_ms(fn, reps: int = 7) -> float:
    """Device time of one fn() in ms: the median over 7 windows (CUDA
    events, after one warm-up call), each of enough back-to-back calls to
    span about 2 ms, so that a short kernel is timed on the device and not
    by the host's gaps between launches."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    calls = max(1, min(100, int(2.0 / max(start.elapsed_time(end), 1e-3))))
    times = []
    for _ in range(reps):
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def ptr(t):
    return None if t is None else t.data_ptr()


def raw_gram(lib, x1, x2, ls, amp, nug, same, row_scale=None,
             diag_vec=None, family="matern32"):
    """A launch of the family's Gram kernel (K1 by default; the
    instantiation of x1's dtype) from ``lib`` through its C entry on
    buffers allocated once: the kernel's time without the wrapper's host
    work (checks, allocation, 1/l).  It counts no launch of the main
    path."""
    import torch
    q, n1, n2, d = ls.shape[0], x1.shape[0], x2.shape[0], x1.shape[1]
    out = torch.empty((q, n1, n2), dtype=x1.dtype, device=x1.device)
    inv = (1.0 / ls).contiguous()
    args = (ptr(x1), ptr(x2), ptr(inv), ptr(amp), ptr(nug), ptr(row_scale),
            ptr(diag_vec), int(same), q, n1, n2, d, ptr(out), None,
            torch.cuda.current_stream(x1.device).cuda_stream)

    fn = getattr(lib, f"lcgp_{family}_gram_"
                 + ("f64" if x1.dtype == torch.float64 else "f32"))

    def launch():
        check(fn(*args) == 0, f"{family} Gram launch failed")
    # every buffer stays alive while the kernel may read or write it
    launch.buffers = (x1, x2, ls, amp, nug, row_scale, diag_vec, out, inv)
    launch.outputs = (out,)
    return launch


def raw_vjp(lib, x, ls, amp, nug, M, alpha, beta, w, family="matern32",
            x2=None):
    """The same for the family's VJP kernel (K2 by default; x's dtype) at
    the cotangent alpha_k M_k + beta w_k w_k^T of the same-point Gram, or,
    with ``x2``, at the cross cotangent M of C(x, x2)."""
    import torch
    q, n, d = ls.shape[0], x.shape[0], x.shape[1]
    n2 = n if x2 is None else x2.shape[0]
    inv = (1.0 / ls).contiguous()
    outs = [torch.empty(s, dtype=x.dtype, device=x.device)
            for s in ((q, d), (q,), (q,))]
    part = torch.empty((lib.lcgp_matern32_gram_vjp_scratch(q, n, n2, d),),
                       dtype=torch.float64, device=x.device)
    args = (ptr(x), ptr(x if x2 is None else x2), ptr(inv), ptr(amp),
            ptr(nug), ptr(M), ptr(w), ptr(alpha), float(beta),
            int(x2 is None), q, n, n2, d, ptr(part),
            *(ptr(o) for o in outs),
            torch.cuda.current_stream(x.device).cuda_stream)

    fn = getattr(lib, f"lcgp_{family}_gram_vjp_"
                 + ("f64" if x.dtype == torch.float64 else "f32"))

    def launch():
        check(fn(*args) == 0, f"{family} VJP launch failed")
    launch.buffers = (x, x2, ls, amp, nug, M, alpha, w, inv, outs, part)
    launch.outputs = tuple(outs)
    return launch


def raw_vjp_x(lib, x1, x2, ls, amp, nug, M, family="matern32"):
    """The same for K5, the family's VJP in the points of x2, at the
    cotangent M (q, n1, n2)."""
    import torch
    q, n1, n2, d = ls.shape[0], x1.shape[0], x2.shape[0], x1.shape[1]
    inv = (1.0 / ls).contiguous()
    gx = torch.empty((n2, d), dtype=x1.dtype, device=x1.device)
    part = torch.empty((lib.lcgp_gram_vjp_x_scratch(n1, n2, d),),
                       dtype=torch.float64, device=x1.device)
    args = (ptr(x1), ptr(x2), ptr(inv), ptr(amp), ptr(nug), ptr(M), q, n1,
            n2, d, ptr(part), ptr(gx),
            torch.cuda.current_stream(x1.device).cuda_stream)
    fn = getattr(lib, f"lcgp_{family}_gram_vjp_x_"
                 + ("f64" if x1.dtype == torch.float64 else "f32"))

    def launch():
        check(fn(*args) == 0, f"{family} VJP-x launch failed")
    launch.buffers = (x1, x2, ls, amp, nug, M, inv, gx, part)
    launch.outputs = (gx,)
    return launch


def config4():
    """BASELINE config 4, exactly as benchmarks/run_configs.py:config4."""
    rng = np.random.default_rng(0)
    n, p, d = 4096, 1000, 8
    x = rng.uniform(0, 1, (n + 256, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) + np.cos(np.pi * t * x[:, 1:2].T)
         + 0.05 * rng.standard_normal((p, n + 256)))
    return x[:n], y[:, :n], x[n:], y[:, n:]


def time_pair(label, kernel, plain, nbytes, moved="written", plain_reps=7):
    """Kernel and plain times in turns (plain, kernel, kernel, plain), each
    by cuda_ms (the plain version over ``plain_reps`` windows); prints the
    kernel's rate of the bytes it writes (Gram) or reads (VJP)."""
    p1, k1, k2, p2 = (cuda_ms(fn, reps) for fn, reps in
                      ((plain, plain_reps), (kernel, 7), (kernel, 7),
                       (plain, plain_reps)))
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"  time {label}: kernel {k:.4f} ms ({nbytes / k / 1e6:.0f} GB/s "
        f"{moved}), plain {p:.4f} ms (runs {k1:.4f}/{k2:.4f} vs "
        f"{p1:.4f}/{p2:.4f})")
    return k, p


def moderate_params(rng, q, d, dev, dtype):
    import torch

    def t(a):
        return torch.as_tensor(a, dtype=dtype, device=dev)
    return (t(rng.uniform(0.2, 2.0, (q, d))), t(rng.uniform(0.5, 2.0, q)),
            t(rng.uniform(1e-6, 1e-2, q)))


def compare(name, got, ref, rtol, atol):
    """Max abs/rel error of got against ref; fails outside the tolerance."""
    import torch
    got = got.double()
    ref = ref.double()
    err = (got - ref).abs()
    max_abs = float(err.max())
    max_rel = float((err / ref.abs().clamp_min(1e-300)).max())
    bad = int((err > atol + rtol * ref.abs()).sum())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite kernel output")
    say(f"  {name}: max_abs_err={max_abs:.3e} max_rel_err={max_rel:.3e} "
        f"(rtol {rtol:g}, atol {atol:g}; {bad} entries outside)")
    check(bad == 0, f"{name}: {bad} entries outside rtol {rtol:g} atol {atol:g}")
    return max_abs


def compare_normwise(name, got, ref, tol):
    """Max abs error of got against ref as a share of max |ref|; fails
    above ``tol``."""
    import torch
    err = float((got.double() - ref.double()).abs().max())
    top = float(ref.abs().max())
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    say(f"  {name}: max_abs_err={err:.3e}, {err / top:.3e} of max |ref| "
        f"{top:.3e} (bound {tol:.3e})")
    check(err <= tol * top, f"{name}: error {err:.3e} above {tol:.3e} of "
          f"max |ref| {top:.3e}")
    return err


def phase_kernels(dev, xs, x0s):
    """Phase 3: K1 against the plain version.  Returns the kernel record."""
    import torch
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.matern import (launch_matern32,
                                           matern32_gram_plain)
    lib = build().lib
    f64 = torch.float64
    rng = np.random.default_rng(1)
    q, n, d = 20, xs.shape[0], xs.shape[1]
    ls, amp, nug = moderate_params(rng, q, d, dev, f64)
    rs = torch.as_tensor(rng.uniform(0.1, 10.0, q), dtype=f64, device=dev)
    dv = torch.ones((q, n), dtype=f64, device=dev)
    errs = []

    # f64 square with epilogue: the aux / loss call (with C0: its training
    # form, which the loss gradient will ask for)
    def k_sq(want_c0=False):
        return launch_matern32(xs, xs, ls, amp, nug, same=True,
                               want_c0=want_c0, row_scale=rs, diag_vec=dv)

    def p_sq(want_c0=False):
        C, c0 = matern32_gram_plain(xs, xs, ls, amp, nug, same=True,
                                    want_c0=True)
        return linalg.add_diag(rs[:, None, None] * C, dv), c0

    (B_k, c0_k), (B_p, c0_p) = k_sq(True), p_sq(True)
    torch.cuda.synchronize()
    errs.append(compare(f"f64 square+epilogue B (q={q}, n={n}, d={d})",
                        B_k, B_p, F64_RTOL, F64_ATOL))
    errs.append(compare("f64 square C0", c0_k, c0_p, F64_RTOL, F64_ATOL))
    check(bool((torch.diagonal(c0_k, dim1=-2, dim2=-1) == 1.0).all()),
          "C0 diagonal is not exactly 1")
    # K1 computes one triangle of tiles and mirrors it
    check(torch.equal(B_k, B_k.mT) and torch.equal(c0_k, c0_k.mT),
          "K1's same-point B or C0 is not exactly symmetric")
    say("  f64 square B and C0 exactly symmetric: True")
    del B_k, c0_k, B_p, c0_p
    C_k, _ = launch_matern32(xs, xs, ls, amp, nug, same=True)
    torch.cuda.synchronize()
    check(bool((torch.diagonal(C_k, dim1=-2, dim2=-1) == amp[:, None]).all()),
          "same=True Gram diagonal is not exactly amp")
    errs.append(compare("f64 square C (no epilogue)", C_k,
                        matern32_gram_plain(xs, xs, ls, amp, nug, same=True),
                        F64_RTOL, F64_ATOL))
    del C_k
    # the rep path's factor target: row scale 1 and a diagonal 1/(D_k r_i)
    # that varies per entry (r_i replicate counts 1-10)
    rep_rs = torch.ones(q, dtype=f64, device=dev)
    rep_dv = 1.0 / (torch.as_tensor(10.0 ** rng.uniform(-1, 2, q), dtype=f64,
                                    device=dev)[:, None]
                    * torch.as_tensor(rng.integers(1, 11, n), dtype=f64,
                                      device=dev)[None, :])
    A_k = launch_matern32(xs, xs, ls, amp, nug, same=True, row_scale=rep_rs,
                          diag_vec=rep_dv)[0]
    A_p = linalg.add_diag(matern32_gram_plain(xs, xs, ls, amp, nug,
                                              same=True), rep_dv)
    torch.cuda.synchronize()
    errs.append(compare(f"f64 square, rep epilogue (row scale 1, diagonal "
                        f"1/(D r), q={q}, n={n})", A_k, A_p, F64_RTOL,
                        F64_ATOL))
    check(torch.equal(A_k, A_k.mT), "K1's rep factor target is not exactly "
          "symmetric")
    say("  f64 square, rep epilogue, exactly symmetric: True")
    del A_k, A_p, rep_rs, rep_dv
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    stack = q * n * n * 8
    k_ms, p_ms = time_pair(f"f64 square+epilogue (aux/loss, q={q} n={n})",
                           raw_gram(lib, xs, xs, ls, amp, nug, True, rs, dv),
                           p_sq, stack)
    inputs = (xs.numel() + ls.numel() + 3 * q + dv.numel()) * 8
    b_ms, b_by = say_bound(
        "K1 square+epilogue", k_ms, stack + inputs,
        q * entries(n, n, True) * k1_ops_per_entry(d, True))
    time_pair("f64 square+epilogue+C0", lambda: k_sq(True),
              lambda: p_sq(True), 2 * stack)
    torch.cuda.empty_cache()

    # f64 rectangular: the predict cross-covariance (n0=256 held-out points)
    def k_rect():
        return launch_matern32(x0s, xs, ls, amp, nug, same=False)[0]

    def p_rect():
        return matern32_gram_plain(x0s, xs, ls, amp, nug, same=False)

    errs.append(compare(f"f64 rectangular (q={q}, n1={x0s.shape[0]}, n2={n})",
                        k_rect(), p_rect(), F64_RTOL, F64_ATOL))
    x64 = x0s[:64].contiguous()
    errs.append(compare("f64 rectangular, one request (n1=64)",
                        launch_matern32(x64, xs, ls, amp, nug, same=False)[0],
                        matern32_gram_plain(x64, xs, ls, amp, nug, same=False),
                        F64_RTOL, F64_ATOL))
    req_ms, req_plain_ms = time_pair(
        "f64 rectangular n1=64 (one request)",
        raw_gram(lib, x64, xs, ls, amp, nug, False),
        lambda: matern32_gram_plain(x64, xs, ls, amp, nug, same=False),
        q * 64 * n * 8)
    req_bound, req_by = say_bound(
        "K1 request", req_ms,
        q * 64 * n * 8 + ((64 + n) * d + ls.numel() + 2 * q) * 8,
        q * entries(64, n, False) * k1_ops_per_entry(d, False))
    time_pair("f64 rectangular n1=256", raw_gram(lib, x0s, xs, ls, amp, nug,
                                                  False),
              p_rect, q * 256 * n * 8)

    # ragged shape: nothing divides the block sizes
    rr = np.random.default_rng(2)
    xa = torch.as_tensor(rr.uniform(0, 1, (1000, 3)), dtype=f64, device=dev)
    xb = torch.as_tensor(rr.uniform(0, 1, (37, 3)), dtype=f64, device=dev)
    l3, a3, n3 = moderate_params(rr, 3, 3, dev, f64)
    errs.append(compare("f64 ragged (q=3, n1=1000, n2=37, d=3)",
                        launch_matern32(xa, xb, l3, a3, n3, same=False)[0],
                        matern32_gram_plain(xa, xb, l3, a3, n3, same=False),
                        F64_RTOL, F64_ATOL))

    # f32 instantiation at moderate lengthscales, against the f64 result
    f32 = torch.float32
    xs32 = xs.to(f32)
    ls32, amp32, nug32, rs32 = ls.to(f32), amp.to(f32), nug.to(f32), rs.to(f32)
    B32_k, c032_k = launch_matern32(xs32, xs32, ls32, amp32, nug32, same=True,
                                    want_c0=True, row_scale=rs32,
                                    diag_vec=dv.to(f32))
    C, c0 = matern32_gram_plain(xs, xs, ls, amp, nug, same=True, want_c0=True)
    B_ref = linalg.add_diag(rs[:, None, None] * C, dv)
    del C
    compare("f32 square+epilogue B vs f64 plain", B32_k, B_ref, F32_RTOL,
            F32_ATOL)
    compare("f32 square C0 vs f64 plain", c032_k, c0, F32_RTOL, F32_ATOL)
    C32_p = matern32_gram_plain(xs32, xs32, ls32, amp32, nug32, same=True)
    B32_p = linalg.add_diag(rs32[:, None, None] * C32_p, dv.to(f32))
    say(f"  f32 plain vs f64 plain (for scale): max_abs_err="
        f"{float((B32_p.double() - B_ref).abs().max()):.3e}")
    del B32_k, c032_k, B_ref, c0, C32_p, B32_p
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    return dict(name="matern32_gram", route="cuda", source=K1_SOURCE,
                replaces=K1_REPLACES, max_abs_err=max(errs),
                ms=k_ms, plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                library_ms=None,
                shape=f"square+epilogue f64 q={q} n={n} d={d}",
                request_ms=req_ms, request_plain_ms=req_plain_ms,
                request_bound_ms=req_bound, request_bound_by=req_by)


def phase_fitted_gram(dev, xs, free_np, kind="matern32"):
    """The kind's Gram kernel (K1 by default) at the fitted config-4
    parameters, whose lengthscales sit at the 1e-6 floor.  There the plain
    version's scale-then-subtract (|x1/l - x2/l|, as the JAX package
    computes it; for the squared exponential the GEMM form
    |u|^2 + |v|^2 - 2 u.v) loses up to eps * max|x|/l of each S (eps
    |u|^2 of each squared distance), while the kernel subtracts first.
    Every entry where the two disagree beyond rtol 1e-12 is recomputed on
    the host in extended precision, and the kernel must agree with that
    within rtol 1e-12."""
    from lcgp_tpu_torch.models import params as P
    from lcgp_tpu_torch.convert import free_params_from_numpy
    ls, amp, _, nug = P.constrain(free_params_from_numpy(*free_np, dev))
    gram_at_fitted(xs, ls, amp, nug, kind, "fitted config-4 params")


def gram_at_fitted(xs, ls, amp, nug, kind, what):
    """The kind's same-point Gram at fitted parameters against the plain
    version within rtol 1e-12, the entries where the two disagree
    recomputed in extended precision (phase_fitted_gram).  Returns the
    kernel's max abs error against the better reference."""
    import torch
    f = family_of(kind)
    label = f.label
    C_k = f.launch(xs, xs, ls, amp, nug, same=True)[0]
    C_p, c0_p = f.plain(xs, xs, ls, amp, nug, same=True, want_c0=True)
    check(bool(torch.isfinite(C_k).all()), "fitted-params Gram not finite")
    check(torch.equal(C_k, C_k.mT), "fitted-params Gram not exactly symmetric")
    if kind == "rbf":
        dg = torch.diagonal(c0_p, dim1=-2, dim2=-1)
        say(f"  the plain (GEMM-form) C0 on the same-point diagonal at the "
            f"fitted params: min {float(dg.min())!r}, worst |C0 - 1| "
            f"{float((dg - 1).abs().max()):.3e} (the kernel's is exactly 1)")
    del c0_p
    err = (C_k - C_p).abs()
    outside = err > F64_ATOL + F64_RTOL * C_p.abs()
    k, i, j = (a.cpu().numpy() for a in outside.nonzero(as_tuple=True))
    worst = float(torch.where(outside, 0.0, err).max())
    say(f"  {what} (min lengthscale {float(ls.min()):.3e}), "
        f"f64 square C: {label} vs plain max_abs_err={float(err.max()):.3e} "
        f"(max |C| {float(C_p.abs().max()):.3e}); {k.size} of {C_p.numel()} "
        f"entries outside rtol {F64_RTOL:g} atol {F64_ATOL:g}")
    if k.size:
        ld = np.longdouble
        X = xs.cpu().numpy().astype(ld)
        L, A, N = (t.cpu().numpy().astype(ld) for t in (ls, amp, nug))
        rel_k = rel_p = 0.0
        bad = 0
        for c in range(0, k.size, 1 << 20):     # in chunks: memory
            kc, ic, jc = k[c:c + (1 << 20)], i[c:c + (1 << 20)], j[c:c + (1 << 20)]
            S = np.abs(X[ic] - X[jc]) / L[kc]
            c0 = c0_extended(kind, S)
            ref = np.where(ic == jc, A[kc],
                           A[kc] * ((1 - N[kc] / (1 + N[kc])) * c0))
            got_k = C_k[kc, ic, jc].cpu().numpy().astype(ld)
            got_p = C_p[kc, ic, jc].cpu().numpy().astype(ld)
            rel_k = max(rel_k, float(np.max(np.abs(got_k - ref)
                                            / np.abs(ref))))
            rel_p = max(rel_p, float(np.max(np.abs(got_p - ref)
                                            / np.abs(ref))))
            bad += int(np.sum(np.abs(got_k - ref)
                              > F64_ATOL + F64_RTOL * np.abs(ref)))
            worst = max(worst, float(np.max(np.abs(got_k - ref))))
        say(f"  at those entries, against extended precision "
            f"({np.finfo(ld).eps:.1e} eps): {label} max_rel_err={rel_k:.3e}, "
            f"plain max_rel_err={rel_p:.3e}")
        check(bad == 0, f"{label} at the fitted parameters differs from the "
              f"extended-precision reference beyond rtol 1e-12 at {bad} "
              "entries")
    del C_k, C_p, err, outside
    torch.cuda.empty_cache()
    return worst


def loss_operands(m, free):
    """(lengthscales, amplitudes, nuggets, D, a) as ``neglpost_full`` forms
    them at the free parameters, with a = (Y^T psi_c)^T."""
    import torch
    from lcgp_tpu_torch.models import params as P
    ls, amp, lsig_g, nug = P.constrain(free)
    sigma = torch.exp(P.expand_sigma(lsig_g, m._data.sigma_map))
    a = (m._data.ys.T @ (m._data.phi / torch.sqrt(sigma)[:, None])).T
    return ls, amp, nug, m._data.diag_D, a.contiguous()


def loss_factor(m, ls, amp, nug, D):
    """The lower Cholesky factor of the loss's B = D C + (1 + jitter) I,
    with the model's kernel."""
    import torch
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    dv = torch.full((D.shape[0], m.n), 1.0 + m._jitter, dtype=D.dtype,
                    device=D.device)
    return linalg.cholesky(gram_factor_target(m.x, ls, amp, nug,
                                              row_scale=D, diag_vec=dv,
                                              kind=m.kernel))


def fused_operands(m, ls, amp, nug, D, a):
    """The loss gradient's (B^{-1}, w = B^{-1} a), formed as the loss forms
    them."""
    from lcgp_tpu_torch.ops import linalg
    L = loss_factor(m, ls, amp, nug, D)
    w = linalg.cho_solve_vec(L, a).contiguous()
    return linalg.chol_inverse(L), w


def vjp_extended(xs, ls, amp, nug, k, M, alpha, beta, w, rows=256,
                 kind="matern32"):
    """Component k of the kind's VJP, (glens (d,), gamp, gnug), recomputed
    on the host in extended precision from the same f64 operands:
    cotangent alpha_k M_k + beta w_k w_k^T, distances subtracted first.
    Pairs whose decay's exponent exceeds 1000 are left out: their terms are
    below e^-1000 times the factors, far under any bound."""
    ld = np.longdouble
    X64 = xs.cpu().numpy()
    X = X64.astype(ld)
    inv64 = 1 / ls[k].cpu().numpy()
    inv = 1 / ls[k].cpu().numpy().astype(ld)
    Mk = M[k].cpu().numpy()
    wk = None if w is None else w[k].cpu().numpy().astype(ld)
    a_k = ld(1.0) if alpha is None else ld(float(alpha[k]))
    n, d = X.shape
    g0, gl = ld(0), np.zeros(d, ld)
    for r0 in range(0, n, rows):
        S64 = np.abs(X64[r0:r0 + rows, None, :] - X64[None]) * inv64
        if kind == "rbf":
            expo = 0.5 * (S64 * S64).sum(2)
        else:
            expo = (SQRT5 if kind == "matern52" else 1.0) * S64.sum(2)
        i, j = np.nonzero(expo < 1000.0)
        i = i + r0
        S = np.abs(X[i] - X[j]) * inv
        cb = a_k * Mk[i, j].astype(ld)
        if wk is not None:
            cb = cb + ld(beta) * wk[i] * wk[j]
        cc = cb * c0_extended(kind, S)
        g0 += cc.sum()
        gl += (cc[:, None] * lens_extended(kind, S)).sum(axis=0)
    diag = a_k * np.diagonal(Mk).astype(ld)
    if wk is not None:
        diag = diag + ld(beta) * wk * wk
    g1 = diag.sum()
    A, N = ld(float(amp[k])), ld(float(nug[k]))
    eta = N / (1 + N)
    return (A * (1 - eta) * gl * inv, (1 - eta) * g0 + eta * g1,
            A * (g1 - g0) / (1 + N) ** 2)


def compare_vjp(name, got, ref, scale, extended=None, vjp_bound=VJP_BOUND,
                kernel="K2"):
    """A VJP kernel's (K2 by default) (glens, gamp, gnug) against the plain
    version's: each error at most ``vjp_bound`` times the magnitude of its
    sum's terms.  Where the two differ by more, and ``extended(k)`` is
    given, component k is recomputed in extended precision and the kernel
    must be within the bound of that.  Returns the max abs error against
    the best reference."""
    import torch
    worst = share = 0.0
    flagged = set()
    for part, g, r, s in zip(("glens", "gamp", "gnug"), got, ref, scale):
        check(bool(torch.isfinite(g).all()),
              f"{name}: non-finite {kernel} {part}")
        out = (g.double() - r.double()).abs() > vjp_bound * s
        if extended is None:
            check(not bool(out.any()), f"{name}: {int(out.sum())} entries of "
                  f"{part} outside {vjp_bound:g} x the magnitude of their "
                  "terms")
        flagged |= {int(i) for i in out.nonzero(as_tuple=True)[0]}
    keep = torch.ones(got[1].shape[0], dtype=torch.bool, device=got[1].device)
    keep[sorted(flagged)] = False
    for g, r, s in zip(got, ref, scale):
        err = (g.double() - r.double()).abs()[keep]
        if err.numel():
            worst = max(worst, float(err.max()))
            share = max(share, float((err / s[keep].clamp_min(1e-300)).max()))
    say(f"  {name}: max_abs_err={worst:.3e}, max err/magnitude={share:.3e} "
        f"(bound {vjp_bound:g}) over the {int(keep.sum())} components where "
        f"{kernel} and plain agree; max |glens| {float(ref[0].abs().max()):.3e}, "
        f"max |gamp| {float(ref[1].abs().max()):.3e}")
    if flagged:
        kshare = pshare = 0.0
        for k in sorted(flagged):
            ext = extended(k)
            for g, r, s, e in zip(got, ref, scale, ext):
                e = np.asarray(e, dtype=np.longdouble)
                sk = s[k].cpu().numpy().astype(np.longdouble)
                kerr = np.abs(g[k].cpu().numpy().astype(np.longdouble) - e)
                perr = np.abs(r[k].cpu().numpy().astype(np.longdouble) - e)
                worst = max(worst, float(np.max(kerr)))
                kshare = max(kshare, float(np.max(kerr / sk)))
                pshare = max(pshare, float(np.max(perr / sk)))
                check(bool(np.all(kerr <= vjp_bound * sk)),
                      f"{name}: {kernel} differs from the extended-precision sums "
                      f"of component {k} beyond {vjp_bound:g} x magnitude")
        say(f"  {name}: components {sorted(flagged)} differ from plain; "
            f"against extended precision there, {kernel} err/magnitude="
            f"{kshare:.3e}, plain err/magnitude={pshare:.3e}")
    return worst


def phase_vjp(dev, x, y, free_np):
    """Phase 3, K2 against the plain version.  Returns the kernel record."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.ops.matern import (fused_cotangent,
                                           launch_matern32_vjp,
                                           matern32_gram_vjp_fused_plain,
                                           matern32_gram_vjp_plain,
                                           matern32_gram_vjp_scale)
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    lib = build().lib
    f64 = torch.float64
    m = LCGP(y, x, q=20, device=dev)
    xs, q, n, d = m.x, int(m.q), m.n, m.d
    errs, times, bounds = [], None, None
    for label, free in (("init params", m.free),
                        ("fitted params",
                         free_params_from_numpy(*free_np, dev))):
        ls, amp, nug, D, a = loss_operands(m, free)
        Binv, w = fused_operands(m, ls, amp, nug, D, a)
        alpha = 0.5 * D

        def k_fused():
            return launch_matern32_vjp(xs, xs, ls, amp, nug, same=True,
                                       M=Binv, alpha=alpha, beta=-0.5, w=w)

        def p_fused():
            return matern32_gram_vjp_fused_plain(xs, ls, amp, nug, M=Binv,
                                                 alpha=alpha, beta=-0.5, w=w)
        got, ref = k_fused(), p_fused()
        again = k_fused()
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              "K2 fused: two launches on the same inputs differ")
        say(f"  K2 fused at the {label}: two launches give the same bits")
        scale = matern32_gram_vjp_scale(
            xs, xs, ls, amp, nug, same=True,
            cbar=fused_cotangent(Binv, alpha, -0.5, w))
        torch.cuda.synchronize()
        errs.append(compare_vjp(
            f"K2 fused f64 (q={q}, n={n}, d={d}), B^-1 and w at the {label} "
            f"(min lengthscale {float(ls.min()):.3e})", got, ref, scale,
            lambda k: vjp_extended(xs, ls, amp, nug, k, Binv, alpha, -0.5,
                                   w)))
        if times is None:
            torch.cuda.empty_cache()
            times = time_pair(f"K2 fused f64 (loss gradient, q={q} n={n})",
                              raw_vjp(lib, xs, ls, amp, nug, Binv, alpha,
                                      -0.5, w),
                              p_fused, Binv.numel() * 8, "read")
            bounds = say_bound(
                "K2 fused", times[0],
                (Binv.numel() + w.numel() + xs.numel() + 5 * q + ls.numel()
                 + q * (d + 2)) * 8,
                q * entries(n, n, True) * k2_ops_per_entry(d))
        del Binv, w, got, again, ref, scale
        torch.cuda.empty_cache()

        # the generic mode: a random non-symmetric cotangent, which pins
        # K2's pairing of the two triangles
        gen = torch.Generator(device=dev).manual_seed(4)
        cbar = torch.randn((q, n, n), generator=gen, dtype=f64, device=dev)
        got = launch_matern32_vjp(xs, xs, ls, amp, nug, same=True, M=cbar)
        ref = matern32_gram_vjp_plain(xs, xs, ls, amp, nug, same=True,
                                      cbar=cbar)
        scale = matern32_gram_vjp_scale(xs, xs, ls, amp, nug, same=True,
                                        cbar=cbar)
        torch.cuda.synchronize()
        errs.append(compare_vjp(
            f"K2 generic f64, random non-symmetric cotangent, {label}", got,
            ref, scale, lambda k: vjp_extended(xs, ls, amp, nug, k, cbar,
                                               None, 0.0, None)))
        if label == "init params":
            generic_ms = cuda_ms(raw_vjp(lib, xs, ls, amp, nug, cbar, None,
                                         0.0, None))
            say(f"  time K2 generic f64 (q={q} n={n}): kernel "
                f"{generic_ms:.4f} ms")
        del cbar, got, ref, scale
        torch.cuda.empty_cache()

    # the rep loss gradient's operating point: alpha = 1/2, M = (C + Lam)^-1
    # with Lam = diag(1/(D r)), w = u = (C + Lam)^-1 Lam b, b = r a
    ls, amp, nug, D, a = loss_operands(m, m.free)
    r = torch.as_tensor(np.random.default_rng(9).integers(1, 11, n),
                        dtype=f64, device=dev)
    lam = (1.0 / (D[:, None] * r[None, :])).contiguous()
    L = linalg.cholesky(gram_factor_target(xs, ls, amp, nug,
                                           row_scale=torch.ones_like(D),
                                           diag_vec=lam))
    Tinv = linalg.chol_inverse(L)
    u = linalg.cho_solve_vec(L, lam * r * a).contiguous()
    del L
    half = torch.full_like(D, 0.5)
    got = launch_matern32_vjp(xs, xs, ls, amp, nug, same=True, M=Tinv,
                              alpha=half, beta=-0.5, w=u)
    ref = matern32_gram_vjp_fused_plain(xs, ls, amp, nug, M=Tinv, alpha=half,
                                        beta=-0.5, w=u)
    scale = matern32_gram_vjp_scale(xs, xs, ls, amp, nug, same=True,
                                    cbar=fused_cotangent(Tinv, half, -0.5, u))
    torch.cuda.synchronize()
    errs.append(compare_vjp(
        f"K2 fused f64 at the rep operating point (alpha 1/2, M = (C + "
        f"Lam)^-1, w = u; r 1-10, q={q}, n={n}, d={d})", got, ref, scale,
        lambda k: vjp_extended(xs, ls, amp, nug, k, Tinv, half, -0.5, u)))
    del Tinv, u, lam, got, ref, scale
    torch.cuda.empty_cache()

    # ragged cross shape: nothing divides the block sizes
    rr = np.random.default_rng(5)
    xa = torch.as_tensor(rr.uniform(0, 1, (1000, d)), dtype=f64, device=dev)
    xb = torch.as_tensor(rr.uniform(0, 1, (977, d)), dtype=f64, device=dev)
    l7, a7, n7 = moderate_params(rr, 7, d, dev, f64)
    cbar = torch.as_tensor(rr.standard_normal((7, 1000, 977)), device=dev)
    got = launch_matern32_vjp(xa, xb, l7, a7, n7, same=False, M=cbar)
    ref = matern32_gram_vjp_plain(xa, xb, l7, a7, n7, same=False, cbar=cbar)
    scale = matern32_gram_vjp_scale(xa, xb, l7, a7, n7, same=False,
                                    cbar=cbar)
    torch.cuda.synchronize()
    errs.append(compare_vjp(f"K2 generic f64 ragged (q=7, n1=1000, n2=977, "
                            f"d={d}, same=False)", got, ref, scale))
    del m, cbar, got, ref, scale
    torch.cuda.empty_cache()
    return dict(name="matern32_gram_vjp", route="cuda", source=K2_SOURCE,
                replaces=K2_REPLACES, max_abs_err=max(errs),
                ms=times[0], plain_ms=times[1], bound_ms=bounds[0],
                bound_by=bounds[1], library_ms=None,
                shape=f"fused loss cotangent f64 q={q} n={n} d={d}")


def warm_timings(m, xte, reps: int = 5, requests: int = 20):
    """Steady-state host-clock times (each ends in a synchronize) after the
    first calls above: loss, aux, and 64-point requests."""
    import torch

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0
    loss_s = [timed(m.loss) for _ in range(reps)]
    aux_s = [timed(m.compute_aux_predictive_quantities) for _ in range(reps)]
    req_s = sorted(timed(lambda s=s: m.predict(xte[s:s + 64], batch_size=64))
                   for s in [64 * (r % 4) for r in range(requests)])
    say(f"  warm: loss median {statistics.median(loss_s):.4f} s, aux median "
        f"{statistics.median(aux_s):.4f} s (of {reps}); 64-point request "
        f"median {statistics.median(req_s) * 1e3:.2f} ms, p90 "
        f"{req_s[int(0.9 * (requests - 1))] * 1e3:.2f} ms (of {requests})")


def profile_device(label, fn, top):
    """Device time by kernel over one call of fn (torch.profiler); returns
    the total device time in ms."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events) / 1e3
    say(f"  profile of {label}: {total:.3f} ms device time in kernels; top "
        "kernels:")
    for e in events[:top]:
        say(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")
    return total


def softclip_np(v, clip):
    """SoftClip in NumPy (low + softplus(v - low) - softplus(v - high),
    clipped), independent of the port's torch version."""
    y = clip.low + np.logaddexp(v - clip.low, 0.0) - np.logaddexp(
        v - clip.high, 0.0)
    return np.minimum(np.maximum(y, clip.low), clip.high)


def directional_check(name, f, z0, g, ndir, rtol, seed, h):
    """g . v against central differences of f along ``ndir`` random unit
    directions v; Richardson's (4 D(h/2) - D(h)) / 3 cancels the h^2 term,
    so h can stay large against f's rounding."""
    rng = np.random.default_rng(seed)
    worst = 0.0
    for i in range(ndir):
        v = rng.standard_normal(z0.size)
        v /= np.linalg.norm(v)
        d1 = (f(z0 + h * v) - f(z0 - h * v)) / (2 * h)
        d2 = (f(z0 + 0.5 * h * v) - f(z0 - 0.5 * h * v)) / h
        fd = (4 * d2 - d1) / 3
        an = float(g @ v)
        rel = abs(an - fd) / abs(fd)
        worst = max(worst, rel)
        say(f"  {name}, direction {i}: gradient {an:.12e}, central "
            f"differences {fd:.12e} (h={h:g}, Richardson), rel {rel:.3e}")
    check(worst <= rtol, f"{name}: gradient differs from central differences "
          f"by {worst:.3e} > rtol {rtol:g}")
    return worst


def phase_oracle(dev):
    """Phase 4: the port on the card against the NumPy oracle."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.models import params as P
    rng = np.random.default_rng(3)
    n, p, d, q = 300, 20, 3, 4
    x = rng.uniform(0, 1, (n + 40, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, 2:3].T)
         + 0.05 * rng.standard_normal((p, n + 40)))
    m = LCGP(y[:, :n], x[:n], q=q, device=dev)
    m.set_params(lLmb=rng.uniform(0.2, 1.5, (q, d)),
                 lLmb0=rng.uniform(0.5, 3.0, q),
                 lnugGPs=rng.uniform(1e-6, 1e-3, q))
    loss = float(m.loss())
    out = [o.cpu().numpy() for o in m.predict(x[n:], return_fullcov=True)]

    def h(a):
        return a.cpu().numpy()
    lLmb, lLmb0, lsig, lnug = (h(v) for v in P.constrain(m.free))
    args = (lLmb, lLmb0, lsig, lnug, h(m.x), h(m.y), h(m.phi), h(m.diag_D),
            m.diag_error_structure)
    loss_ref = oracle.neglpost_full_np(*args)
    ref = oracle.predict_full_np(*args, h(m.ymean), h(m.ystd),
                                 h(m._standardize_x0(x[n:])),
                                 return_fullcov=True)
    loss_rel = abs(loss - loss_ref) / abs(loss_ref)
    say(f"  loss {loss:.12g} vs oracle {loss_ref:.12g}: rel {loss_rel:.3e}")
    check(loss_rel <= 1e-9, "loss differs from the oracle beyond rtol 1e-9")
    for name, a, b in zip(("mean", "predvar", "confvar", "fullcov"), out, ref):
        err = np.abs(a - b)
        rel = float(np.max(err / np.maximum(np.abs(b), 1e-300)))
        say(f"  {name}: max_abs_err={float(err.max()):.3e} max_rel_err={rel:.3e}")
        check(bool(np.all(err <= 1e-12 + 1e-7 * np.abs(b))),
              f"{name} differs from the oracle beyond rtol 1e-7")

    # the loss gradient on the card (K1, K2 and autograd) against central
    # differences of the oracle's loss in the free parameters
    from lcgp_tpu_torch.models import likelihood as lik
    free = P.FreeParams(*(t.clone().requires_grad_(True) for t in m.free))
    v = lik.neglpost_full(free, m._data, jitter=m._jitter)
    g = np.concatenate([h(t).ravel() for t in torch.autograd.grad(v, free)])
    shapes = [tuple(t.shape) for t in m.free]
    cuts = np.cumsum([int(np.prod(s)) for s in shapes])[:-1]
    data = (h(m.x), h(m.y), h(m.phi), h(m.diag_D), m.diag_error_structure)

    def f(z):
        lLmb, lLmb0, lsig, lnug = (part.reshape(s) for part, s in
                                   zip(np.split(z, cuts), shapes))
        return oracle.neglpost_full_np(
            softclip_np(lLmb, P.LLMB_CLIP), softclip_np(lLmb0, P.LLMB0_CLIP),
            lsig, softclip_np(lnug, P.LNUG_CLIP), *data)
    z0 = np.concatenate([h(t).ravel() for t in m.free])
    directional_check("gradient vs oracle", f, z0, g, ndir=4, rtol=1e-6,
                      seed=7, h=1e-3)
    check(torch.cuda.is_available(), "lost the card")


def launches_of(fn, kind="matern32"):
    """(Gram, VJP) launches of the kind's kernels (K1, K2 by default) in
    one call of fn."""
    f = family_of(kind)
    k1, k2 = f.gram.launches, f.vjp.launches
    fn()
    return f.gram.launches - k1, f.vjp.launches - k2


def phase_main(dev, x, y, xte, ytrue, free_np):
    """Phase 5: the main path at config 4.  Returns the K1 launch count
    and the (K1, K2) launches of one loss, one aux build and one request."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.ops.matern import matern32_gram

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    matern32_gram.launches = 0

    t0 = time.perf_counter()
    m = LCGP(y, x, q=20, device=dev)
    m.free = free_params_from_numpy(*free_np, dev)
    build_s = sync_s(t0)
    say(f"  construct + load fitted params: {build_s:.3f} s "
        f"(q_chunk={m.q_chunk})")

    t0 = time.perf_counter()
    loss = float(m.loss())
    loss_s = sync_s(t0)
    say(f"  loss(): {loss:.10g} in {loss_s:.3f} s")

    t0 = time.perf_counter()
    m.compute_aux_predictive_quantities()
    aux_s = sync_s(t0)
    say(f"  aux (Gram+epilogue, Cholesky, solve): {aux_s:.3f} s")

    outs, req_s = [], []
    for s in range(0, xte.shape[0], 64):
        t0 = time.perf_counter()
        outs.append(m.predict(xte[s:s + 64], batch_size=64))
        req_s.append(sync_s(t0))
    say("  predict(batch_size=64) requests: "
        + ", ".join(f"{r:.4f}" for r in req_s) + " s")
    ypred, ypredvar, yconfvar = (torch.cat([o[i] for o in outs], dim=1)
                                 for i in range(3))

    t0 = time.perf_counter()
    fc = m.predict(xte[:8], return_fullcov=True)
    fc_s = sync_s(t0)
    say(f"  predict(8 points, return_fullcov=True): {fc_s:.4f} s")
    launches = matern32_gram.launches
    peak_gb = torch.cuda.max_memory_allocated() / 1e9

    for name, a in (("ypred", ypred), ("ypredvar", ypredvar),
                    ("yconfvar", yconfvar), ("fullcov", fc[3])):
        check(bool(torch.isfinite(a).all()), f"main path: {name} not finite")
    check(tuple(ypred.shape) == (1000, 256), f"ypred shape {tuple(ypred.shape)}")
    check(bool((ypredvar > 0).all()), "main path: predvar not positive")
    diag = torch.diagonal(fc[3], dim1=-2, dim2=-1).T
    check(bool(torch.allclose(diag, fc[1], rtol=1e-10, atol=0)),
          "main path: diag(fullcov) != predvar")
    check(bool(torch.allclose(fc[0], ypred[:, :8], rtol=1e-10, atol=1e-12)),
          "main path: fullcov request mean != batched mean")
    rmse = float(np.sqrt(np.mean((ypred.cpu().numpy() - ytrue) ** 2)))
    say(f"  held-out RMSE over 256 points x 1000 outputs: {rmse:.6f}")
    say(f"  torch.cuda.max_memory_allocated: {peak_gb:.3f} GB")
    say(f"  K1 launches on the main path: {launches}")
    check(launches >= 7, f"K1 launched {launches} times, expected >= 7 "
          "(loss 1 + aux 1 + 4 requests + 1 fullcov request)")
    check(np.isfinite(loss), "loss not finite")
    warm_timings(m, xte)
    per_call = {"loss": launches_of(m.loss),
                "aux": launches_of(m.compute_aux_predictive_quantities),
                "request": launches_of(
                    lambda: m.predict(xte[:64], batch_size=64))}

    def aux_and_request():
        m.compute_aux_predictive_quantities()
        m.predict(xte[:64], batch_size=64)
    profile_device("one aux + one request", aux_and_request, 8)
    return launches, per_call


@contextlib.contextmanager
def plain_kernels():
    """Inside: the loss runs the plain versions of its kernel's Gram and
    VJP kernels (K1 and K2 for Matern 3/2) on the same CUDA tensors, for
    the reference gradient."""
    from lcgp_tpu_torch.models import likelihood as lik
    from lcgp_tpu_torch.ops import linalg

    def factor_target(x, ls, amp, nug, *, row_scale, diag_vec, kind,
                      compute_dtype=None):
        check(compute_dtype is None, "plain_kernels is for precision 'high'")
        C = family_of(kind).plain(x, x, ls, amp, nug, same=True)
        return linalg.add_diag(row_scale[:, None, None] * C, diag_vec)

    def vjp_fused(x, ls, amp, nug, *, M, alpha, beta, w, kind):
        return family_of(kind).fused_plain(x, ls, amp, nug, M=M, alpha=alpha,
                                          beta=beta, w=w)
    saved = lik.gram_factor_target, lik.gram_vjp_fused
    lik.gram_factor_target, lik.gram_vjp_fused = factor_target, vjp_fused
    try:
        yield
    finally:
        lik.gram_factor_target, lik.gram_vjp_fused = saved


# the f64 peak of an H100 SXM at 700 W (tensor cores), FLOP/s
F64_PEAK = 67e12


def dense_chol_inverse(L):
    """The plain yardstick of B^{-1}: a triangular solve against I, then
    L^{-T} L^{-1} as one dense matmul, 3n^3 flops (``chol_inverse``'s form
    below two blocks)."""
    import torch
    eye = torch.eye(L.shape[-1], dtype=L.dtype, device=L.device)
    linv = torch.linalg.solve_triangular(L, eye.expand_as(L), upper=False)
    inv = linv.mT @ linv
    return inv if inv.is_contiguous() else inv.mT.contiguous()


def time_inverse(m):
    """B^{-1} from the factor at the model's parameters, CUDA-event medians
    of 3: ``chol_inverse`` on a copy of the factor and in the factor's own
    storage (``overwrite=True``, as the loss calls it), the dense yardstick
    and ``torch.cholesky_inverse``, against the bound of 2n^3/3 flops a
    component at the f64 peak; then the blocked form (forced) against the
    dense one at the factor's leading n = 1024 and 2048, the numbers that
    set ``linalg._BLOCKED_MIN_N``."""
    import torch
    from lcgp_tpu_torch.ops import linalg
    ls, amp, nug, D, _ = loss_operands(m, m.free)
    L = loss_factor(m, ls, amp, nug, D)
    q = D.shape[0]
    work = torch.empty_like(L)
    copy = cuda_ms(lambda: work.copy_(L), reps=3)
    for n in sorted({1024, 2048, m.n} & set(range(m.n + 1))):
        Ln = L[..., :n, :n].clone()
        bound = q * 2 * n ** 3 / 3 / F64_PEAK * 1e3
        plain = cuda_ms(lambda: dense_chol_inverse(Ln), reps=3)
        blocked = cuda_ms(lambda: linalg._gram_tri_lower_(
            linalg._tri_inverse_blocked_(Ln.clone())), reps=3)
        a, b = linalg.chol_inverse(Ln), dense_chol_inverse(Ln)
        rel = float((a - b).abs().max() / b.abs().max())
        # the two forms round apart by up to ~cond(B) eps; a wrong block
        # reads O(1)
        check(rel <= 1e-8 and torch.equal(a, a.mT) and a.is_contiguous(),
              f"chol_inverse at n={n}: {rel:.3e} off the dense form, or not "
              "exactly symmetric and row-major")
        say(f"  B^-1 (q={q}, n={n}): blocked {blocked:.3f} ms (copy "
            "included), dense " f"{plain:.3f} ms, bound {bound:.3f} ms "
            f"(blocked {bound / blocked:.1%} of it); max diff {rel:.3e} of "
            "max |B^-1|")
        del Ln, a, b
    ours = cuda_ms(lambda: linalg.chol_inverse(L), reps=3)
    inplace = cuda_ms(lambda: linalg.chol_inverse(work.copy_(L),
                                                  overwrite=True),
                      reps=3) - copy
    lib = cuda_ms(lambda: torch.cholesky_inverse(L), reps=3)
    rel = float((linalg.chol_inverse(L) - torch.cholesky_inverse(L)).abs()
                .max() / torch.cholesky_inverse(L).abs().max())
    say(f"  B^-1 (q={q}, n={m.n}): chol_inverse {ours:.3f} ms, in the "
        f"factor's storage {inplace:.3f} ms, torch.cholesky_inverse "
        f"{lib:.3f} ms (max diff {rel:.3e} of max |B^-1|)")


def time_cholesky(m, frees):
    """The factor of the loss's B, at each (label, free parameters) of
    ``frees``, for the first 10 components ((10, 4096, 4096) at config 4,
    the benchmark's chunk at ``q_chunk`` 10), in f64 and f32; CUDA-event
    medians of 3: ``linalg.cholesky`` in B's storage (``overwrite=True``,
    as the loss calls it) and on a copy, one batched
    ``torch.linalg.cholesky_ex`` and one ``cholesky_ex`` call a matrix,
    against the bound of n^3/3 flops a
    component at the f64 peak; then the normwise residual
    ||L L^T - B||_F / ||B||_F, worst component, of the blocked factor and
    of ``cholesky_ex``.  Checks that every timed ``linalg.cholesky`` call
    took the blocked path and, in f64, that its residual stays within 10x
    of ``cholesky_ex``'s."""
    import torch
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops.gram import gram_factor_target

    def residual(L, B):
        L, B = L.double(), B.double()
        B = torch.tril(B) + torch.tril(B, -1).mT
        r = torch.linalg.matrix_norm(L @ L.mT - B) / torch.linalg.matrix_norm(B)
        return float(r.max())

    qc = min(m.q, 10)
    paths = (linalg.cholesky.blocked, linalg.cholesky.dense)
    for label, free in frees:
        ls, amp, nug, D, _ = loss_operands(m, free)
        dv = torch.full((qc, m.n), 1.0 + m._jitter, dtype=D.dtype,
                        device=D.device)
        B64 = gram_factor_target(m.x, ls[:qc], amp[:qc], nug[:qc],
                                 row_scale=D[:qc], diag_vec=dv,
                                 kind=m.kernel)
        for B in (B64, B64.float()):
            bound = qc * m.n ** 3 / 3 / F64_PEAK * 1e3
            work = torch.empty_like(B)
            copy = cuda_ms(lambda: work.copy_(B), reps=3)
            inplace = cuda_ms(lambda: linalg.cholesky(work.copy_(B),
                                                      overwrite=True),
                              reps=3) - copy
            ours = cuda_ms(lambda: linalg.cholesky(B), reps=3)
            lib = cuda_ms(lambda: torch.linalg.cholesky_ex(B), reps=3)
            one = cuda_ms(lambda: [torch.linalg.cholesky_ex(b) for b in B],
                          reps=3)
            L = linalg.cholesky(B)
            L_lib = torch.linalg.cholesky_ex(B)[0]
            r_ours, r_lib = residual(L, B), residual(L_lib, B)
            del L, L_lib, work
            say(f"  factor of B at the {label} ({tuple(B.shape)}, "
                f"{str(B.dtype).replace('torch.', '')}): blocked in B's "
                f"storage {inplace:.3f} ms ({bound / inplace:.1%} of the "
                f"{bound:.3f} ms bound), on a copy {ours:.3f} ms, "
                f"cholesky_ex batched {lib:.3f} ms ({bound / lib:.1%}), one "
                f"matrix a call {one:.3f} ms ({bound / one:.1%}); residual "
                f"||LL^T - B|| / ||B|| blocked {r_ours:.3e}, cholesky_ex "
                f"{r_lib:.3e}")
            if B.dtype == torch.float64:
                check(r_ours <= 10 * max(r_lib, 1e-16), f"the blocked "
                      f"factor's residual {r_ours:.3e} at the {label} is "
                      f"over 10x cholesky_ex's {r_lib:.3e}")
        del B64, B
    paths = (linalg.cholesky.blocked - paths[0],
             linalg.cholesky.dense - paths[1])
    say(f"  linalg.cholesky calls timed (blocked, dense): {paths}")
    check(paths[0] > 0 and paths[1] == 0, "expected every linalg.cholesky "
          "call at the loss's chunk blocked")


def phase_train(dev, x, y, xte, ytrue):
    """Phase 6: training at config 4 from the data-driven init.  Returns
    the K1 and K2 launch counts of the fit and the (K1, K2) launches of one
    loss+grad evaluation."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops.matern import matern32_gram, matern32_gram_vjp

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m = LCGP(y, x, q=20, device=dev)
    say(f"  LCGP(y, x, q=20) from its data-driven init (q_chunk={m.q_chunk})")
    loss_fn = m._loss_fn()
    flat = Flattener(m.free)
    vg = value_and_grad(loss_fn, flat)
    z0 = flat.ravel(m.free).cpu().numpy()
    free_init = type(m.free)(*(v.detach().clone() for v in m.free))

    # one loss+grad evaluation as scipy sees it (host value and gradient)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    v0, g0 = vg(z0)
    first_s = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        vg(z0)
        warm.append(time.perf_counter() - t0)
    per_eval = launches_of(lambda: vg(z0))
    say(f"  loss+grad evaluation: first {first_s:.4f} s, warm median "
        f"{statistics.median(warm):.4f} s of 5 ("
        + ", ".join(f"{t:.4f}" for t in warm) + ")")
    say(f"  torch.cuda.max_memory_allocated over those evaluations (model "
        f"included): {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(np.isfinite(v0) and bool(np.isfinite(g0).all()),
          "loss+grad at the init not finite")

    # the same evaluation with the plain versions of K1 and K2
    k1, k2 = matern32_gram.launches, matern32_gram_vjp.launches
    with plain_kernels():
        vp, gp = vg(z0)
    check((matern32_gram.launches, matern32_gram_vjp.launches) == (k1, k2),
          "the plain reference launched a kernel")
    loss_rel = abs(v0 - vp) / abs(vp)
    say(f"  loss {v0:.12e} vs plain kernels {vp:.12e}: rel {loss_rel:.3e}")
    check(loss_rel <= 1e-10, "loss differs from the plain kernels' loss")
    start = 0
    for name, size in zip(("lLmb", "lLmb0", "lsigma2s", "lnugGPs"),
                          flat.sizes):
        a, b = g0[start:start + size], gp[start:start + size]
        start += size
        err, top = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
        say(f"  gradient {name}: max_abs_err={err:.3e} vs the plain kernels "
            f"(max |g| {top:.3e}, rel {err / top:.3e})")
        check(err <= GRAD_RTOL * top, f"gradient {name} differs from the "
              f"plain kernels' beyond {GRAD_RTOL:g} of its max |g|")
    del vp, gp
    torch.cuda.empty_cache()

    def f(z):
        with torch.no_grad():
            return float(loss_fn(flat.unravel_host(z)))
    directional_check("config-4 gradient vs central differences", f, z0, g0,
                      ndir=3, rtol=1e-5, seed=8, h=1e-3)

    # a short scipy fit: every evaluation is one K1 and one K2 launch
    losses = []

    def recording_loss_fn(real=m._loss_fn):
        fn = real()

        def loss(free):
            v = fn(free)
            losses.append(v.detach())
            return v
        return loss
    m._loss_fn = recording_loss_fn
    l_init = float(m.loss())
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    matern32_gram.launches = 0
    matern32_gram_vjp.launches = 0
    inv_paths = (linalg.chol_inverse.blocked, linalg.chol_inverse.dense)
    chol_paths = (linalg.cholesky.blocked, linalg.cholesky.dense)
    t0 = time.perf_counter()
    m.fit(method="scipy", maxiter=20)
    fit_s = sync_s(t0)
    inv_paths = (linalg.chol_inverse.blocked - inv_paths[0],
                 linalg.chol_inverse.dense - inv_paths[1])
    chol_paths = (linalg.cholesky.blocked - chol_paths[0],
                  linalg.cholesky.dense - chol_paths[1])
    # the wrapper and m form a reference cycle, which would keep m and
    # the aux it builds below alive past this phase
    del m._loss_fn
    k1_fit, k2_fit = matern32_gram.launches, matern32_gram_vjp.launches
    res = m._fit_result
    say(f"  fit(method='scipy', maxiter=20): stop_reason={res.stop_reason!r} "
        f"nit={res.nit} nfev={res.nfev} in {fit_s:.3f} s "
        f"({fit_s / res.nfev:.4f} s per evaluation, "
        f"{fit_s / max(res.nit, 1):.4f} s per iteration); loss "
        f"{l_init:.10g} -> {res.fun:.10g}")
    say(f"  K1 launches in the fit: {k1_fit}; K2 launches: {k2_fit}")
    check(k2_fit == res.nfev, f"K2 launched {k2_fit} times in {res.nfev} "
          "evaluations, expected one per evaluation")
    check(k1_fit == res.nfev, f"K1 launched {k1_fit} times in {res.nfev} "
          "evaluations")
    chunks = m.q // m.q_chunk if m.q_chunk else 1
    say(f"  chol_inverse calls in the fit (blocked, dense): {inv_paths}")
    check(inv_paths == (chunks * res.nfev, 0), "expected every chol_inverse "
          f"call blocked, {chunks} an evaluation")
    say(f"  linalg.cholesky calls in the fit (blocked, dense): {chol_paths}")
    check(chol_paths == (chunks * res.nfev, 0), "expected every "
          f"linalg.cholesky call blocked, {chunks} an evaluation")
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          "a loss in the fit was not finite")
    check(res.fun < l_init, "the fit did not lower the loss")
    z_fit = flat.ravel(m.free).cpu().numpy()
    v_fit, g_fit = vg(z_fit)
    check(np.isfinite(v_fit) and bool(np.isfinite(g_fit).all()),
          "loss+grad at the fitted parameters not finite")
    peak_gb = torch.cuda.max_memory_allocated() / 1e9
    say(f"  torch.cuda.max_memory_allocated over the fit (model included): "
        f"{peak_gb:.3f} GB")

    ypred = m.predict(xte)[0]
    check(bool(torch.isfinite(ypred).all()), "prediction after fit not finite")
    check(tuple(ypred.shape) == ytrue.shape, f"ypred shape {tuple(ypred.shape)}")
    rmse = float(np.sqrt(np.mean((ypred.cpu().numpy() - ytrue) ** 2)))
    say(f"  held-out RMSE after the 20-iteration fit, {ytrue.shape[1]} points "
        f"x {ytrue.shape[0]} outputs: {rmse:.6f}")
    check(np.isfinite(rmse), "RMSE not finite")
    profile_device("one loss+grad evaluation", lambda: vg(z_fit), 10)
    time_inverse(m)
    from lcgp_tpu_torch.convert import free_params_from_numpy
    with np.load(FITTED, allow_pickle=False) as z:
        fitted = free_params_from_numpy(*(z[k] for k in (
            "lLmb", "lLmb0", "lsigma2s", "lnugGPs")), dev)
    time_cholesky(m, [("init", free_init), ("committed fit", fitted)])
    return k1_fit, k2_fit, per_eval, rmse


def rep_problem(seed, n_unique, d, p, n0, max_reps):
    """Raw replicated data: n_unique sites with 1..max_reps replicates each
    (each replicate draws its own noise), rows shuffled, and n0 held-out
    points."""
    rng = np.random.default_rng(seed)
    xu = rng.uniform(0, 1, (n_unique + n0, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + xu[:, :1].T)) * xu[:, 1:2].T
         + np.cos(np.pi * t * xu[:, 2:3].T))
    reps = rng.integers(1, max_reps + 1, n_unique)
    x = np.repeat(xu[:n_unique], reps, axis=0)
    y = np.repeat(f[:, :n_unique], reps, axis=1)
    y = y + 0.1 * rng.standard_normal(y.shape)
    order = rng.permutation(x.shape[0])
    return x[order], y[:, order], xu[n_unique:]


def rep_oracle_args(m):
    """(constrained params, RepData fields, error structure) of a rep model,
    as ``oracle.neglpost_rep_np`` takes them."""
    from lcgp_tpu_torch.models import params as P

    def h(a):
        return a.detach().cpu().numpy()
    dat = m._data
    return ((*(h(v) for v in P.constrain(m.free)),),
            (h(dat.xs), h(dat.ybar), h(dat.scale), h(dat.r), h(dat.phi),
             h(dat.diag_D), m.diag_error_structure))


def phase_oracle_rep(dev):
    """Phase 4, rep path: the port on the card against the NumPy oracle at
    n_unique=200 (replicate counts 1-5), p=20, q=4, both
    rep_standardize_ybar settings and a grouped error structure: loss rtol
    1e-9, predictions rtol 1e-7 (atol 1e-9), the gradient against central
    differences of ``oracle.neglpost_rep_np`` rtol 1e-6."""
    import torch
    sys.path.insert(0, str(ROOT / "tests"))
    import oracle
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.models import likelihood as lik
    from lcgp_tpu_torch.models import params as P
    x, y, x0 = rep_problem(10, 200, 3, 20, 30, 5)
    for case, (std, des) in enumerate(((True, None), (False, None),
                                       (True, [5, 5, 10]))):
        m = LCGP(y, x, q=4, submethod="rep", rep_standardize_ybar=std,
                 diag_error_structure=des, device=dev)
        rng = np.random.default_rng(20 + case)
        m.set_params(lLmb=rng.uniform(0.2, 1.5, (4, 3)),
                     lLmb0=rng.uniform(0.5, 3.0, 4),
                     lnugGPs=rng.uniform(1e-6, 1e-3, 4))
        label = (f"rep_standardize_ybar={std}, diag_error_structure="
                 f"{m.diag_error_structure if des else 'ones'}")
        say(f"  {label}: n_unique={m.n} of N={x.shape[0]} rows")
        params, data = rep_oracle_args(m)
        loss = float(m.loss())
        loss_ref = oracle.neglpost_rep_np(*params, *data)
        loss_rel = abs(loss - loss_ref) / abs(loss_ref)
        say(f"  loss {loss:.12g} vs oracle {loss_ref:.12g}: rel "
            f"{loss_rel:.3e}")
        check(loss_rel <= 1e-9, "rep loss differs from the oracle beyond "
              "rtol 1e-9")
        out = [o.cpu().numpy() for o in m.predict(x0)]
        ref = oracle.predict_rep_np(
            *params, *data, m.ybar_mean.cpu().numpy(),
            m.ybar_std.cpu().numpy(), std,
            m._standardize_x0(x0).cpu().numpy())
        for name, a, b in zip(("mean", "predvar", "confvar"), out, ref):
            err = np.abs(a - b)
            rel = float(np.max(err / np.maximum(np.abs(b), 1e-300)))
            say(f"  {name}: max_abs_err={float(err.max()):.3e} "
                f"max_rel_err={rel:.3e}")
            # atol 1e-9: the oracle's explicit inv(C) (lcgp_tpu's own rep
            # oracle bar, tests/test_predict.py:127)
            check(bool(np.all(err <= 1e-9 + 1e-7 * np.abs(b))),
                  f"rep {name} differs from the oracle beyond rtol 1e-7, "
                  "atol 1e-9")

        free = P.FreeParams(*(t.clone().requires_grad_(True) for t in m.free))
        v = lik.neglpost_rep(free, m._data, jitter=m._jitter)
        g = np.concatenate([t.cpu().numpy().ravel()
                            for t in torch.autograd.grad(v, free)])
        shapes = [tuple(t.shape) for t in m.free]
        cuts = np.cumsum([int(np.prod(sh)) for sh in shapes])[:-1]

        def f(z):
            lLmb, lLmb0, lsig, lnug = (part.reshape(sh) for part, sh in
                                       zip(np.split(z, cuts), shapes))
            return oracle.neglpost_rep_np(
                softclip_np(lLmb, P.LLMB_CLIP),
                softclip_np(lLmb0, P.LLMB0_CLIP), lsig,
                softclip_np(lnug, P.LNUG_CLIP), *data)
        z0 = np.concatenate([t.cpu().numpy().ravel() for t in m.free])
        directional_check("rep gradient vs oracle", f, z0, g, ndir=3,
                          rtol=1e-6, seed=30 + case, h=1e-3)


def config5():
    """BASELINE config 5, exactly as benchmarks/run_configs.py:config5: 1000
    unique sites x 10 replicates (N=10,000), p=3, d=4, and 400 held-out
    points with their noise-free truth."""
    rng = np.random.default_rng(7)
    n_unique, reps = 1000, 10
    xu = rng.uniform(0, 1, (n_unique, 4))
    f = np.vstack([np.sin(2 * np.pi * xu[:, 0]) * xu[:, 1],
                   np.cos(np.pi * xu[:, 2]) + xu[:, 3] ** 2,
                   xu[:, 0] * xu[:, 2]])
    noise = np.array([0.05, 0.1, 0.2])
    x = np.repeat(xu, reps, axis=0)
    y = (np.repeat(f, reps, axis=1)
         + rng.standard_normal((3, n_unique * reps)) * noise[:, None])
    xte = rng.uniform(0, 1, (400, 4))
    fte = np.vstack([np.sin(2 * np.pi * xte[:, 0]) * xte[:, 1],
                     np.cos(np.pi * xte[:, 2]) + xte[:, 3] ** 2,
                     xte[:, 0] * xte[:, 2]])
    return x, y, xte, fte


def phase_rep_serve(dev):
    """Phase 7: rep serving at BASELINE config 5 with its committed fit,
    on the card against the same model on the CPU (plain versions) and
    against lcgp_tpu's recorded loss and held-out RMSE.  Returns the K1
    launches of the card's run."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.ops.matern import matern32_gram
    x, y, xte, fte = config5()
    with np.load(FITTED_REP, allow_pickle=False) as z:
        free_np = tuple(z[k] for k in ("lLmb", "lLmb0", "lsigma2s", "lnugGPs"))
    kw = dict(submethod="rep", diag_error_structure=[1, 1, 1])
    cpu = LCGP(y, x, device="cpu", **kw)
    cpu.free = free_params_from_numpy(*free_np, "cpu")
    loss_cpu = float(cpu.loss())
    out_cpu = cpu.predict(xte)

    torch.cuda.synchronize()
    matern32_gram.launches = 0
    t0 = time.perf_counter()
    m = LCGP(y, x, device=dev, **kw)
    m.free = free_params_from_numpy(*free_np, dev)
    loss = float(m.loss())
    m.compute_aux_predictive_quantities()
    out = m.predict(xte)
    fc = m.predict(xte[:8], return_fullcov=True)
    torch.cuda.synchronize()
    launches = matern32_gram.launches
    say(f"  construct (N={x.shape[0]} rows -> n_unique={m.n}, q={m.q}), "
        f"loss, aux, predict at {xte.shape[0]} points and one fullcov "
        f"request: {time.perf_counter() - t0:.3f} s; K1 launches {launches}")
    check(launches == 4, f"K1 launched {launches} times, expected 4 (loss, "
          "aux, two requests)")
    check(len(fc) == 4 and fc[3] is None,
          "return_fullcov=True on the rep path does not give None")

    loss_rel = abs(loss - loss_cpu) / abs(loss_cpu)
    ref_rel = abs(loss - CONFIG5_LOSS) / abs(CONFIG5_LOSS)
    say(f"  loss {loss!r}: vs the port on the CPU rel {loss_rel:.3e}, vs "
        f"lcgp_tpu's {CONFIG5_LOSS!r} rel {ref_rel:.3e}")
    check(loss_rel <= 1e-9, "config-5 loss differs from the CPU run")
    check(ref_rel <= 1e-9, "config-5 loss differs from lcgp_tpu's")
    # Elementwise rtol 1e-9 is below this fit's conditioning: cond(C + Lam)
    # reaches ~2.5e7, so factors of one A by two libraries differ by ~1e-12
    # and the dual weights by up to ~1e-8 of their largest entry, which
    # shows as 1e-7 relative in entries near zero.  The outputs, the factor
    # and mks are held normwise, to 1e-9 of each one's largest entry; the
    # dual weights per component to n eps cond(A_k), what a backward-stable
    # factor of the same system allows.
    aux, aux_cpu = m._ensure_aux(), cpu._ensure_aux()
    for name in ("LT", "mks"):
        compare_normwise(f"aux {name} vs the CPU run",
                         getattr(aux, name).cpu(), getattr(aux_cpu, name),
                         1e-9)
    ev = torch.linalg.eigvalsh(aux_cpu.LT @ aux_cpu.LT.mT)
    cond = (ev[:, -1] / ev[:, 0]).numpy()
    eps_n = float(np.finfo(np.float64).eps) * m.n
    for k in range(int(m.q)):
        compare_normwise(f"aux CinvM[{k}] vs the CPU run (cond(A_k) "
                         f"{cond[k]:.3e})", aux.CinvM[k].cpu(),
                         aux_cpu.CinvM[k], eps_n * cond[k])
    for name, a, b in zip(("ypred", "ypredvar", "yconfvar"), out, out_cpu):
        compare_normwise(f"{name} vs the CPU run", a.cpu(), b, 1e-9)
    rmse = float(np.sqrt(np.mean((out[0].cpu().numpy() - fte) ** 2)))
    rmse_rel = abs(rmse - CONFIG5_RMSE) / CONFIG5_RMSE
    say(f"  held-out RMSE over 400 points x 3 outputs: {rmse!r} vs "
        f"lcgp_tpu's {CONFIG5_RMSE!r}: rel {rmse_rel:.3e}")
    check(rmse_rel <= 1e-6, "config-5 RMSE differs from lcgp_tpu's")
    per_call = {"rep_loss": launches_of(m.loss),
                "rep_aux": launches_of(m.compute_aux_predictive_quantities)}
    return launches, per_call


def rep_full_width(n=4096, p=1000):
    """n=4096 unique sites x 10 replicates (N=40,960 raw rows), p=1000,
    d=8: the widths of bench.py's rep problem, whose replicate means carry
    noise 0.05/sqrt(10); here each replicate draws its own 0.05 noise.
    Plus 256 held-out points and their noise-free truth."""
    rng = np.random.default_rng(1)
    reps, d = 10, 8
    xu = rng.uniform(0, 1, (n + 256, d))
    t = np.linspace(0, 1, p)[:, None]
    f = np.sin(2 * np.pi * (t + xu[:, :1].T))
    x = np.repeat(xu[:n], reps, axis=0)
    y = np.repeat(f[:, :n], reps, axis=1)
    y += 0.05 * rng.standard_normal(y.shape)
    return x, y, xu[n:], f[:, n:]


def phase_rep_train(dev, n=4096, p=1000):
    """Phase 8: the rep path at full width, f64: construction (grouping
    included), one loss+grad evaluation timed and checked against the plain
    kernels and central differences, ``fit(method='scipy',
    maxiter=REP_MAXITER)`` with K1 and K2 launches equal to nfev, the aux,
    64-point requests, peak memory, the held-out RMSE and a profile.
    Returns the (K1, K2) launches of the fit and of the serving run, and
    the launches per call."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    from lcgp_tpu_torch.ops.matern import matern32_gram, matern32_gram_vjp

    def sync_s(t0):
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    x, y, xte, ytrue = rep_full_width(n, p)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    m = LCGP(y, x, q=20, submethod="rep", device=dev)
    build_s = sync_s(t0)
    say(f"  LCGP(y_raw ({p}, {x.shape[0]}), x_raw, q=20, submethod='rep'): "
        f"{build_s:.3f} s, grouping included -> n_unique={m.n}, r "
        f"{int(m.r.min())}-{int(m.r.max())} (q_chunk={m.q_chunk})")
    check(m.n == n and bool((m.r == 10).all()), "grouping went wrong")
    loss_fn = m._loss_fn()
    flat = Flattener(m.free)
    vg = value_and_grad(loss_fn, flat)
    z0 = flat.ravel(m.free).cpu().numpy()

    t0 = time.perf_counter()
    v0, g0 = vg(z0)
    first_s = time.perf_counter() - t0
    warm = []
    for _ in range(5):
        t0 = time.perf_counter()
        vg(z0)
        warm.append(time.perf_counter() - t0)
    per_eval = launches_of(lambda: vg(z0))
    say(f"  rep loss+grad evaluation: first {first_s:.4f} s, warm median "
        f"{statistics.median(warm):.4f} s of 5 ("
        + ", ".join(f"{t:.4f}" for t in warm) + f"); launches {per_eval}")
    check(np.isfinite(v0) and bool(np.isfinite(g0).all()),
          "rep loss+grad at the init not finite")

    k1, k2 = matern32_gram.launches, matern32_gram_vjp.launches
    with plain_kernels():
        vp, gp = vg(z0)
    check((matern32_gram.launches, matern32_gram_vjp.launches) == (k1, k2),
          "the plain reference launched a kernel")
    loss_rel = abs(v0 - vp) / abs(vp)
    say(f"  rep loss {v0:.12e} vs plain kernels {vp:.12e}: rel "
        f"{loss_rel:.3e}")
    check(loss_rel <= 1e-10, "rep loss differs from the plain kernels' loss")
    start = 0
    for name, size in zip(("lLmb", "lLmb0", "lsigma2s", "lnugGPs"),
                          flat.sizes):
        a, b = g0[start:start + size], gp[start:start + size]
        start += size
        err, top = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
        say(f"  rep gradient {name}: max_abs_err={err:.3e} vs the plain "
            f"kernels (max |g| {top:.3e}, rel {err / top:.3e})")
        check(err <= GRAD_RTOL * top, f"rep gradient {name} differs from the "
              f"plain kernels' beyond {GRAD_RTOL:g} of its max |g|")
    del vp, gp
    torch.cuda.empty_cache()

    def f(z):
        with torch.no_grad():
            return float(loss_fn(flat.unravel_host(z)))
    directional_check("rep gradient vs central differences", f, z0, g0,
                      ndir=3, rtol=1e-5, seed=11, h=1e-3)

    losses = []

    def recording_loss_fn(real=m._loss_fn):
        fn = real()

        def loss(free):
            v = fn(free)
            losses.append(v.detach())
            return v
        return loss
    m._loss_fn = recording_loss_fn
    l_init = float(m.loss())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    matern32_gram.launches = 0
    matern32_gram_vjp.launches = 0
    t0 = time.perf_counter()
    m.fit(method="scipy", maxiter=REP_MAXITER)
    fit_s = sync_s(t0)
    del m._loss_fn     # the reference cycle, as in phase 6
    k1_fit, k2_fit = matern32_gram.launches, matern32_gram_vjp.launches
    res = m._fit_result
    say(f"  fit(method='scipy', maxiter={REP_MAXITER}): stop_reason="
        f"{res.stop_reason!r} nit={res.nit} nfev={res.nfev} in {fit_s:.3f} s "
        f"({fit_s / res.nfev:.4f} s per evaluation, "
        f"{fit_s / max(res.nit, 1):.4f} s per iteration); loss "
        f"{l_init:.10g} -> {res.fun:.10g}")
    say(f"  K1 launches in the rep fit: {k1_fit}; K2 launches: {k2_fit}")
    check((k1_fit, k2_fit) == (res.nfev, res.nfev), f"the rep fit launched "
          f"K1 {k1_fit} and K2 {k2_fit} times in {res.nfev} evaluations")
    check(bool(torch.isfinite(torch.stack(losses)).all()),
          "a loss in the rep fit was not finite")
    check(res.fun < l_init, "the rep fit did not lower the loss")
    say(f"  torch.cuda.max_memory_allocated over the rep fit (model "
        f"included): {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    matern32_gram.launches = 0
    t0 = time.perf_counter()
    m.compute_aux_predictive_quantities()
    aux_s = sync_s(t0)
    req_s, outs = [], []
    for s in range(0, 256, 64):
        t0 = time.perf_counter()
        outs.append(m.predict(xte[s:s + 64], batch_size=64))
        req_s.append(sync_s(t0))
    k1_serve = matern32_gram.launches
    say(f"  rep aux {aux_s:.4f} s; predict(batch_size=64) requests "
        + ", ".join(f"{r:.4f}" for r in req_s) + f" s; K1 launches {k1_serve}")
    check(k1_serve == 5, f"rep serving launched K1 {k1_serve} times, "
          "expected 5 (aux 1 + 4 requests)")
    say(f"  torch.cuda.max_memory_allocated over rep serving (model "
        f"included): {torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    ypred, ypredvar, yconfvar = (torch.cat([o[i] for o in outs], dim=1)
                                 for i in range(3))
    for name, a in (("ypred", ypred), ("ypredvar", ypredvar),
                    ("yconfvar", yconfvar)):
        check(bool(torch.isfinite(a).all()), f"rep path: {name} not finite")
    check(tuple(ypred.shape) == ytrue.shape, f"ypred {tuple(ypred.shape)}")
    check(bool((ypredvar > 0).all()), "rep path: predvar not positive")
    rmse = float(np.sqrt(np.mean((ypred.cpu().numpy() - ytrue) ** 2)))
    say(f"  held-out RMSE after the {REP_MAXITER}-iteration rep fit, 256 "
        f"points x {p} outputs: {rmse:.6f}")
    warm_timings(m, xte)
    per_call = {"rep_loss_grad": per_eval,
                "rep_request": launches_of(
                    lambda: m.predict(xte[:64], batch_size=64))}
    z_fit = flat.ravel(m.free).cpu().numpy()
    profile_device("one rep loss+grad evaluation", lambda: vg(z_fit), 10)
    return (k1_fit, k2_fit), k1_serve, per_call


def f32_counts(kind="matern32"):
    """(Gram, VJP) launches of the kind's f32 instantiations so far (K1, K2
    by default)."""
    f = family_of(kind)
    return f.gram.launches_f32, f.vjp.launches_f32


def reset_counts(kind="matern32"):
    f = family_of(kind)
    for fn in (f.gram, f.vjp):
        fn.launches = fn.launches_f32 = 0


def phase_f32_kernels(dev, x, y, xte):
    """Phase 9, part 1: K1 and K2 f32 at full width against their plain f32
    versions on the config-4 problem at its data-driven init: K1's square
    with the 'fast' loss's epilogue and its 64-point request shape; K2 at
    the 'fast' operating point (M = B^-1 of the f32 factor) and the 'mixed'
    one (M = the f32 potri seed of the refined factor, w refined in f64).
    Returns the two kernel records."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.ops import linalg, mixed
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    from lcgp_tpu_torch.ops.matern import (fused_cotangent, launch_matern32,
                                           launch_matern32_vjp,
                                           matern32_gram_plain,
                                           matern32_gram_vjp_fused_plain,
                                           matern32_gram_vjp_scale)
    lib = build().lib
    f32, f64 = torch.float32, torch.float64
    m = LCGP(y, x, q=20, precision="fast", device=dev)
    q, n, d = int(m.q), m.n, m.d
    x0s = m._standardize_x0(xte)
    ls, amp, nug, D, a = loss_operands(m, m.free)
    xs32, ls32, amp32, nug32, D32 = (t.to(f32).contiguous()
                                     for t in (m.x, ls, amp, nug, D))
    dv = torch.full((q, n), 1.0 + m._jitter, dtype=f32, device=dev)
    k1_errs, k2_errs = [], []

    def p_sq():
        C = matern32_gram_plain(xs32, xs32, ls32, amp32, nug32, same=True)
        return linalg.add_diag(D32[:, None, None] * C, dv)
    B_k = launch_matern32(xs32, xs32, ls32, amp32, nug32, same=True,
                          row_scale=D32, diag_vec=dv)[0]
    B_p = p_sq()
    torch.cuda.synchronize()
    k1_errs.append(compare(f"K1 f32 square+epilogue B ('fast' loss: row "
                           f"scale D, diagonal 1 + 1e-6; q={q}, n={n}, "
                           f"d={d}) vs plain f32", B_k, B_p, F32_RTOL,
                           F32_ATOL))
    check(torch.equal(B_k, B_k.mT), "K1 f32 B is not exactly symmetric")
    del B_k, B_p
    torch.cuda.empty_cache()
    stack = q * n * n * 4
    k_ms, p_ms = time_pair(f"K1 f32 square+epilogue (q={q} n={n})",
                           raw_gram(lib, xs32, xs32, ls32, amp32, nug32, True,
                                    D32, dv), p_sq, stack)
    b_ms, b_by = say_bound(
        "K1 f32 square+epilogue", k_ms,
        stack + (xs32.numel() + ls32.numel() + 3 * q + dv.numel()) * 4,
        q * entries(n, n, True) * k1_ops_per_entry(d, True), F32_INSTR_PER_S)
    x64 = x0s[:64].to(f32).contiguous()

    def p_req():
        return matern32_gram_plain(x64, xs32, ls32, amp32, nug32, same=False)
    k1_errs.append(compare(f"K1 f32 rectangular, one request (q={q}, n1=64, "
                           f"n2={n}) vs plain f32",
                           launch_matern32(x64, xs32, ls32, amp32, nug32,
                                           same=False)[0], p_req(),
                           F32_RTOL, F32_ATOL))
    req_ms, req_plain_ms = time_pair(
        "K1 f32 rectangular n1=64 (one 'fast' request)",
        raw_gram(lib, x64, xs32, ls32, amp32, nug32, False), p_req,
        q * 64 * n * 4)
    req_bound, req_by = say_bound(
        "K1 f32 request", req_ms,
        q * 64 * n * 4 + ((64 + n) * d + ls.numel() + 2 * q) * 4,
        q * entries(64, n, False) * k1_ops_per_entry(d, False),
        F32_INSTR_PER_S)

    # the 'fast' operating point: B^-1 of the f32 factor, w = B^-1 a in f32
    B = gram_factor_target(m.x, ls, amp, nug, row_scale=D, diag_vec=dv,
                           compute_dtype=f32)
    L = linalg.cholesky(B)
    del B
    w_fast = linalg.cho_solve_vec(L, a.to(f32)).contiguous()
    M_fast = linalg.chol_inverse(L)
    del L
    # the 'mixed' one: the f32 potri seed of the refined factor of the f64
    # target, and w refined in f64, cast to f32
    B = gram_factor_target(m.x, ls, amp, nug, row_scale=D,
                           diag_vec=torch.ones((q, n), dtype=f64, device=dev))
    L = mixed.cholesky_mixed(B, refine_steps=2, seed_jitter=1e-6)
    w_mixed = mixed.cho_solve_vec_refined(L, B, a).to(f32).contiguous()
    del B
    M_mixed = mixed.chol_inverse_from_factor_mixed(L.to(f32), newton_steps=0)
    del L
    torch.cuda.empty_cache()
    alpha32 = (0.5 * D).to(f32)
    times = bounds = None
    for label, M, w in (("'fast'", M_fast, w_fast),
                        ("'mixed'", M_mixed, w_mixed)):
        def p_vjp(M=M, w=w):
            return matern32_gram_vjp_fused_plain(xs32, ls32, amp32, nug32,
                                                 M=M, alpha=alpha32,
                                                 beta=-0.5, w=w)
        got = launch_matern32_vjp(xs32, xs32, ls32, amp32, nug32, same=True,
                                  M=M, alpha=alpha32, beta=-0.5, w=w)
        ref = p_vjp()
        scale = matern32_gram_vjp_scale(
            m.x, m.x, ls, amp, nug, same=True,
            cbar=fused_cotangent(M.double(), alpha32.double(), -0.5,
                                 w.double()))
        torch.cuda.synchronize()
        k2_errs.append(compare_vjp(
            f"K2 f32 fused at the {label} operating point (q={q}, n={n}, "
            f"d={d}) vs plain f32", got, ref, scale,
            vjp_bound=VJP_BOUND_F32))
        del got, ref, scale
        torch.cuda.empty_cache()
        if times is None:
            times = time_pair(f"K2 f32 fused ('fast' loss gradient, q={q} "
                              f"n={n})",
                              raw_vjp(lib, xs32, ls32, amp32, nug32, M,
                                      alpha32, -0.5, w), p_vjp,
                              M.numel() * 4, "read")
            bounds = say_bound(
                "K2 f32 fused", times[0],
                (M.numel() + w.numel() + xs32.numel() + 5 * q + ls.numel()
                 + q * (d + 2)) * 4,
                q * entries(n, n, True) * k2_ops_per_entry(d),
                F32_INSTR_PER_S)
    del m, M_fast, M_mixed
    torch.cuda.empty_cache()
    rec_k1 = dict(name="matern32_gram_f32", route="cuda", source=K1_SOURCE,
                  replaces=K1_REPLACES, max_abs_err=max(k1_errs), ms=k_ms,
                  plain_ms=p_ms, bound_ms=b_ms, bound_by=b_by,
                  library_ms=None,
                  shape=f"square+epilogue f32 q={q} n={n} d={d}",
                  request_ms=req_ms, request_plain_ms=req_plain_ms,
                  request_bound_ms=req_bound, request_bound_by=req_by)
    rec_k2 = dict(name="matern32_gram_vjp_f32", route="cuda",
                  source=K2_SOURCE, replaces=K2_REPLACES,
                  max_abs_err=max(k2_errs), ms=times[0], plain_ms=times[1],
                  bound_ms=bounds[0], bound_by=bounds[1], library_ms=None,
                  shape=f"fused loss cotangent f32 q={q} n={n} d={d}")
    return rec_k1, rec_k2


def timed_s(fn):
    """Host-clock seconds of fn(), ending in a synchronize."""
    import torch
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0


def mode_timings(m, xte, reps=5, requests=20):
    """Warm medians of loss(), one loss+grad evaluation (host value and
    gradient, as the fits see it), the aux and a 64-point request."""
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    m.loss()                                     # warm, and the ratchet
    flat = Flattener(m.free)
    vg = value_and_grad(m._loss_fn(), flat)
    z = flat.ravel(m.free).cpu().numpy()
    vg(z)
    m.compute_aux_predictive_quantities()
    m.predict(xte[:64], batch_size=64)
    out = {"loss": statistics.median(timed_s(m.loss) for _ in range(reps)),
           "loss_grad": statistics.median(timed_s(lambda: vg(z))
                                          for _ in range(reps)),
           "aux": statistics.median(
               timed_s(m.compute_aux_predictive_quantities)
               for _ in range(reps))}
    req = sorted(timed_s(lambda s=s: m.predict(xte[s:s + 64], batch_size=64))
                 for s in [64 * (r % 4) for r in range(requests)])
    out["request_ms"] = statistics.median(req) * 1e3
    out["request_p90_ms"] = req[int(0.9 * (requests - 1))] * 1e3
    return out, (lambda: vg(z))


def phase_precision(dev, x, y, xte, ytrue, free_np, rmse_f64):
    """Phase 9, parts 2-6: the precision modes at config 4.  'mixed' at the
    committed f64 fit (the ratchet, the loss rtol 1e-9 of 'high', refined
    predictions within 1e-7 of each output's largest entry, one K2 f32
    launch per loss+grad evaluation); 'mixed' at the init (the gradient
    within 5e-4 of each leaf's max |g| of 'high's, f32-grade by design);
    'fast' from the init (one loss+grad evaluation timed,
    fit(method='auto', maxiter=FAST_MAXITER) resolving to 'lbfgs-jax' with
    K1 and K2 f32 launches equal to nfev, the aux and 20 requests, peak
    memory and the held-out RMSE); precision='auto' at n=4096; and the
    three modes timed side by side with a profile of a 'mixed' and a
    'fast' loss+grad evaluation.  Returns the f32 (K1, K2) launches of the
    main path (parts 2-4) and the f32 launches per call."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.fit import DeviceFitResult
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    from lcgp_tpu_torch.ops.matern import matern32_gram, matern32_gram_vjp
    from lcgp_tpu_torch.ops.mixed import parse_refine

    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reset_counts()
    say("  -- 'mixed' at the committed f64 fit (amplitudes at 1e4)")
    hi = LCGP(y, x, q=20, device=dev)
    mx = LCGP(y, x, q=20, precision="mixed", device=dev)
    hi.free = free_params_from_numpy(*free_np, dev)
    mx.free = free_params_from_numpy(*free_np, dev)
    rec = mx.recommended_refine_steps()
    loss_hi = float(hi.loss())
    t_mx = timed_s(mx.loss)
    loss_mx = float(mx.loss())
    steps = parse_refine(mx._compute_dtype)
    rel = abs(loss_mx - loss_hi) / abs(loss_hi)
    say(f"  recommended_refine_steps() = {rec}; loss() ratcheted to {steps} "
        f"steps ({mx._compute_dtype!r}; first call {t_mx:.3f} s)")
    say(f"  loss: 'mixed' {loss_mx!r} vs 'high' {loss_hi!r}: rel {rel:.3e} "
        "(bound 1e-9)")
    check(steps == max(rec, 2), "the loss() ratchet did not reach the "
          "recommended refinement")
    check(rel <= 1e-9, "the 'mixed' loss differs from 'high' beyond 1e-9")
    for name, a, b in zip(("ypred", "ypredvar", "yconfvar"),
                          mx.predict(xte, batch_size=64),
                          hi.predict(xte, batch_size=64)):
        compare_normwise(f"'mixed' {name} (refined aux) vs 'high'", a, b,
                         1e-7)
    flat = Flattener(mx.free)
    vg_mx = value_and_grad(mx._loss_fn(), flat)
    z_fit = flat.ravel(mx.free).cpu().numpy()
    k_all = launches_of(lambda: vg_mx(z_fit))
    k_f32 = f32_counts()
    vg_mx(z_fit)
    k_f32 = tuple(b - a for a, b in zip(k_f32, f32_counts()))
    say(f"  one 'mixed' loss+grad evaluation at the fit: (K1, K2) launches "
        f"{k_all}, of them f32 {k_f32}")
    check(k_all == (1, 1) and k_f32 == (0, 1), "a 'mixed' loss+grad "
          "evaluation should launch K1 f64 once and K2 f32 once")
    del hi, mx, vg_mx
    torch.cuda.empty_cache()

    say("  -- 'mixed' at the data-driven init: its gradient against 'high's")
    hi0 = LCGP(y, x, q=20, device=dev)
    mi0 = LCGP(y, x, q=20, precision="mixed", device=dev)
    mi0.loss()
    flat = Flattener(hi0.free)
    z0 = flat.ravel(hi0.free).cpu().numpy()
    v_h, g_h = value_and_grad(hi0._loss_fn(), flat)(z0)
    v_m, g_m = value_and_grad(mi0._loss_fn(), flat)(z0)
    say(f"  loss 'mixed' {v_m!r} vs 'high' {v_h!r}: rel "
        f"{abs(v_m - v_h) / abs(v_h):.3e} ({mi0._compute_dtype!r})")
    check(abs(v_m - v_h) <= 1e-9 * abs(v_h), "'mixed' loss at the init "
          "differs from 'high' beyond 1e-9")
    start = 0
    for name, size in zip(("lLmb", "lLmb0", "lsigma2s", "lnugGPs"),
                          flat.sizes):
        ga, gb = g_m[start:start + size], g_h[start:start + size]
        start += size
        err, top = float(np.max(np.abs(ga - gb))), float(np.max(np.abs(gb)))
        say(f"  'mixed' gradient {name}: max_abs_err={err:.3e} vs 'high' "
            f"(max |g| {top:.3e}, rel {err / top:.3e}; bound 5e-4)")
        check(err <= 5e-4 * top, f"'mixed' gradient {name} differs from "
              "'high' beyond 5e-4 of its max |g|")
    del g_h, g_m
    torch.cuda.empty_cache()

    say(f"  -- 'fast' from the init: fit(method='auto', "
        f"maxiter={FAST_MAXITER}), aux and requests")
    fm = LCGP(y, x, q=20, precision="fast", device=dev)
    say(f"  LCGP(precision='fast'): q_chunk={fm.q_chunk}, jitter "
        f"{fm._jitter:g}")
    flat = Flattener(fm.free)
    vg_f = value_and_grad(fm._loss_fn(), flat)
    zf = flat.ravel(fm.free).cpu().numpy()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    first = timed_s(lambda: vg_f(zf))
    warm = [timed_s(lambda: vg_f(zf)) for _ in range(5)]
    before = f32_counts()
    per_eval = launches_of(lambda: vg_f(zf))
    per_eval_f32 = tuple(b - a for a, b in zip(before, f32_counts()))
    say(f"  'fast' loss+grad evaluation: first {first:.4f} s, warm median "
        f"{statistics.median(warm):.4f} s of 5; (K1, K2) launches "
        f"{per_eval}, f32 {per_eval_f32}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    check(per_eval == per_eval_f32 == (1, 1), "a 'fast' loss+grad "
          "evaluation should launch K1 f32 and K2 f32 once each")
    l_init = float(fm.loss())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    k1_0, k2_0 = f32_counts()
    a1, a2 = matern32_gram.launches, matern32_gram_vjp.launches
    t0 = time.perf_counter()
    fm.fit(method="auto", maxiter=FAST_MAXITER)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    res = fm._fit_result
    k1_fit = matern32_gram.launches - a1
    k2_fit = matern32_gram_vjp.launches - a2
    k1_fit32, k2_fit32 = (f - b for f, b in zip(f32_counts(), (k1_0, k2_0)))
    say(f"  fit(method='auto', maxiter={FAST_MAXITER}) ran "
        f"{type(res).__name__} (lbfgs-jax): stop_reason={res.stop_reason!r} "
        f"nit={res.nit} nfev={res.nfev} in {fit_s:.3f} s "
        f"({fit_s / max(res.nfev, 1):.4f} s per evaluation, "
        f"{fit_s / max(res.nit, 1):.4f} s per iteration); loss "
        f"{l_init:.10g} -> {res.fun:.10g}; peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    say(f"  K1 launches in the fit: {k1_fit} (f32 {k1_fit32}); K2: {k2_fit} "
        f"(f32 {k2_fit32}); nfev {res.nfev}")
    check(isinstance(res, DeviceFitResult) and res.nfev > 0,
          "fit(method='auto') under 'fast' at n=4096 did not run lbfgs-jax")
    check((k1_fit, k2_fit, k1_fit32, k2_fit32) == (res.nfev,) * 4,
          "the 'fast' fit should launch K1 f32 and K2 f32 once per "
          "evaluation")
    check(np.isfinite(res.fun) and res.fun < l_init,
          "the 'fast' fit did not lower the loss")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aux_s = timed_s(fm.compute_aux_predictive_quantities)
    outs, req_s = [], []
    for r in range(20):
        s0 = 64 * (r % 4)
        req_s.append(timed_s(lambda: outs.append(
            fm.predict(xte[s0:s0 + 64], batch_size=64))))
    say(f"  'fast' aux {aux_s:.4f} s; 20 predict(batch_size=64) requests: "
        f"median {statistics.median(req_s) * 1e3:.2f} ms; serving peak "
        f"{torch.cuda.max_memory_allocated() / 1e9:.3f} GB")
    ypred, ypredvar, yconfvar = (torch.cat([o[i] for o in outs[:4]], dim=1)
                                 for i in range(3))
    for name, t in (("ypred", ypred), ("ypredvar", ypredvar),
                    ("yconfvar", yconfvar)):
        check(bool(torch.isfinite(t).all()), f"'fast' {name} not finite")
    check(tuple(ypred.shape) == ytrue.shape, f"ypred {tuple(ypred.shape)}")
    check(bool((ypredvar > 0).all()), "'fast' predvar not positive")
    rmse = float(np.sqrt(np.mean((ypred.cpu().numpy() - ytrue) ** 2)))
    say(f"  held-out RMSE after the {FAST_MAXITER}-iteration 'fast' fit: "
        f"{rmse:.6f} (phase 6's 20-iteration f64 scipy fit: "
        f"{rmse_f64:.6f})")
    f32_main = f32_counts()
    say(f"  f32 launches on phase 9's main path ('mixed' at the fit and the "
        f"init, the 'fast' evaluations, fit and serving): K1 {f32_main[0]}, "
        f"K2 {f32_main[1]}")
    per_call = {"fast_loss_grad": per_eval_f32, "mixed_loss_grad": k_f32,
                "fast_request": launches_of(
                    lambda: fm.predict(xte[:64], batch_size=64))}
    del fm, vg_f, outs
    torch.cuda.empty_cache()

    say("  -- precision='auto' at n=4096")
    am = LCGP(y, x, q=20, precision="auto", device=dev)
    say(f"  precision='auto' -> {am.precision!r} (n={am.n}, "
        f"_AUTO_MIXED_N={LCGP._AUTO_MIXED_N})")
    check(am.precision == "mixed", "precision='auto' did not resolve to "
          "'mixed' at n=4096")
    del am

    say("  -- the three modes side by side at the data-driven init "
        "(warm medians)")
    table, evals = {}, {}
    for mode, m in (("high", hi0), ("mixed", mi0),
                    ("fast", LCGP(y, x, q=20, precision="fast",
                                  device=dev))):
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        table[mode], evals[mode] = mode_timings(m, xte)
        table[mode]["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
        m._aux = None
    say("  mode   loss s   loss+grad s   aux s   request ms (p90)   peak GB")
    for mode, t in table.items():
        say(f"  {mode:6s} {t['loss']:.4f}   {t['loss_grad']:.4f}        "
            f"{t['aux']:.4f}  {t['request_ms']:.2f} "
            f"({t['request_p90_ms']:.2f})      {t['peak_gb']:.3f}")
    for mode in ("mixed", "fast"):
        say(f"  {mode} / high: loss "
            f"{table[mode]['loss'] / table['high']['loss']:.3f}x, loss+grad "
            f"{table[mode]['loss_grad'] / table['high']['loss_grad']:.3f}x, "
            f"aux {table[mode]['aux'] / table['high']['aux']:.3f}x")
    say(f"  timings JSON: {json.dumps(table)}")
    profile_device("one 'mixed' loss+grad evaluation", evals["mixed"], 10)
    profile_device("one 'fast' loss+grad evaluation", evals["fast"], 10)
    return f32_main, per_call


def registers_of(registers, kernel, policy, dtype=None):
    """ptxas's registers of one kernel template's instantiations for one
    policy (and dtype, 'double' or 'float')."""
    return {k: v for k, v in registers.items()
            if k.startswith(kernel + "<") and k.endswith(f", {policy}>")
            and (dtype is None or k.startswith(f"{kernel}<{dtype}"))}


def kind_record(kind, vjp, f32, errs, times, bounds, library_ms, shape):
    """A row of the kernels JSON line for phase 10's kernels."""
    name = f"{kind}_gram" + ("_vjp" if vjp else "")
    return dict(name=name + ("_f32" if f32 else ""), route="cuda",
                source=f"lcgp_tpu_torch/csrc/{name}.cu",
                replaces=REPLACES[kind][int(vjp)], max_abs_err=max(errs),
                ms=times[0], plain_ms=times[1], bound_ms=bounds[0],
                bound_by=bounds[1], library_ms=library_ms, shape=shape)


def gemm_form_gram(x, ls, amp, nug, row_scale, diag_vec):
    """The squared-exponential factor target by the GEMM form, with the
    fewest PyTorch calls: one baddbmm for |u|^2 + |v|^2 - 2 u.v, then the
    clamp, exp and epilogue in place.  What the JAX package runs, timed
    beside K4 as its library yardstick; the port never calls it."""
    import torch
    u = x[None] / ls[:, None, :]                               # (q, n, d)
    sq = (u * u).sum(-1)
    B = torch.baddbmm(sq[:, :, None] + sq[:, None, :], u, u.mT, alpha=-2.0)
    B.clamp_(min=0.0).mul_(-0.5).exp_()
    eta = nug / (1.0 + nug)
    B.mul_((row_scale * amp * (1.0 - eta))[:, None, None])
    B.diagonal(dim1=-2, dim2=-1).add_(
        (row_scale * amp * eta)[:, None] + diag_vec)
    return B


def phase_kind_kernels(dev, kind, x, y, xte):
    """Phase 10, part 1: the kind's Gram kernel (K3 or K4) and its VJP
    against their plain versions on the card at config 4, f64 and f32,
    timed in turns with their bounds.  The Gram: square with the loss's
    epilogue (and C0) and with the rep epilogue, exactly symmetric; the
    request shape (20, 64, 4096); one ragged shape.  The VJP: the fused
    cotangent at a real B^-1 and w (two launches bit for bit equal), a
    random non-symmetric cotangent, and f32 at the 'fast' operating point.
    Returns the four kernel records (Gram, VJP, Gram f32, VJP f32)."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.gram import gram_factor_target
    from lcgp_tpu_torch.ops.launch import fused_cotangent
    lib = build().lib
    fn = family_of(kind)
    label = fn.label
    gram_ops, vjp_ops = OPS_PER_ENTRY[kind]
    f64, f32 = torch.float64, torch.float32
    m = LCGP(y, x, q=20, kernel=kind, device=dev)
    xs, q, n, d = m.x, int(m.q), m.n, m.d
    x0s = m._standardize_x0(xte)
    rng = np.random.default_rng(12)
    ls, amp, nug = moderate_params(rng, q, d, dev, f64)
    D = m._data.diag_D
    dv = torch.full((q, n), 1.0 + m._jitter, dtype=f64, device=dev)
    errs, errs32, verrs, verrs32 = [], [], [], []

    def cast(dt, *ts):
        return [t.to(dt).contiguous() for t in ts]

    def k_sq(dt=f64, want_c0=False):
        return fn.launch(*cast(dt, xs, xs, ls, amp, nug), same=True,
                         want_c0=want_c0, row_scale=D.to(dt),
                         diag_vec=dv.to(dt))

    def p_sq(dt=f64):
        xx, l_, a_, g_, D_, dv_ = cast(dt, xs, ls, amp, nug, D, dv)
        C, c0 = fn.plain(xx, xx, l_, a_, g_, same=True, want_c0=True)
        return linalg.add_diag(D_[:, None, None] * C, dv_), c0

    (B_k, c0_k), (B_p, c0_p) = k_sq(f64, True), p_sq()
    torch.cuda.synchronize()
    errs.append(compare(f"{label} f64 square, the loss's epilogue (row scale "
                        f"D, diagonal 1 + jitter; q={q}, n={n}, d={d}) B",
                        B_k, B_p, F64_RTOL, F64_ATOL))
    errs.append(compare(f"{label} f64 square C0", c0_k, c0_p, F64_RTOL,
                        F64_ATOL))
    check(bool((torch.diagonal(c0_k, dim1=-2, dim2=-1) == 1.0).all()),
          f"{label}'s C0 diagonal is not exactly 1")
    check(torch.equal(B_k, B_k.mT) and torch.equal(c0_k, c0_k.mT),
          f"{label}'s same-point B or C0 is not exactly symmetric")
    say(f"  {label} f64 square B and C0 exactly symmetric, C0 diagonal "
        "exactly 1: True")
    del B_k, c0_k, c0_p
    B32 = k_sq(f32)[0]
    torch.cuda.synchronize()
    errs32.append(compare(f"{label} f32 square, the loss's epilogue, vs f64 "
                          "plain", B32, B_p, F32_RTOL, F32_ATOL))
    check(torch.equal(B32, B32.mT), f"{label} f32 B is not exactly symmetric")
    del B32, B_p
    # the rep path's factor target: row scale 1, diagonal 1/(D_k r_i)
    r = torch.as_tensor(rng.integers(1, 11, n), dtype=f64, device=dev)
    rep_dv = (1.0 / (D[:, None] * r[None, :])).contiguous()
    A_k = fn.launch(xs, xs, ls, amp, nug, same=True,
                    row_scale=torch.ones_like(D), diag_vec=rep_dv)[0]
    A_p = linalg.add_diag(fn.plain(xs, xs, ls, amp, nug, same=True), rep_dv)
    torch.cuda.synchronize()
    errs.append(compare(f"{label} f64 square, the rep epilogue (row scale 1, "
                        f"diagonal 1/(D r), r 1-10)", A_k, A_p, F64_RTOL,
                        F64_ATOL))
    check(torch.equal(A_k, A_k.mT), f"{label}'s rep factor target is not "
          "exactly symmetric")
    say(f"  {label} f64 square, rep epilogue, exactly symmetric: True")
    del A_k, A_p
    torch.cuda.empty_cache()
    # the request's cross-covariance, f64 and f32, and a ragged shape
    x64 = x0s[:64].contiguous()
    R_p = fn.plain(x64, xs, ls, amp, nug, same=False)
    errs.append(compare(f"{label} f64 rectangular, one request (q={q}, "
                        f"n1=64, n2={n})",
                        fn.launch(x64, xs, ls, amp, nug, same=False)[0], R_p,
                        F64_RTOL, F64_ATOL))
    errs32.append(compare(f"{label} f32 rectangular, one request, vs f64 "
                          "plain",
                          fn.launch(*cast(f32, x64, xs, ls, amp, nug),
                                    same=False)[0], R_p, F32_RTOL, F32_ATOL))
    rr = np.random.default_rng(2)
    xa = torch.as_tensor(rr.uniform(0, 1, (1000, 3)), dtype=f64, device=dev)
    xb = torch.as_tensor(rr.uniform(0, 1, (37, 3)), dtype=f64, device=dev)
    l3, a3, n3 = moderate_params(rr, 3, 3, dev, f64)
    errs.append(compare(f"{label} f64 ragged (q=3, n1=1000, n2=37, d=3)",
                        fn.launch(xa, xb, l3, a3, n3, same=False)[0],
                        fn.plain(xa, xb, l3, a3, n3, same=False),
                        F64_RTOL, F64_ATOL))

    # times and bounds, the kernel through its C entry
    stack = q * n * n * 8
    inputs = (xs.numel() + ls.numel() + 3 * q + dv.numel()) * 8
    times = time_pair(f"{label} f64 square+epilogue (loss, q={q} n={n})",
                      raw_gram(lib, xs, xs, ls, amp, nug, True, D, dv,
                               family=kind),
                      lambda: p_sq(), stack, plain_reps=3)
    bounds = say_bound(f"{label} square+epilogue", times[0], stack + inputs,
                       q * entries(n, n, True) * gram_ops(d, True))
    library_ms = None
    if kind == "rbf":
        library_ms = cuda_ms(lambda: gemm_form_gram(xs, ls, amp, nug, D, dv),
                             reps=3)
        say(f"  time the GEMM-form composition (baddbmm, in-place clamp, exp "
            f"and epilogue; the JAX package's form, no single library call): "
            f"{library_ms:.4f} ms")
    req = time_pair(f"{label} f64 rectangular n1=64 (one request)",
                    raw_gram(lib, x64, xs, ls, amp, nug, False, family=kind),
                    lambda: fn.plain(x64, xs, ls, amp, nug, same=False),
                    q * 64 * n * 8)
    req_bounds = say_bound(
        f"{label} request", req[0],
        q * 64 * n * 8 + ((64 + n) * d + ls.numel() + 2 * q) * 8,
        q * entries(64, n, False) * gram_ops(d, False))
    xs32, ls32, amp32, nug32, D32, dv32 = cast(f32, xs, ls, amp, nug, D, dv)
    times32 = time_pair(f"{label} f32 square+epilogue (q={q} n={n})",
                        raw_gram(lib, xs32, xs32, ls32, amp32, nug32, True,
                                 D32, dv32, family=kind),
                        lambda: p_sq(f32), stack // 2, plain_reps=3)
    bounds32 = say_bound(f"{label} f32 square+epilogue", times32[0],
                         (stack + inputs) // 2,
                         q * entries(n, n, True) * gram_ops(d, True),
                         F32_INSTR_PER_S)
    torch.cuda.empty_cache()

    # the VJP at the loss gradient's operating point: B^-1 and w at the
    # model's data-driven init
    ls0, amp0, nug0, D0, a0 = loss_operands(m, m.free)
    Binv, w = fused_operands(m, ls0, amp0, nug0, D0, a0)
    alpha = 0.5 * D0

    def k_fused():
        return fn.launch_vjp(xs, xs, ls0, amp0, nug0, same=True, M=Binv,
                             alpha=alpha, beta=-0.5, w=w)

    def p_fused():
        return fn.fused_plain(xs, ls0, amp0, nug0, M=Binv, alpha=alpha,
                              beta=-0.5, w=w)
    got, again, ref = k_fused(), k_fused(), p_fused()
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          f"{label} VJP fused: two launches on the same inputs differ")
    say(f"  {label} VJP fused at the init: two launches give the same bits")
    scale = fn.scale(xs, xs, ls0, amp0, nug0, same=True,
                     cbar=fused_cotangent(Binv, alpha, -0.5, w))
    verrs.append(compare_vjp(
        f"{label} VJP fused f64 (q={q}, n={n}, d={d}), B^-1 and w at the "
        f"init (min lengthscale {float(ls0.min()):.3e})", got, ref, scale,
        lambda k: vjp_extended(xs, ls0, amp0, nug0, k, Binv, alpha, -0.5, w,
                               kind=kind), kernel=label))
    del got, again, ref, scale
    torch.cuda.empty_cache()
    vtimes = time_pair(f"{label} VJP fused f64 (loss gradient, q={q} n={n})",
                       raw_vjp(lib, xs, ls0, amp0, nug0, Binv, alpha, -0.5, w,
                               family=kind),
                       p_fused, Binv.numel() * 8, "read", plain_reps=3)
    vbounds = say_bound(
        f"{label} VJP fused", vtimes[0],
        (Binv.numel() + w.numel() + xs.numel() + 5 * q + ls.numel()
         + q * (d + 2)) * 8,
        q * entries(n, n, True) * vjp_ops(d))
    del Binv
    torch.cuda.empty_cache()
    # a random non-symmetric cotangent pins the pairing of the triangles
    gen = torch.Generator(device=dev).manual_seed(4)
    cbar = torch.randn((q, n, n), generator=gen, dtype=f64, device=dev)
    got = fn.launch_vjp(xs, xs, ls, amp, nug, same=True, M=cbar)
    ref = fn.vjp_plain(xs, xs, ls, amp, nug, same=True, cbar=cbar)
    scale = fn.scale(xs, xs, ls, amp, nug, same=True, cbar=cbar)
    torch.cuda.synchronize()
    verrs.append(compare_vjp(
        f"{label} VJP generic f64, random non-symmetric cotangent, moderate "
        "lengthscales", got, ref, scale,
        lambda k: vjp_extended(xs, ls, amp, nug, k, cbar, None, 0.0, None,
                               kind=kind), kernel=label))
    del cbar, got, ref, scale
    torch.cuda.empty_cache()
    # f32 at the 'fast' operating point: B^-1 of the f32 factor and w in f32,
    # against the f64 plain VJP at the same operands
    L = linalg.cholesky(gram_factor_target(xs, ls0, amp0, nug0, row_scale=D0,
                                           diag_vec=dv, compute_dtype=f32,
                                           kind=kind))
    w32 = linalg.cho_solve_vec(L, a0.to(f32)).contiguous()
    M32 = linalg.chol_inverse(L)
    del L
    al32 = alpha.to(f32)
    xs32, l032, a032, n032 = cast(f32, xs, ls0, amp0, nug0)
    got = fn.launch_vjp(xs32, xs32, l032, a032, n032, same=True, M=M32,
                        alpha=al32, beta=-0.5, w=w32)
    ref = fn.fused_plain(xs, ls0, amp0, nug0, M=M32.double(),
                         alpha=al32.double(), beta=-0.5, w=w32.double())
    scale = fn.scale(xs, xs, ls0, amp0, nug0, same=True,
                     cbar=fused_cotangent(M32.double(), al32.double(), -0.5,
                                          w32.double()))
    torch.cuda.synchronize()
    verrs32.append(compare_vjp(
        f"{label} VJP f32 fused at the 'fast' operating point vs f64 plain",
        got, ref, scale, vjp_bound=VJP_BOUND_F32, kernel=label))
    del got, ref, scale
    torch.cuda.empty_cache()
    vtimes32 = time_pair(
        f"{label} VJP f32 fused ('fast' loss gradient, q={q} n={n})",
        raw_vjp(lib, xs32, l032, a032, n032, M32, al32, -0.5, w32,
                family=kind),
        lambda: fn.fused_plain(xs32, l032, a032, n032, M=M32, alpha=al32,
                               beta=-0.5, w=w32),
        M32.numel() * 4, "read", plain_reps=3)
    vbounds32 = say_bound(
        f"{label} VJP f32 fused", vtimes32[0],
        (M32.numel() + w32.numel() + xs.numel() + 5 * q + ls.numel()
         + q * (d + 2)) * 4,
        q * entries(n, n, True) * vjp_ops(d), F32_INSTR_PER_S)
    del m, M32
    torch.cuda.empty_cache()
    sq = f"q={q} n={n} d={d}"
    rec = kind_record(kind, False, False, errs, times, bounds, library_ms,
                      f"square+epilogue f64 {sq}")
    rec.update(request_ms=req[0], request_plain_ms=req[1],
               request_bound_ms=req_bounds[0], request_bound_by=req_bounds[1])
    return (rec,
            kind_record(kind, True, False, verrs, vtimes, vbounds, None,
                        f"fused loss cotangent f64 {sq}"),
            kind_record(kind, False, True, errs32, times32, bounds32, None,
                        f"square+epilogue f32 {sq}"),
            kind_record(kind, True, True, verrs32, vtimes32, vbounds32, None,
                        f"fused loss cotangent f32 {sq}"))


def phase_kind_model(dev, kind, x, y, xte, ytrue):
    """Phase 10, part 2: the model with ``kernel=kind`` at config 4, f64,
    from its data-driven init: one loss+grad evaluation timed and checked
    against the plain kernels' gradient and central differences,
    ``fit(method='scipy', maxiter=KIND_MAXITER)`` with the Gram and VJP
    kernels launched once each per evaluation, the aux, 20
    ``predict(batch_size=64)`` requests and one ``return_fullcov`` request,
    peak memory and the held-out RMSE.  Returns the (Gram, VJP) launches of
    one loss+grad evaluation and a dict of timings."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    fn = family_of(kind)
    label = fn.label
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    m = LCGP(y, x, q=20, kernel=kind, device=dev)
    loss_fn = m._loss_fn()
    flat = Flattener(m.free)
    vg = value_and_grad(loss_fn, flat)
    z0 = flat.ravel(m.free).cpu().numpy()
    t0 = time.perf_counter()
    v0, g0 = vg(z0)
    first = time.perf_counter() - t0
    warm = [timed_s(lambda: vg(z0)) for _ in range(5)]
    per_eval = launches_of(lambda: vg(z0), kind)
    say(f"  {kind} loss+grad evaluation: first {first:.4f} s, warm median "
        f"{statistics.median(warm):.4f} s of 5 ("
        + ", ".join(f"{t:.4f}" for t in warm) + f"); ({label}, {label} VJP) "
        f"launches {per_eval}")
    check(per_eval == (1, 1), f"a {kind} loss+grad evaluation launched "
          f"{per_eval}, expected (1, 1)")
    check(np.isfinite(v0) and bool(np.isfinite(g0).all()),
          f"{kind} loss+grad at the init not finite")
    k1, k2 = fn.gram.launches, fn.vjp.launches
    with plain_kernels():
        vp, gp = vg(z0)
    check((fn.gram.launches, fn.vjp.launches) == (k1, k2),
          "the plain reference launched a kernel")
    loss_rel = abs(v0 - vp) / abs(vp)
    say(f"  loss {v0:.12e} vs plain kernels {vp:.12e}: rel {loss_rel:.3e}")
    check(loss_rel <= 1e-10, f"{kind} loss differs from the plain kernels'")
    start = 0
    for name, size in zip(("lLmb", "lLmb0", "lsigma2s", "lnugGPs"),
                          flat.sizes):
        a, b = g0[start:start + size], gp[start:start + size]
        start += size
        err, top = float(np.max(np.abs(a - b))), float(np.max(np.abs(b)))
        say(f"  gradient {name}: max_abs_err={err:.3e} vs the plain kernels "
            f"(max |g| {top:.3e}, rel {err / top:.3e})")
        check(err <= GRAD_RTOL * top, f"{kind} gradient {name} differs from "
              f"the plain kernels' beyond {GRAD_RTOL:g} of its max |g|")
    del vp, gp
    torch.cuda.empty_cache()

    def f(z):
        with torch.no_grad():
            return float(loss_fn(flat.unravel_host(z)))
    directional_check(f"{kind} gradient vs central differences", f, z0, g0,
                      ndir=2, rtol=1e-5, seed=13, h=1e-3)

    l_init = float(m.loss())
    k1, k2 = fn.gram.launches, fn.vjp.launches
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    fit_s = timed_s(lambda: m.fit(method="scipy", maxiter=KIND_MAXITER))
    res = m._fit_result
    k1_fit, k2_fit = fn.gram.launches - k1, fn.vjp.launches - k2
    say(f"  fit(method='scipy', maxiter={KIND_MAXITER}): stop_reason="
        f"{res.stop_reason!r} nit={res.nit} nfev={res.nfev} in {fit_s:.3f} s "
        f"({fit_s / res.nfev:.4f} s per evaluation); loss {l_init:.10g} -> "
        f"{res.fun:.10g}; {label} launches {k1_fit}, {label} VJP {k2_fit}")
    check((k1_fit, k2_fit) == (res.nfev, res.nfev), f"the {kind} fit "
          f"launched {label} {k1_fit} and its VJP {k2_fit} times in "
          f"{res.nfev} evaluations")
    check(np.isfinite(res.fun) and res.fun < l_init,
          f"the {kind} fit did not lower the loss")
    train_peak = torch.cuda.max_memory_allocated() / 1e9

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    aux_s = timed_s(m.compute_aux_predictive_quantities)
    outs, req_s = [], []
    for r in range(20):
        s0 = 64 * (r % 4)
        req_s.append(timed_s(lambda: outs.append(
            m.predict(xte[s0:s0 + 64], batch_size=64))))
    req_s.sort()
    fc_s = timed_s(lambda: outs.append(m.predict(xte[:8],
                                                 return_fullcov=True)))
    fc = outs.pop()
    serve_peak = torch.cuda.max_memory_allocated() / 1e9
    ypred, ypredvar, yconfvar = (torch.cat([o[i] for o in outs[:4]], dim=1)
                                 for i in range(3))
    for name, a in (("ypred", ypred), ("ypredvar", ypredvar),
                    ("yconfvar", yconfvar), ("fullcov", fc[3])):
        check(bool(torch.isfinite(a).all()), f"{kind}: {name} not finite")
    check(tuple(ypred.shape) == ytrue.shape, f"ypred {tuple(ypred.shape)}")
    check(bool((ypredvar > 0).all()), f"{kind}: predvar not positive")
    check(bool(torch.allclose(torch.diagonal(fc[3], dim1=-2, dim2=-1).T,
                              fc[1], rtol=1e-10, atol=0)),
          f"{kind}: diag(fullcov) != predvar")
    rmse = float(np.sqrt(np.mean((ypred.cpu().numpy() - ytrue) ** 2)))
    out = {"loss_grad_s": statistics.median(warm), "aux_s": aux_s,
           "request_ms": statistics.median(req_s) * 1e3,
           "request_p90_ms": req_s[int(0.9 * (len(req_s) - 1))] * 1e3,
           "fullcov_s": fc_s, "fit_s_per_eval": fit_s / res.nfev,
           "nfev": res.nfev, "train_peak_gb": train_peak,
           "serve_peak_gb": serve_peak, "rmse": rmse}
    say(f"  {kind} aux {aux_s:.4f} s; 20 predict(batch_size=64) requests: "
        f"median {out['request_ms']:.2f} ms, p90 {out['request_p90_ms']:.2f} "
        f"ms; predict(8 points, return_fullcov=True) {fc_s:.4f} s; peak "
        f"{train_peak:.3f} GB over the fit, {serve_peak:.3f} GB serving "
        "(model included); "
        f"held-out RMSE after the {KIND_MAXITER}-iteration fit {rmse:.6f}")
    del m, vg, outs, fc
    torch.cuda.empty_cache()
    return per_eval, out


def phase_kind_precision(dev, kind, x, y):
    """Phase 10, part 3: the f32 instantiations on a path, one 'fast'
    loss+grad evaluation timed with its f32 launches, and one 'mixed' loss
    at the init against 'high''s within rtol 1e-9.  Returns the f32
    (Gram, VJP) launches of the 'fast' evaluation and its time."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    fm = LCGP(y, x, q=20, kernel=kind, precision="fast", device=dev)
    flat = Flattener(fm.free)
    vg = value_and_grad(fm._loss_fn(), flat)
    z = flat.ravel(fm.free).cpu().numpy()
    first = timed_s(lambda: vg(z))
    warm = statistics.median(timed_s(lambda: vg(z)) for _ in range(5))
    before = f32_counts(kind)
    v, g = vg(z)
    per_eval32 = tuple(b - a for a, b in zip(before, f32_counts(kind)))
    say(f"  {kind} 'fast' loss+grad evaluation: first {first:.4f} s, warm "
        f"median {warm:.4f} s of 5; f32 (Gram, VJP) launches {per_eval32}")
    check(per_eval32 == (1, 1), f"a 'fast' {kind} loss+grad evaluation "
          f"launched the f32 kernels {per_eval32} times, expected (1, 1)")
    check(np.isfinite(v) and bool(np.isfinite(g).all()),
          f"'fast' {kind} loss+grad not finite")
    del fm, vg
    hi = LCGP(y, x, q=20, kernel=kind, device=dev)
    mx = LCGP(y, x, q=20, kernel=kind, precision="mixed", device=dev)
    l_hi, l_mx = float(hi.loss()), float(mx.loss())
    rel = abs(l_mx - l_hi) / abs(l_hi)
    say(f"  {kind} loss at the init: 'mixed' {l_mx!r} ({mx._compute_dtype!r})"
        f" vs 'high' {l_hi!r}: rel {rel:.3e} (bound 1e-9)")
    check(rel <= 1e-9, f"the 'mixed' {kind} loss differs from 'high' beyond "
          "1e-9")
    del hi, mx
    torch.cuda.empty_cache()
    return per_eval32, warm


def phase_kind_rep(dev, kind):
    """Phase 10, part 4: the rep path with the kind at phase 4's size (200
    unique sites, 1-5 replicates, p=20, q=4, d=3): the model on the card
    against the same model on the CPU (the plain versions), the loss rtol
    1e-9 and the predictions within 1e-7 of each output's largest entry."""
    from lcgp_tpu_torch import LCGP
    x, y, x0 = rep_problem(10, 200, 3, 20, 30, 5)
    rng = np.random.default_rng(40)
    params = dict(lLmb=rng.uniform(0.2, 1.5, (4, 3)),
                  lLmb0=rng.uniform(0.5, 3.0, 4),
                  lnugGPs=rng.uniform(1e-6, 1e-3, 4))
    ms = []
    for where in (dev, "cpu"):
        m = LCGP(y, x, q=4, kernel=kind, submethod="rep", device=where)
        m.set_params(**params)
        ms.append(m)
    gpu, cpu = ms
    lg, lc = float(gpu.loss()), float(cpu.loss())
    rel = abs(lg - lc) / abs(lc)
    say(f"  {kind} rep (n_unique={gpu.n} of N={x.shape[0]} rows): loss "
        f"{lg!r} vs the CPU's {lc!r}: rel {rel:.3e}")
    check(rel <= 1e-9, f"the {kind} rep loss differs from the CPU's")
    for name, a, b in zip(("ypred", "ypredvar", "yconfvar"), gpu.predict(x0),
                          cpu.predict(x0)):
        compare_normwise(f"{kind} rep {name} vs the CPU run", a.cpu(), b,
                         1e-7)


def phase_kinds(dev, x, y, xte, ytrue, free_np, xs, registers):
    """Phase 10: Matern 5/2 (K3) and the squared exponential (K4) at config
    4.  For each kind: its kernels against their plain versions and timed
    (part 1), the Gram at the fitted config-4 lengthscales against extended
    precision, then the main path with the kind's launch counts set to 0
    just before it and read just after: the f64 model (part 2), the f32
    instantiations on a path (part 3) and the rep path (part 4).  Returns
    the kernel records."""
    records = []
    for kind in REPLACES:
        fn = family_of(kind)
        label = fn.label
        say(f"  == kernel={kind!r}: {label} and its VJP against their plain "
            "versions")
        recs = phase_kind_kernels(dev, kind, x, y, xte)
        phase_fitted_gram(dev, xs, free_np, kind)
        say(f"  == kernel={kind!r}: the main path (f64 model at config 4, "
            "'fast' and 'mixed', the rep path)")
        reset_counts(kind)
        per_eval, timings = phase_kind_model(dev, kind, x, y, xte, ytrue)
        per_eval32, fast_s = phase_kind_precision(dev, kind, x, y)
        phase_kind_rep(dev, kind)
        main = (fn.gram.launches, fn.vjp.launches)
        main32 = f32_counts(kind)
        say(f"  {kind} main path launches: {label} {main[0]} (f32 "
            f"{main32[0]}), {label} VJP {main[1]} (f32 {main32[1]})")
        check(min(main + main32) > 0, f"a {kind} kernel did not launch on "
              f"phase 10's main path: {main}, f32 {main32}")
        timings["fast_loss_grad_s"] = fast_s
        say(f"  {kind} timings JSON: {json.dumps(timings)}")
        for rec, i, dt in zip(recs, (0, 1, 0, 1),
                              ("double", "double", "float", "float")):
            rec["launches"] = (main32 if dt == "float" else main)[i]
            rec["launches_per_eval"] = (per_eval32 if dt == "float"
                                        else per_eval)[i]
            rec["registers"] = registers_of(
                registers, KERNEL_TEMPLATES[kind][i], fn.policy, dt)
            rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        recs[0]["model"] = timings
        records.extend(recs)
    return records


# ---------------------------------------------------------------------------
# Phase 11: the FITC inducing-point path at benchmarks/run_configs.py's
# configs 6-8
# ---------------------------------------------------------------------------

# lcgp_tpu's recorded accuracy at config 6 (RESULTS.md, "Config 6": 200 Adam
# steps at 'fast', 500 held-out points); accuracy only, no time
CONFIG6_RECORDED = {"rmse": 0.067, "nrmse": 0.026, "coverage": 1.00}
FITC_ADAM_STEPS = 200
REFINE_STEPS = 20
# One device's 'fast' FITC at config 7's init against the card's own f64
# ('high'): 4x the reference's (lcgp_tpu's) own 'fast' error on the CPU.
# The loss (relative), ypred and yconfvar at the 64 held-out points (of the
# largest entry) are 4x lcgp_tpu's errors at config 7 read on a CPU
# (1.145e-3, 0.0180, 3.50e-3; a full-size run no script here repeats);
# ypredvar is held to yconfvar's bound.  Each gradient leaf (of its max
# |g|) is 4x lcgp_tpu's error at FITC7_REFERENCE_ERRORS' largest n: its
# un-chunked jax.grad at 400,000 rows needs ~16 GB a component on the CPU,
# and its error grows with n.  Phase 11 holds config 7 to these, config
# 8's loss to the loss bound; phase 14 holds every rank of the meshes to
# them and to FITC_MESH_ERR_RATIO x one device's own error.
FITC7_FAST_BOUNDS = dict(loss=4.6e-3, ypred=0.072, ypredvar=0.014,
                         yconfvar=0.014, lLmb=0.06387, lLmb0=0.2676,
                         lsigma2s=0.007197, lnugGPs=0.0652)
# lcgp_tpu's own 'fast' error on the first n rows of config 7's field with
# config 7's inducing points and request (fitc7_inputs), at the init, read
# on a CPU by
#   PYTHONPATH=. python tools/fitc7_reference_errors.py <n>
FITC7_REFERENCE_ERRORS = {
    20_000: dict(loss=2.7416e-05, lLmb=1.3679e-03, lLmb0=2.2427e-03,
                 lsigma2s=4.4413e-04, lnugGPs=1.2467e-03, ypred=1.0975e-04,
                 ypredvar=2.8537e-07, yconfvar=2.4331e-04),
    100_000: dict(loss=1.6764e-04, lLmb=1.5968e-02, lLmb0=6.6897e-02,
                  lsigma2s=1.7992e-03, lnugGPs=1.6300e-02, ypred=1.8766e-03,
                  ypredvar=3.3620e-07, yconfvar=8.3803e-04),
}
# a mesh's 'fast' answers within this many times one device's own error
FITC_MESH_ERR_RATIO = 4.0


def fitc7_fast_bounds(n=None):
    """FITC7_FAST_BOUNDS, each capped at 4x the reference's own error at n
    rows of config 7's field where FITC7_REFERENCE_ERRORS holds it."""
    ref = FITC7_REFERENCE_ERRORS.get(n, {})
    return {k: min(b, 4 * ref[k]) if k in ref else b
            for k, b in FITC7_FAST_BOUNDS.items()}


FITC_LEAVES = ("lLmb", "lLmb0", "lsigma2s", "lnugGPs")
# the kernel rows of config 7's one-device panel, (4, 400000, 512): K1 at
# Knm and K2 at its cotangent (f32, the path's; f64 under *_f64)
FITC_ROWS_7 = ("matern32_gram_fitc7", "matern32_gram_vjp_fitc7")
K5_SOURCE = "lcgp_tpu_torch/csrc/gram_vjp_x.cu"
K5_REPLACES = ("none (jax.grad of the jnp Gram in its second operand): "
               "lcgp_tpu/models/sparse.py:76 (_fitc_core's Gram stacks), "
               "taken by lcgp_tpu/models/lcgp.py:930 (refine_inducing)")


def fitc_config(idx):
    """benchmarks/run_configs.py:config6/7/8 as they make their data:
    (x, y, xte, ytrue, kwargs).  A copy, since that module's metrics import
    lcgp_tpu."""
    seed, n, m = {6: (11, 50_000, 256), 7: (13, 400_000, 512),
                  8: (17, 2_000_000, 512)}[idx]
    rng = np.random.default_rng(seed)
    d, p, q = 2, 20, 4
    x = rng.uniform(0, 1, (n + 500, d))
    t = np.linspace(0, 1, p)[:, None]
    f = (np.sin(2 * np.pi * (t + x[:, :1].T)) * x[:, 1:2].T
         + np.cos(np.pi * t * x[:, 1:2].T))
    if idx > 6:
        f = f + 0.3 * np.sin(4 * np.pi * x[:, :1].T + np.pi * t)
    y = f + 0.05 * rng.standard_normal(f.shape)
    kwargs = dict(q=q, inducing=m)
    if idx == 7:
        kwargs["n_chunk"] = 0
    return x[:n], y[:, :n], x[n:], f[:, n:], kwargs


def k5_ops_per_entry(kind, d):
    """K5's instructions per entry and component, as the function needs
    them: the cotangent times amp (1 - eta) and the decay (2), and
    Matern 3/2: S, product and sum (3d), exp (~16), per dimension the
    prefix times the suffix, times S, times 1/l, the sign, the sum and the
    suffix's factor (6d); Matern 5/2: S, factor, product and sum (5d),
    sqrt5 times the sum and exp (~17), per dimension 1 + sqrt5 S, S times
    it, the products, 1/l, sign, sum and the suffix's fma (8d; the kernel
    also recomputes the factor for the suffix, 2d); SE: S and its fma into
    the sum (2d), -1/2 times the sum and exp (~17), per dimension the
    suffix times S, 1/l, sign and sum (4d)."""
    return {"matern32": 9 * d + 18, "matern52": 13 * d + 19,
            "rbf": 6 * d + 19}[kind]


def fitc_counts():
    """(Gram, VJP, K5) launches of every family, f64 and f32 apart:
    {kind: ((gram, vjp, vjp_x) f64, (...) f32)}."""
    out = {}
    for kind in OPS_PER_ENTRY:
        f = family_of(kind)
        c = [(fn.launches - fn.launches_f32, fn.launches_f32)
             for fn in (f.gram, f.vjp, f.vjp_x)]
        out[kind] = (tuple(a for a, _ in c), tuple(b for _, b in c))
    return out


def reset_all_counts():
    for kind in OPS_PER_ENTRY:
        f = family_of(kind)
        for fn in (f.gram, f.vjp, f.vjp_x):
            fn.launches = fn.launches_f32 = 0


def count_delta(before, after):
    return {k: tuple(tuple(a - b for a, b in zip(x, y))
                     for x, y in zip(after[k], before[k])) for k in after}


def phase_fitc_kernels(dev, xs, z):
    """Phase 11, part 1: K1 and K4's Gram rectangular (Knm), K2 and K4's
    VJP at an arbitrary cross cotangent (two launches bit for bit equal)
    and K5 of each family against their plain versions on the card at
    config 6's shapes (4, n, m), f64 and f32, timed in turns with their
    bounds, and once at a ragged tall shape.  Returns the kernel records
    (their launches come from the main path)."""
    import torch
    from lcgp_tpu_torch.ops._build import build
    lib = build().lib
    rng = np.random.default_rng(31)
    q, n, d, m = 4, xs.shape[0], xs.shape[1], z.shape[0]
    records = []
    for dt in (torch.float64, torch.float32):
        tag, size = ("f64", 8) if dt == torch.float64 else ("f32", 4)
        rtol, atol = ((F64_RTOL, F64_ATOL) if dt == torch.float64
                      else (F32_RTOL, F32_ATOL))
        vjp_bound = VJP_BOUND if dt == torch.float64 else VJP_BOUND_F32
        rate = F64_INSTR_PER_S if dt == torch.float64 else F32_INSTR_PER_S
        ls, amp, nug = moderate_params(rng, q, d, dev, torch.float64)
        ls = ls * 0.1                      # config 6's scale: l ~ 1/16
        x1, x2, ls_, amp_, nug_ = (t.to(dt).contiguous()
                                   for t in (xs, z, ls, amp, nug))
        gen = torch.Generator(device=dev).manual_seed(32)
        M = torch.randn((q, n, m), generator=gen, dtype=dt, device=dev)
        ins = (x1.numel() + x2.numel() + ls_.numel() + 2 * q) * size

        xr, zr = x1[:12345], x2[:200]
        # K1 and K4's Gram at Knm, K2 and K4's VJP at a random cross
        # cotangent (they share the plain family functions)
        for kind in ("matern32", "rbf"):
            fam = family_of(kind)
            g_ops, v_ops = OPS_PER_ENTRY[kind]
            glab = fam.label
            vlab = "K2" if kind == "matern32" else f"{glab} VJP"
            g_src, v_src, g_rep, v_rep = (
                (K1_SOURCE, K2_SOURCE, K1_REPLACES, K2_REPLACES)
                if kind == "matern32" else
                (f"lcgp_tpu_torch/csrc/{kind}_gram.cu",
                 f"lcgp_tpu_torch/csrc/{kind}_gram_vjp.cu", *REPLACES[kind]))

            def p_gram(fam=fam):
                return fam.plain(x1, x2, ls_, amp_, nug_, same=False)

            def p64(*ts, fam=fam):
                return fam.plain(*(t.double() for t in ts), same=False)
            # against the plain version in f64 at the same (f32) inputs
            err_g = [compare(f"{glab} {tag} Knm (q={q}, n={n}, m={m}, d={d}) "
                             "vs plain f64", fam.launch(x1, x2, ls_, amp_,
                                                        nug_, same=False)[0],
                             p64(x1, x2, ls_, amp_, nug_), rtol, atol)]
            err_g.append(compare(f"{glab} {tag} ragged (q={q}, n=12345, "
                                 "m=200) vs plain f64",
                                 fam.launch(xr, zr, ls_, amp_, nug_,
                                            same=False)[0],
                                 p64(xr, zr, ls_, amp_, nug_), rtol, atol))
            t_g = time_pair(f"{glab} {tag} Knm (q={q} n={n} m={m})",
                            raw_gram(lib, x1, x2, ls_, amp_, nug_, False,
                                     family=kind), p_gram,
                            q * n * m * size, plain_reps=3)
            b_g = say_bound(f"{glab} {tag} Knm", t_g[0],
                            q * n * m * size + ins,
                            q * n * m * g_ops(d, False), rate)
            records.append(dict(
                name=f"{kind}_gram_fitc{'' if tag == 'f64' else '_f32'}",
                route="cuda", source=g_src, replaces=g_rep,
                max_abs_err=max(err_g), ms=t_g[0], plain_ms=t_g[1],
                bound_ms=b_g[0], bound_by=b_g[1], library_ms=None,
                shape=f"Knm {tag} q={q} n={n} m={m} d={d}"))

            def p_vjp(fam=fam):
                return fam.vjp_plain(x1, x2, ls_, amp_, nug_, same=False,
                                     cbar=M)
            err_v = []
            for a1, a2, Mc, lab in ((x1, x2, M, f"n={n}, m={m}"),
                                    (xr, zr, M[:, :12345, :200].contiguous(),
                                     "ragged n=12345, m=200")):
                got = fam.launch_vjp(a1, a2, ls_, amp_, nug_, same=False,
                                     M=Mc)
                again = fam.launch_vjp(a1, a2, ls_, amp_, nug_, same=False,
                                       M=Mc)
                b64 = [t.double() for t in (a1, a2, ls_, amp_, nug_)]
                ref = fam.vjp_plain(*b64, same=False, cbar=Mc.double())
                scale = fam.scale(*b64, same=False, cbar=Mc.double())
                torch.cuda.synchronize()
                check(all(torch.equal(u, v) for u, v in zip(got, again)),
                      f"{vlab} {tag} at a random cotangent ({lab}): two "
                      "launches differ")
                err_v.append(compare_vjp(f"{vlab} {tag} at a random "
                                         f"cotangent (q={q}, {lab}) vs "
                                         "plain; two launches the same bits",
                                         got, ref, scale,
                                         vjp_bound=vjp_bound, kernel=vlab))
            t_v = time_pair(f"{vlab} {tag} random cotangent (q={q} n={n} "
                            f"m={m})",
                            raw_vjp(lib, x1, ls_, amp_, nug_, M, None, 0.0,
                                    None, family=kind, x2=x2), p_vjp,
                            M.numel() * size, "read", plain_reps=3)
            b_v = say_bound(f"{vlab} {tag} random cotangent", t_v[0],
                            M.numel() * size + ins + q * (d + 2) * size,
                            q * n * m * (v_ops(d) - 2), rate)
            records.append(dict(
                name=f"{kind}_gram_vjp_fitc{'' if tag == 'f64' else '_f32'}",
                route="cuda", source=v_src, replaces=v_rep,
                max_abs_err=max(err_v), ms=t_v[0], plain_ms=t_v[1],
                bound_ms=b_v[0], bound_by=b_v[1], library_ms=None,
                shape=f"random cross cotangent {tag} q={q} n={n} m={m} "
                      f"d={d}"))

        # K5 of each family
        for kind in OPS_PER_ENTRY:
            fam = family_of(kind)
            err_x = []
            for a1, a2, Mc, lab in ((x1, x2, M, f"n={n}, m={m}"),
                                    (xr, zr, M[:, :12345, :200].contiguous(),
                                     "ragged n=12345, m=200")):
                got = fam.launch_vjp_x(a1, a2, ls_, amp_, nug_, M=Mc)
                again = fam.launch_vjp_x(a1, a2, ls_, amp_, nug_, M=Mc)
                b64 = [t.double() for t in (a1, a2, ls_, amp_, nug_)]
                ref = fam.vjp_x_plain(*b64, M=Mc.double())
                scale = fam.scale_x(*b64, M=Mc.double())
                torch.cuda.synchronize()
                err = (got.double() - ref).abs()
                share = float((err / scale.clamp_min(1e-300)).max())
                say(f"  K5 {kind} {tag} (q={q}, {lab}) vs plain: "
                    f"max_abs_err={float(err.max()):.3e}, max err/magnitude="
                    f"{share:.3e} (bound {vjp_bound:g}); two launches the "
                    f"same bits: {torch.equal(got, again)}")
                check(bool(torch.isfinite(got).all()), f"K5 {kind} not finite")
                check(bool((err <= vjp_bound * scale).all()),
                      f"K5 {kind} {tag} outside {vjp_bound:g} x magnitude")
                check(torch.equal(got, again), f"K5 {kind} {tag} is not "
                      "deterministic")
                err_x.append(float(err.max()))

            def p_x(fam=fam):
                return fam.vjp_x_plain(x1, x2, ls_, amp_, nug_, M=M)
            t_x = time_pair(f"K5 {kind} {tag} (q={q} n={n} m={m})",
                            raw_vjp_x(lib, x1, x2, ls_, amp_, nug_, M, kind),
                            p_x, M.numel() * size, "read", plain_reps=3)
            b_x = say_bound(f"K5 {kind} {tag}", t_x[0],
                            M.numel() * size + ins + m * d * size,
                            q * n * m * k5_ops_per_entry(kind, d), rate)
            records.append(dict(
                name=f"{kind}_gram_vjp_x{'' if tag == 'f64' else '_f32'}",
                route="cuda", source=K5_SOURCE, replaces=K5_REPLACES,
                max_abs_err=max(err_x), ms=t_x[0], plain_ms=t_x[1],
                bound_ms=b_x[0], bound_by=b_x[1], library_ms=None,
                shape=f"(q, n, m) cotangent {tag} q={q} n={n} m={m} d={d}"))
        del M
        torch.cuda.empty_cache()
    return records


def fitc_loss_grad(m, with_z=True):
    """The model's FITC loss and flat gradient in (free, z), or in free
    alone, as refine_inducing and the fits take them: (value, gradient,
    flattener)."""
    import torch
    from lcgp_tpu_torch.fit._flat import Flattener
    tree = {"free": m.free, "z": m._z} if with_z else m.free
    flat = Flattener(tree)
    leaf = flat.ravel(tree).clone().requires_grad_(True)
    t = flat.unravel(leaf)
    fitc = m._fitc_loss(m._compute_dtype)
    v = fitc(t["free"], t["z"]) if with_z else fitc(t, m._z)
    (g,) = torch.autograd.grad(v, leaf)
    return v.detach(), g, flat


def kmm_cond(m):
    """The largest condition number of Kmm + KMM_JITTER amp over the
    components, at the model's parameters and z, computed on the CPU."""
    import torch
    from lcgp_tpu_torch.models import params as P
    from lcgp_tpu_torch.models.sparse import KMM_JITTER
    from lcgp_tpu_torch.ops.gram import gram_stack
    with torch.no_grad():
        ls, amp, _, nug = (t.cpu() for t in P.constrain(m.free))
        K = gram_stack(m._z.cpu(), m._z.cpu(), ls, amp, nug, same=False,
                       kind=m.kernel)
        eye = torch.eye(K.shape[-1], dtype=K.dtype)
        return float(torch.linalg.cond(
            K + KMM_JITTER * amp[:, None, None] * eye).max())


def z_grad_rtol(m):
    """The z gradient's tolerance: GRAD_RTOL, or 10 eps cond(Kmm + jitter)
    of its max |g| where that is larger.  The z gradient is a small
    residue of terms through Kmm's factor, and its rounding error grows
    with Kmm's conditioning: the squared exponential's Kmm at config 6's
    init reaches cond 2.8e9, and there two reduction orders on one CPU
    (dense and streamed) already part by 1.1e-7 of its max |g|."""
    return max(GRAD_RTOL, 10 * float(np.finfo(np.float64).eps) * kmm_cond(m))


def fast_vs_f64_check(tag, got, ref, flat, one=None, loss_only=False,
                      bounds=None):
    """A config-7 'fast' answer, got = (loss, flat gradient, [ypred,
    ypredvar, yconfvar]), against the f64 one: the loss relative, each
    gradient leaf of its max |g|, each output of its largest entry, each
    within ``bounds`` (FITC7_FAST_BOUNDS by default).  ``one``, one
    device's 'fast' answer, also caps each bound at FITC_MESH_ERR_RATIO
    times one device's own error; ``loss_only`` holds the loss alone.
    Returns the errors."""
    bounds = FITC7_FAST_BOUNDS if bounds is None else bounds

    def parts(ans):
        v, g, pred = ans
        out = [("loss", np.asarray([v], dtype=np.float64))]
        if loss_only:
            return out
        g = np.asarray(g.cpu() if hasattr(g, "cpu") else g,
                       dtype=np.float64)
        start = 0
        for nm, size in zip(FITC_LEAVES, flat.sizes):
            out.append((nm, g[start:start + size]))
            start += size
        return out + list(zip(("ypred", "ypredvar", "yconfvar"), pred))
    errs = {}
    rows = zip(parts(got), parts(ref), parts(one) if one is not None
               else [(None, None)] * 8)
    for (name, a), (_, c), (_, b) in rows:
        a, c = (np.asarray(t, dtype=np.float64) for t in (a, c))
        top = float(np.abs(c).max())
        err = float(np.abs(a - c).max()) / top
        bound, extra = bounds[name], ""
        if b is not None:
            e1 = float(np.abs(np.asarray(b, np.float64) - c).max()) / top
            bound = min(bound, FITC_MESH_ERR_RATIO * e1)
            extra = (f"; min of {bounds[name]:g} and {FITC_MESH_ERR_RATIO:g}"
                     f"x one device's 'fast' {e1:.3e}")
        say(f"  {tag} {name} vs f64: {err:.3e} "
            f"({'relative' if name == 'loss' else 'of its largest'}; "
            f"bound {bound:.4g}{extra})")
        check(err <= bound, f"{tag}: 'fast' {name} {err:.3e} beyond "
              f"{bound:.4g} of the f64 answer")
        errs[name] = err
    return errs


def compare_grads(name, got, ref, flat, rtol, z_rtol=None):
    """Each leaf of a flat gradient within rtol (the z leaf within z_rtol,
    rtol when None) of the leaf's max |g|."""
    start = 0
    leaf_names = (["lLmb", "lLmb0", "lsigma2s", "lnugGPs", "z"])
    for nm, size in zip(leaf_names, flat.sizes):
        a = got[start:start + size].double().cpu()
        b = ref[start:start + size].double().cpu()
        start += size
        tol = z_rtol if nm == "z" and z_rtol is not None else rtol
        err, top = float((a - b).abs().max()), float(b.abs().max())
        say(f"  {name} {nm}: max_abs_err={err:.3e} (max |g| {top:.3e}, rel "
            f"{err / max(top, 1e-300):.3e}, bound {tol:.3g})")
        check(err <= tol * top, f"{name}: {nm} differs beyond {tol:g} of "
              "its max |g|")


def phase_fitc_cut(dev, x, y):
    """Phase 11, part 2: the FITC loss and its gradient in (free, z) on the
    card against the same port on the CPU, at a small cut of config 6
    (n=2000, m=64), f64, dense and streamed, for each kernel family."""
    import torch
    from lcgp_tpu_torch import LCGP
    for kind in OPS_PER_ENTRY:
        for n_chunk in (0, 512):
            ms = [LCGP(y[:, :2000], x[:2000], q=4, inducing=64,
                       n_chunk=n_chunk, kernel=kind, device=d_)
                  for d_ in (dev, "cpu")]
            (vg, gg, flat), (vc, gc, _) = (fitc_loss_grad(m) for m in ms)
            rel = abs(float(vg) - float(vc)) / abs(float(vc))
            say(f"  {kind} n_chunk={n_chunk}: loss card {float(vg):.12e} vs "
                f"CPU {float(vc):.12e}, rel {rel:.3e}")
            check(rel <= 1e-10, f"{kind} FITC loss on the card differs from "
                  "the CPU's")
            z_rtol = z_grad_rtol(ms[1])
            say(f"  {kind}: cond(Kmm + jitter) {kmm_cond(ms[1]):.3e}, z "
                f"gradient bound {z_rtol:.3g}")
            compare_grads(f"{kind} n_chunk={n_chunk} gradient card vs CPU",
                          gg, gc, flat, GRAD_RTOL, z_rtol)


def fitc_metrics(m, xte, ytrue):
    """rmse, nrmse, 95% coverage and mean width of the model's predictions
    at the held-out points, by the port's evaluation module."""
    from lcgp_tpu_torch import evaluation
    ypred, ypredvar, _ = (t.cpu().numpy() for t in m.predict(xte))
    cover, width = evaluation.intervalstats(ytrue, ypred, ypredvar)
    return {"rmse": evaluation.rmse(ytrue, ypred),
            "nrmse": evaluation.normalized_rmse(ytrue, ypred),
            "coverage": cover, "width": width}


def phase_fitc_config6(dev):
    """Phase 11, part 3: config 6 (n=50,000, d=2, p=20, q=4, m=256).  The
    f64 loss+grad dense against streamed (n_chunk=8192) to machine
    precision with their launches; one f64 loss+grad in (free, z) per
    kernel family; then the 'fast' model as lcgp_tpu ran it: one timed
    loss+grad, fit(method='adam', steps=200), 500 held-out predictions
    against lcgp_tpu's recorded accuracy, and refine_inducing(steps=20),
    which must launch K5 and not raise the loss.  Returns the timings and
    the refined 'fast' model, which phase 12 serves."""
    import torch
    from lcgp_tpu_torch import LCGP
    x, y, xte, ytrue, kw = fitc_config(6)
    out = {}
    res = {}
    for n_chunk in (0, 8192):
        m = LCGP(y, x, n_chunk=n_chunk, device=dev, **kw)
        before = fitc_counts()
        res[n_chunk] = fitc_loss_grad(m)
        torch.cuda.synchronize()
        delta = count_delta(before, fitc_counts())["matern32"][0]
        nb = -(-m.n // n_chunk) if n_chunk else 0
        expect = (2, 2, 3) if not n_chunk else (1 + 2 * nb, 1 + nb, 2 + nb)
        say(f"  config 6 f64 n_chunk={n_chunk or None} ({nb} blocks): loss "
            f"{float(res[n_chunk][0]):.12e}; (K1, K2, K5) launches {delta}, "
            f"expected {expect}")
        check(delta == expect, f"config 6 n_chunk={n_chunk} launched {delta}")
    (v0, g0, flat), (v1, g1, _) = res[0], res[8192]
    rel = abs(float(v1) - float(v0)) / abs(float(v0))
    say(f"  streamed vs dense loss: rel {rel:.3e}; cond(Kmm + jitter) "
        f"{kmm_cond(m):.3e}")
    check(rel <= 1e-12, "streamed FITC loss differs from the dense one")
    # one reduction order against another: the z gradient to its
    # conditioning's precision, as on the card against the CPU
    compare_grads("config 6 streamed vs dense gradient", g1, g0, flat,
                  GRAD_RTOL, z_grad_rtol(m))
    del res, m
    # Kmm is f64 in every precision; under 'fast' Knm is f32
    expect = {"high": ((2, 2, 3), (0, 0, 0)), "fast": ((1, 1, 2), (1, 1, 1))}
    for kind in ("matern52", "rbf"):
        for precision in ("high", "fast"):
            m = LCGP(y, x, kernel=kind, precision=precision, device=dev,
                     **kw)
            before = fitc_counts()
            t0 = time.perf_counter()
            v, g, _ = fitc_loss_grad(m)
            torch.cuda.synchronize()
            t = time.perf_counter() - t0
            delta = count_delta(before, fitc_counts())[kind]
            say(f"  config 6 kernel={kind!r} precision={precision!r}: "
                f"loss+grad in (free, z) {t:.4f} s (first call), loss "
                f"{float(v):.10e}; (Gram, VJP, K5) launches f64 {delta[0]}, "
                f"f32 {delta[1]}")
            check(delta == expect[precision],
                  f"{kind} {precision} loss+grad launched {delta}")
            check(bool(torch.isfinite(g).all()), f"{kind} gradient not finite")
            del m

    t0 = time.perf_counter()
    m = LCGP(y, x, precision="fast", device=dev, **kw)
    torch.cuda.synchronize()
    out["construct_s"] = time.perf_counter() - t0
    fitc_loss_grad(m, with_z=False)
    before = fitc_counts()
    warm = [timed_s(lambda: fitc_loss_grad(m, with_z=False))
            for _ in range(3)]
    delta = count_delta(before, fitc_counts())["matern32"]
    out["loss_grad_s"] = statistics.median(warm)
    out["loss_grad_device_ms"] = profile_device(
        "one config-6 'fast' loss+grad", lambda: fitc_loss_grad(
            m, with_z=False), 8)
    say(f"  config 6 'fast': construct {out['construct_s']:.3f} s; loss+grad "
        f"warm median {out['loss_grad_s']:.4f} s of 3 (device busy "
        f"{out['loss_grad_device_ms'] / 1e3:.4f} s: idle share "
        f"{1 - out['loss_grad_device_ms'] / 1e3 / out['loss_grad_s']:.1%}); "
        f"(K1, K2, K5) launches over the 3: f64 {delta[0]} (Kmm), f32 "
        f"{delta[1]} (Knm)")
    check(delta == ((3, 3, 0), (3, 3, 0)), f"'fast' loss+grad launched "
          f"{delta}")
    torch.cuda.reset_peak_memory_stats()
    out["fit_s"] = timed_s(lambda: m.fit(method="adam",
                                         steps=FITC_ADAM_STEPS))
    out["fit_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    met = fitc_metrics(m, xte, ytrue)
    out.update(met)
    say(f"  fit(method='adam', steps={FITC_ADAM_STEPS}) {out['fit_s']:.3f} s "
        f"({out['fit_s'] / FITC_ADAM_STEPS:.4f} s per step), peak "
        f"{out['fit_peak_gb']:.3f} GB, loss {m._fit_result.fun:.8g}; 500 "
        f"held-out points: rmse {met['rmse']:.4f} (lcgp_tpu recorded "
        f"{CONFIG6_RECORDED['rmse']}), nrmse {met['nrmse']:.4f} "
        f"({CONFIG6_RECORDED['nrmse']}), coverage {met['coverage']:.3f} "
        f"({CONFIG6_RECORDED['coverage']}), width {met['width']:.3f}")
    check(met["rmse"] <= 2 * CONFIG6_RECORDED["rmse"],
          f"config 6 rmse {met['rmse']:.4f} above twice lcgp_tpu's")
    stats = m._fitc_clamp_stats
    say(f"  variance clamp statistics of that predict: {stats}")
    l0 = float(m.loss())
    k5 = family_of("matern32").vjp_x.launches
    out["refine_s"] = timed_s(lambda: m.refine_inducing(steps=REFINE_STEPS))
    k5 = family_of("matern32").vjp_x.launches - k5
    l1 = float(m.loss())
    met = fitc_metrics(m, xte, ytrue)
    say(f"  refine_inducing(steps={REFINE_STEPS}) {out['refine_s']:.3f} s: "
        f"loss {l0:.10g} -> {l1:.10g}; K5 launches {k5}; rmse "
        f"{met['rmse']:.4f}, coverage {met['coverage']:.3f}")
    check(k5 == 3 * REFINE_STEPS, f"refine_inducing launched K5 {k5} times")
    check(l1 <= l0, "refine_inducing raised the loss")
    out["refine_rmse"] = met["rmse"]
    return out, m


def phase_fitc_scale(dev, idx):
    """Phase 11, parts 4 and 5: config 7 (n=400,000, m=512, un-chunked) or
    8 (n=2,000,000, m=512, n_chunk automatic) at 'fast': construction, one
    timed loss+grad with its launches and peak memory, the aux and a
    500-point predict.  Config 8 fails if its peak memory exceeds a quarter
    of the un-chunked panels' 4 q n m itemsize.  Then the same model in
    'high' (f64): at config 7 the 'fast' loss, each gradient leaf and the
    64-point predictions are held to it within FITC7_FAST_BOUNDS, at
    config 8 the 'fast' loss (one f64 streamed pass) within its loss
    bound.  Returns a dict."""
    import torch
    from lcgp_tpu_torch import LCGP
    x, y, xte, ytrue, kw = fitc_config(idx)
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    m = LCGP(y, x, precision="fast", device=dev, **kw)
    torch.cuda.synchronize()
    out = {"construct_s": time.perf_counter() - t0, "n_chunk": m.n_chunk}
    n, q, mm = m.n, int(m.q), int(m._z.shape[0])
    nb = -(-n // m.n_chunk) if m.n_chunk else 0
    out["n_blocks"] = nb
    before = fitc_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    fast = []
    first = timed_s(lambda: fast.append(fitc_loss_grad(m, with_z=False)))
    out["loss_grad_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["loss_grad_peak_above_data_gb"] = (
        torch.cuda.max_memory_allocated() - base) / 1e9
    delta = count_delta(before, fitc_counts())["matern32"]
    warm = timed_s(lambda: fitc_loss_grad(m, with_z=False))
    out["loss_grad_s"], out["loss_grad_first_s"] = warm, first
    # Kmm in f64, Knm in f32: once, or per block and again in the
    # checkpoint's recomputation
    expect = ((1, 1, 0), (1, 1, 0) if not nb else (2 * nb, nb, 0))
    out["launches_per_loss_grad"] = [sum(c) for c in zip(*delta)]
    panels = 4 * q * n * mm * 4
    say(f"  config {idx} 'fast' (n={n}, m={mm}, n_chunk={m.n_chunk}, "
        f"{nb} blocks): construct {out['construct_s']:.2f} s; loss+grad "
        f"first {first:.4f} s, warm {warm:.4f} s; (K1, K2, K5) launches of "
        f"the first f64 {delta[0]}, f32 {delta[1]}, expected {expect}; peak "
        f"{out['loss_grad_peak_gb']:.3f} GB ({out['loss_grad_peak_above_data_gb']:.3f}"
        f" GB above the resident model; the un-chunked panels "
        f"4 q n m itemsize are {panels / 1e9:.3f} GB)")
    check(delta == expect, f"config {idx} loss+grad launched {delta}")
    out["loss_grad_device_ms"] = profile_device(
        f"one config-{idx} 'fast' loss+grad", lambda: fitc_loss_grad(
            m, with_z=False), 10)
    say(f"  device busy {out['loss_grad_device_ms'] / 1e3:.4f} s of the "
        f"warm {warm:.4f} s: idle share "
        f"{1 - out['loss_grad_device_ms'] / 1e3 / warm:.1%}")
    if idx == 8:
        check(m.n_chunk == 32768 and nb == 62,
              f"config 8 resolved n_chunk={m.n_chunk}, {nb} blocks")
        check(torch.cuda.max_memory_allocated() <= panels / 4,
              "config 8's peak exceeds a quarter of the un-chunked panels")
    torch.cuda.reset_peak_memory_stats()
    out["aux_s"] = timed_s(m.compute_aux_predictive_quantities)
    out["predict_s"] = timed_s(lambda: out.update(
        fitc_metrics(m, xte, ytrue)))
    out["serve_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    check(np.isfinite(out["rmse"]), f"config {idx} predictions not finite")
    say(f"  config {idx} aux {out['aux_s']:.3f} s, predict(500) "
        f"{out['predict_s']:.3f} s, peak {out['serve_peak_gb']:.3f} GB; at "
        f"the init (no fit): rmse {out['rmse']:.4f}, coverage "
        f"{out['coverage']:.3f}")
    v32, g32, flat = fast[0]
    x0 = xte[:64]
    pred32 = model_outs(m, x0) if idx == 7 else None
    # the same inducing points, not chosen again
    kw["inducing"] = m.tx_x(m._z).cpu().numpy()
    del m, fast
    torch.cuda.empty_cache()
    # the card's own f64 answer
    t0 = time.perf_counter()
    m = LCGP(y, x, precision="high", device=dev, **kw)
    if idx == 7:
        v64, g64, _ = fitc_loss_grad(m, with_z=False)
        ref = (float(v64), g64, model_outs(m, x0))
    else:
        with torch.no_grad():
            ref = (float(m.loss()), None, None)
    torch.cuda.synchronize()
    out["f64_s"] = time.perf_counter() - t0
    say(f"  config {idx} 'high' (f64, n_chunk={m.n_chunk}): loss "
        f"{ref[0]:.12e}, 'fast' {float(v32):.12e}; {out['f64_s']:.2f} s")
    out["fast_vs_f64"] = fast_vs_f64_check(
        f"config {idx} one device 'fast'", (float(v32), g32, pred32), ref,
        flat, loss_only=idx != 7)
    del m
    torch.cuda.empty_cache()
    return out


@contextlib.contextmanager
def launches_at(n1, n2, kind="matern32"):
    """Tally the family's Gram and VJP launches whose operands are (n1, d)
    and (n2, d), by kernel and dtype: yields {('gram' or 'vjp', 'f32' or
    'f64'): launches}.  It wraps the family's launchers on the instance,
    beside the counters, which it leaves as they are."""
    fam = family_of(kind)
    tally = {}

    def wrap(which, fn):
        def launch(x1, x2, *args, **kwargs):
            out = fn(x1, x2, *args, **kwargs)
            if x1.shape[0] == n1 and x2.shape[0] == n2:
                key = (which, "f32" if x1.dtype.itemsize == 4 else "f64")
                tally[key] = tally.get(key, 0) + 1
            return out
        return launch
    fam.launch = wrap("gram", fam.launch)
    fam.launch_vjp = wrap("vjp", fam.launch_vjp)
    try:
        yield tally
    finally:
        del fam.launch, fam.launch_vjp


def phase_fitc(dev, card, registers):
    """Phase 11: the FITC path.  The kernels against their plain versions
    at config 6's shapes and at config 7's one-device panel (part 1), then
    the main path with every count set to 0 just before it and read just
    after: the card against the CPU at a small cut (part 2), config 6 (part
    3), config 7 and config 8 (parts 4 and 5).  Config 7's launches at its
    panel, (4, 400000, 512), are filed on its own rows, every other FITC
    launch on the rows of config 6's shapes by dtype.  Returns the kernel
    records and config 6's 'fast' model."""
    import torch
    from lcgp_tpu_torch.models.sparse import select_inducing
    from lcgp_tpu_torch.ops import linalg
    x, _, _, _, kw = fitc_config(6)
    x_min, x_max = x.min(0), x.max(0)
    xs_np = (x - x_min) / (x_max - x_min)
    xs = torch.as_tensor(xs_np, device=dev)
    z = torch.as_tensor(select_inducing(xs_np, kw["inducing"]), device=dev)
    records = phase_fitc_kernels(dev, xs, z)
    del xs, z
    torch.cuda.empty_cache()
    records7 = phase_fitc7_kernels(dev, card)

    reset_all_counts()
    inv_paths = (linalg.chol_inverse.blocked, linalg.chol_inverse.dense)
    say("  == the main path, every kernel's counts set to 0")
    say("  -- card vs CPU at a cut of config 6 (n=2000, m=64, f64)")
    x, y, _, _, _ = fitc_config(6)
    phase_fitc_cut(dev, x, y)
    say("  -- config 6 (n=50,000, d=2, p=20, q=4, m=256)")
    timings = {}
    timings["config6"], m6 = phase_fitc_config6(dev)
    say("  -- config 7")
    with launches_at(fitc_config(7)[0].shape[0], 512) as at7:
        timings["config7"] = phase_fitc_scale(dev, 7)
    say(f"  config 7's launches at its panel (4, 400000, 512): {at7}")
    say("  -- config 8")
    timings["config8"] = phase_fitc_scale(dev, 8)
    counts = fitc_counts()
    say(f"  phase 11 main path launches (Gram, VJP, K5) f64 / f32: {counts}")
    inv_paths = (linalg.chol_inverse.blocked - inv_paths[0],
                 linalg.chol_inverse.dense - inv_paths[1])
    say(f"  chol_inverse calls (blocked, dense): {inv_paths}")
    check(inv_paths[0] == 0 and inv_paths[1] > 0, "expected every "
          "chol_inverse call of FITC's (m, m) inverses (m <= 512) dense")
    say(f"  phase 11 timings JSON: {json.dumps(timings)}")
    for rec in records:
        kind = rec["name"].split("_gram")[0]
        which = 2 if "_vjp_x" in rec["name"] else \
            1 if "_vjp" in rec["name"] else 0
        f32 = rec["name"].endswith("_f32")
        rec["launches"] = counts[kind][int(f32)][which]
        if kind == "matern32" and which < 2:
            rec["launches"] -= at7.get((("gram", "vjp")[which],
                                        ("f64", "f32")[int(f32)]), 0)
        check(rec["launches"] > 0, f"{rec['name']} did not launch on phase "
              "11's main path")
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        kernel = (*KERNEL_TEMPLATES[kind], K5_TEMPLATE)[which]
        rec["registers"] = registers_of(registers, kernel,
                                        family_of(kind).policy,
                                        "float" if f32 else "double")
    for rec, which in zip(records7, ("gram", "vjp")):
        rec["launches_f32"] = at7.get((which, "f32"), 0)
        rec["launches_f64"] = at7.get((which, "f64"), 0)
        rec["launches"] = rec["launches_f32"] + rec["launches_f64"]
        check(rec["launches_f32"] > 0 and rec["launches_f64"] > 0,
              f"{rec['name']} did not launch at its shape, f32 and f64, on "
              "phase 11's main path")
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        rec["share_of_bound_f64"] = rec["bound_ms_f64"] / rec["ms_f64"]
        rec["registers"] = registers_of(
            registers, KERNEL_TEMPLATES["matern32"][which == "vjp"],
            "Matern32", "float")
    records[0]["model"] = timings
    return records + records7, m6


# ---------------------------------------------------------------------------
# Phase 12: the prediction server (lcgp_tpu_torch/serve.py) on captured CUDA
# graphs at config 4, FITC config 6 and over HTTP
# ---------------------------------------------------------------------------

# each kind's Gram kernel as torch.profiler names it: its template and its
# policy (K1 and K4 share gram_kernel)
GRAM_NAMES = {"matern32": ("gram_kernel", "Matern32"),
              "matern52": ("gram_staged_kernel", "Matern52"),
              "rbf": ("gram_kernel", "SE")}
SERVE_REQUESTS = 50           # single-client requests per path
SERVE_SIZES = [1, 3, 7, 16, 31, 63, 100, 127]   # serve_concurrency.py's mix
SERVE_ROUNDS = 5


def pad_rows(x0, bs):
    """x0 padded to bs rows by repeating its last row, as the server pads."""
    return np.concatenate([x0, np.repeat(x0[-1:], bs - x0.shape[0], 0)])


def p50_p95(ms):
    return float(np.percentile(ms, 50)), float(np.percentile(ms, 95))


def latency_ms(fn, n=SERVE_REQUESTS):
    """Host-clock ms of n calls of fn, each returning host arrays, after
    two warm calls."""
    fn()
    fn()
    out = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        out.append((time.perf_counter() - t0) * 1e3)
    return out


def replay_profile(label, fn, top=6):
    """torch.profiler over one dispatch fn(): the total device time (ms) of
    its kernels and copies, and the kernels' names; prints the top ones."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events) / 1e3
    say(f"  profile of {label}: {total:.3f} ms device time; top:")
    for e in events[:top]:
        say(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<3d} "
            f"{e.key[:100]}")
    return total, [e.key for e in events]


def check_gram_in(names, kind, where):
    template, policy = GRAM_NAMES[kind]
    hit = [k for k in names if template in k and policy in k]
    say(f"  {family_of(kind).label} ({template}<..., {policy}>) in {where}: "
        f"{len(hit)} kernel name(s), e.g. {hit[0][:90] if hit else None}")
    check(bool(hit), f"{family_of(kind).label}'s kernel is not in {where}: "
          f"{names}")


def compare_np(name, got, ref, rtol, atol=0.0):
    import torch
    return compare(name, torch.as_tensor(np.asarray(got)),
                   torch.as_tensor(np.asarray(ref)), rtol, atol)


def captures_in(events):
    return [e for e in events if e[0].startswith("CUDA graph capture")]


def http_json(url, payload=None, timeout=120):
    """(status, JSON reply, body bytes) of a GET (payload None) or POST."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as r:
            body = r.read()
            return r.status, json.loads(body), len(body)
    except urllib.error.HTTPError as e:
        body = e.read()
        return e.code, json.loads(body), len(body)


def model_outs(m, x0, **kw):
    return [None if o is None else o.cpu().numpy()
            for o in m.predict(x0, **kw)]


def count_sum(counts):
    """The sum of fitc_counts() readings."""
    return {k: tuple(tuple(map(sum, zip(*(c[k][i] for c in counts))))
                     for i in range(2)) for k in counts[0]}


def phase_serve(dev, card, x, y, xte, free_np, m6):
    """Phase 12: the port's PredictServer at config 4 on captured CUDA
    graphs, and over phase 11's config-6 'fast' FITC model m6.  A replay
    runs no Python, so the launches counted are the server's own: every
    count is set to 0 just before each server's construction, reload or
    first fullcov call and read just after it, with no reference or
    baseline call inside.  Each model's aux is built by its reference
    predict before that.  Returns ({kind: ((gram f64, ...), (gram f32,
    ...))} launches, timings)."""
    import threading
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.serve import PredictServer
    from lcgp_tpu_torch.utils.profiling import log_compiles

    tag = f"[{card}]"
    out = {}
    windows = []
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()

    def own(label, make):
        """make() with every count set to 0 just before it and read just
        after: the launches of one capture and its eager warm step."""
        reset_all_counts()
        res = make()
        c = fitc_counts()
        windows.append(c)
        grams = {k: (v[0][0], v[1][0]) for k, v in c.items()
                 if v[0][0] or v[1][0]}
        say(f"    {label}: Gram launches (f64, f32) {grams}")
        return res

    def model_of(free, **kw):
        m = LCGP(y, x, q=20, device=dev, **kw)
        m.free = free_params_from_numpy(*free, dev)
        return m

    m = model_of(free_np)
    d = x.shape[1]
    say("  -- 1. a server at batch_size=256 over the committed fit")
    x300 = np.concatenate([xte, xte[:44]])
    cases = [(n0, xr, model_outs(m, xr, batch_size=256), model_outs(m, xr))
             for n0, xr in ((64, xte[:64]), (256, xte), (300, x300))]
    with log_compiles() as events:
        t0 = time.perf_counter()
        srv = own("PredictServer(batch_size=256)",
                  lambda: PredictServer(m, batch_size=256, warmup=False))
        out["construct_s"] = time.perf_counter() - t0
    caps = captures_in(events)
    check(len(caps) == 1, f"the server captured {len(caps)} graphs")
    out["capture_s"] = caps[0][1]
    say(f"  PredictServer(batch_size=256): {out['construct_s']:.3f} s "
        f"(state snapshot with the aux, one eager step, the capture); "
        f"capture {out['capture_s'] * 1e3:.1f} ms {tag}")
    for n0, xr, ref, raw in cases:
        got = srv.predict(xr)
        for name, g, r in zip(("ypred", "ypredvar", "yconfvar"), got, ref):
            check(g.shape == (y.shape[0], n0), f"{name} shape {g.shape}")
            compare_np(f"server {n0}-point {name} vs model.predict("
                       "batch_size=256)", g, r, 1e-10)
        rel = max(float(np.max(np.abs(g - r) / np.maximum(np.abs(r),
                                                          1e-300)))
                  for g, r in zip(got, raw))
        say(f"    ({n0} points against the unbatched model.predict: max "
            f"rel {rel:.3e})")
    del cases
    fn = srv._live
    batch = pad_rows(xte[:64], 256)
    got, ref = fn(batch), fn.eager(batch)
    equal = all(np.array_equal(g, r) for g, r in zip(got, ref))
    for name, g, r in zip(("ypred", "ypredvar", "yconfvar"), got, ref):
        compare_normwise(f"replay vs eager fused step, {name}",
                         torch.as_tensor(g), torch.as_tensor(r), 1e-12)
    say(f"  replay bits equal to the eager step's: {equal}")
    out["replay_bits_equal_eager"] = equal
    out["dispatch_device_ms"], names = replay_profile(
        "one dispatch (copy in, replay, copy out)", lambda: fn(batch))
    check_gram_in(names, "matern32", "a profiled replay")
    out["replay_ms"] = cuda_ms(lambda: fn.graph.replay())
    say(f"  one dispatch: {out['dispatch_device_ms']:.3f} ms device time; "
        f"the graph alone {out['replay_ms']:.3f} ms (CUDA events) {tag}")

    say("  -- 2. single client, 64-point requests, "
        f"{SERVE_REQUESTS} each (host clock, results on the host)")
    x64 = xte[:64]
    lat = {}
    for bs, server in ((256, srv), (64, None)):
        if server is None:
            with log_compiles() as events:
                server = own("PredictServer(batch_size=64)",
                             lambda: PredictServer(m, batch_size=64,
                                                   warmup=False))
            check(len(captures_in(events)) == 1, "batch-64 server capture")
        sfn = server._fn
        lat[f"graph_{bs}"] = latency_ms(lambda: server.predict(x64))
        lat[f"eager_{bs}"] = latency_ms(
            lambda: sfn.eager(pad_rows(x64, bs)))
        if bs == 64:
            out["dispatch_64_device_ms"], _ = replay_profile(
                "one batch-64 dispatch", lambda: sfn(x64))
            out["replay_64_ms"] = cuda_ms(lambda: sfn.graph.replay())
            say(f"  batch-64 dispatch: {out['dispatch_64_device_ms']:.3f} "
                f"ms device time; the graph alone {out['replay_64_ms']:.3f}"
                f" ms (CUDA events) {tag}")
            server.shutdown()
            check(not server._dispatcher.is_alive(), "dispatcher alive")
            del server, sfn
            torch.cuda.empty_cache()
    lat["model_predict_64"] = latency_ms(
        lambda: [o.cpu() for o in m.predict(x64, batch_size=64)])
    for k, v in lat.items():
        p50, p95 = p50_p95(v)
        out[f"latency_{k}_p50_ms"], out[f"latency_{k}_p95_ms"] = p50, p95
        say(f"  64-point request, {k}: p50 {p50:.3f} ms, p95 {p95:.3f} ms "
            f"{tag}")

    say(f"  -- 3. {len(SERVE_SIZES)} concurrent clients, sizes "
        f"{SERVE_SIZES}, {SERVE_ROUNDS} rounds")
    rng = np.random.default_rng(12)
    inputs = [rng.uniform(0, 1, (s, d)) for s in SERVE_SIZES]
    expect = [model_outs(m, xi, batch_size=256) for xi in inputs]
    lats, answers, errors = [[] for _ in inputs], [[] for _ in inputs], []

    def client(i):
        try:
            for _ in range(SERVE_ROUNDS):
                t0 = time.perf_counter()
                answers[i].append(srv.predict(inputs[i]))
                lats[i].append((time.perf_counter() - t0) * 1e3)
        except Exception as e:          # noqa: BLE001
            errors.append(repr(e))
    calls0 = fn.calls
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(inputs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    wall = time.perf_counter() - t0
    dispatches = fn.calls - calls0
    check(not errors and not any(t.is_alive() for t in threads),
          f"concurrent clients failed: {errors}")
    worst = 0.0
    for i, outs in enumerate(answers):
        for got in outs:
            for g, r in zip(got, expect[i]):
                check(np.allclose(g, r, rtol=1e-10, atol=0),
                      f"a concurrent answer of size {SERVE_SIZES[i]} differs")
                worst = max(worst, float(np.max(
                    np.abs(g - r) / np.maximum(np.abs(r), 1e-300))))
    chunks = len(inputs) * SERVE_ROUNDS
    flat = [v for li in lats for v in li]
    p50, p95 = p50_p95(flat)
    single = out["latency_graph_256_p50_ms"]
    out.update(concurrent_p50_ms=p50, concurrent_p95_ms=p95,
               concurrent_dispatches=dispatches, concurrent_chunks=chunks,
               concurrent_wall_s=wall)
    say(f"  concurrent: p50 {p50:.3f} ms, p95 {p95:.3f} ms, p95 / "
        f"single-client p50 {p95 / single:.2f}; {dispatches} dispatches for "
        f"{chunks} chunks in {wall:.3f} s; every answer within rtol 1e-10 "
        f"(max rel {worst:.3e}) {tag}")
    check(dispatches < chunks, f"{dispatches} dispatches for {chunks} "
          "chunks: no coalescing")

    say("  -- 4. reload: the committed fit with lLmb0 shifted (same shapes), "
        "then kernel='rbf'")
    free2 = (free_np[0], free_np[1] - 0.5, free_np[2], free_np[3])
    m2 = model_of(free2)
    refs = [model_outs(mm, x64, batch_size=256) for mm in (m, m2)]
    check(not np.allclose(refs[0][0], refs[1][0]), "the shifted fit "
          "predicts the same")
    stop = threading.Event()
    seen, errors = [], []

    def fire():
        try:
            while not stop.is_set():
                seen.append(srv.predict(x64))
        except Exception as e:          # noqa: BLE001
            errors.append(repr(e))
    # the reload's own peak: both models' aux (m2's built by its reference
    # above) and the server's state are alive through it
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated()
    out["reload_base_gb"] = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    bg = threading.Thread(target=fire)
    bg.start()
    time.sleep(0.05)
    with log_compiles() as events:
        t0 = time.perf_counter()
        rep = own("same-shape reload", lambda: srv.reload(m2))
        out["reload_same_ms"] = (time.perf_counter() - t0) * 1e3
    out["peak_gb_two_states"] = torch.cuda.max_memory_allocated() / 1e9
    peak = max(peak, torch.cuda.max_memory_allocated())
    time.sleep(0.05)
    stop.set()
    bg.join(timeout=60)
    check(not bg.is_alive() and not errors, f"a request failed during the "
          f"reload: {errors}")
    which = []
    for got in seen:
        hit = [k for k, r in enumerate(refs)
               if all(np.allclose(g, rr, rtol=1e-10, atol=0)
                      for g, rr in zip(got, r))]
        check(len(hit) == 1, "an answer during the reload is neither the "
              "old model's nor the new one's")
        which.append(hit[0])
    check(which == sorted(which), "an old answer came after a new one")
    say(f"  same-shape reload: reused_executable {rep['reused_executable']}, "
        f"captures {len(captures_in(events))}, warmup_secs "
        f"{rep['warmup_secs']}, {out['reload_same_ms']:.1f} ms; "
        f"{len(seen)} requests during it ({which.count(0)} old, "
        f"{which.count(1)} new), none failed {tag}")
    check(rep["reused_executable"] is True and not captures_in(events),
          "the same-shape reload was not reused or captured a graph")
    for name, g, r in zip(("ypred", "ypredvar", "yconfvar"),
                          srv.predict(x64), refs[1]):
        compare_np(f"after the reload, {name} vs the new model", g, r, 1e-10)
    say(f"  peak device memory during the same-shape reload (both models' "
        f"aux and the server's state alive): {out['peak_gb_two_states']:.3f}"
        f" GB, {out['reload_base_gb']:.3f} GB allocated before it {tag}")
    del m2, refs
    m3 = model_of(free_np, kernel="rbf")
    ref3 = model_outs(m3, x64, batch_size=256)
    with log_compiles() as events:
        t0 = time.perf_counter()
        rep = own("kernel='rbf' reload", lambda: srv.reload(m3))
        out["reload_rbf_ms"] = (time.perf_counter() - t0) * 1e3
    say(f"  kernel='rbf' reload: reused_executable "
        f"{rep['reused_executable']}, captures {len(captures_in(events))}, "
        f"{out['reload_rbf_ms']:.1f} ms {tag}")
    check(rep["reused_executable"] is False and
          len(captures_in(events)) == 1, "the rbf reload reused the graph")
    for name, g, r in zip(("ypred", "ypredvar", "yconfvar"),
                          srv.predict(x64), ref3):
        compare_np(f"rbf server {name} vs model.predict", g, r, 1e-10)
    fn = srv._live
    _, names = replay_profile("one rbf dispatch",
                              lambda: fn(pad_rows(x64, 256)))
    check_gram_in(names, "rbf", "a profiled replay after the rbf reload")
    del m3, ref3

    say("  -- 5. fullcov through a server at batch_size=8")
    x8 = xte[:8]
    ref = model_outs(m, x8, return_fullcov=True)
    srv8 = own("PredictServer(batch_size=8)",
               lambda: PredictServer(m, batch_size=8, warmup=False))
    t0 = time.perf_counter()
    got = own("the first fullcov request",
              lambda: srv8.predict_fullcov(x8))
    out["fullcov_first_s"] = time.perf_counter() - t0
    for name, g, r in zip(("ypred", "ypredvar", "yconfvar", "fullcov"),
                          got, ref):
        compare_np(f"fullcov server {name} vs model.predict("
                   "return_fullcov=True)", g, r, 1e-8, 1e-12)
    out["fullcov_ms"] = statistics.median(latency_ms(
        lambda: srv8.predict_fullcov(x8), n=5))
    say(f"  8-point fullcov: first {out['fullcov_first_s']:.3f} s (with its "
        f"capture), warm median {out['fullcov_ms']:.3f} ms {tag}")
    xr, yr, _ = rep_problem(5, 60, 3, 4, 8, 3)
    mr = LCGP(yr, xr, q=2, submethod="rep", device=dev)
    srv_rep = PredictServer(mr, batch_size=8, warmup=False)
    try:
        srv_rep.predict_fullcov(xr[:3])
        check(False, "a rep model's fullcov did not raise")
    except ValueError as e:
        say(f"  rep model's fullcov raises: {e}")
    srv_rep.shutdown()

    say("  -- 6. FITC: phase 11's config-6 'fast' model (n=50,000, m=256)")
    _, _, xte6, _, _ = fitc_config(6)
    ref, raw = model_outs(m6, xte6, batch_size=256), model_outs(m6, xte6)
    srv6 = own("FITC PredictServer(batch_size=256)",
               lambda: PredictServer(m6, batch_size=256, warmup=False))
    got = srv6.predict(xte6)
    for name, g, r in zip(("ypred", "ypredvar", "yconfvar"), got, ref):
        compare_np(f"FITC server {name} vs its predict(batch_size=256)",
                   g, r, 1e-6)
    rel = max(float(np.max(np.abs(g - r) / np.maximum(np.abs(r), 1e-30)))
              for g, r in zip(got, raw))
    say(f"    (against the unbatched predict: max rel {rel:.3e})")
    f6 = srv6._live
    dev6, names = replay_profile("one FITC dispatch",
                                 lambda: f6(pad_rows(xte6[:64], 256)))
    check_gram_in(names, "matern32", "a profiled FITC replay (Knm)")
    out["fitc_dispatch_device_ms"] = dev6
    out["fitc_latency_p50_ms"] = p50_p95(latency_ms(
        lambda: srv6.predict(xte6[:64])))[0]
    say(f"  FITC 64-point request p50 {out['fitc_latency_p50_ms']:.3f} ms, "
        f"dispatch device time {dev6:.3f} ms {tag}")
    srv6.shutdown()
    del m6, srv6, f6

    say("  -- 7. HTTP on 127.0.0.1 (port 0)")
    httpd, _ = srv.serve(port=0, background=True)
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    code, body, _ = http_json(base + "/healthz")
    check(code == 200 and body == {"status": "ok"}, f"/healthz {code}")
    code, info, _ = http_json(base + "/info")
    check(code == 200 and info["p"] == y.shape[0] and info["kernel"] == "rbf"
          and info["reload_count"] == 2, f"/info {code} {info}")
    inproc = srv.predict(x64)
    http_ms, size = [], 0
    for _ in range(5):
        t0 = time.perf_counter()
        code, body, size = http_json(base + "/predict", {"x": x64.tolist()})
        http_ms.append((time.perf_counter() - t0) * 1e3)
        check(code == 200, f"/predict {code}")
    for key, g in zip(("ypred", "ypredvar", "yconfvar"), inproc):
        check(np.array_equal(np.asarray(body[key]), g),
              f"HTTP {key} differs from the in-process answer")
    out["http_64_ms"] = statistics.median(http_ms)
    say(f"  /healthz, /info; 64-point /predict equal to the in-process "
        f"answer: median {out['http_64_ms']:.2f} ms of 5 ({size} bytes) "
        f"{tag}")
    code, body, _ = http_json(base + "/reload", {"path": "m.npz"})
    check(code == 403, f"/reload without reload_dir answered {code}")
    httpd8, _ = srv8.serve(port=0, background=True)
    t0 = time.perf_counter()
    code, body, size = http_json(
        f"http://127.0.0.1:{httpd8.server_address[1]}/predict",
        {"x": x8.tolist(), "fullcov": True}, timeout=300)
    out["http_fullcov_8_s"] = time.perf_counter() - t0
    check(code == 200, f"fullcov /predict {code}")
    check(np.array_equal(np.asarray(body["yfullcov"]),
                         srv8.predict_fullcov(x8)[3]),
          "HTTP fullcov differs from the in-process answer")
    say(f"  /reload 403 by default; 8-point fullcov /predict "
        f"{out['http_fullcov_8_s']:.3f} s ({size / 1e6:.1f} MB of JSON) "
        f"{tag}")
    for server in (srv, srv8):
        server.shutdown()
        check(not server._dispatcher.is_alive(), "a dispatcher is alive "
              "after shutdown()")
    counts = count_sum(windows)
    say(f"  phase 12 server launches (Gram, VJP, K5) f64 / f32, each "
        f"capture and its eager warm step: {counts}")
    out["peak_gb"] = max(peak, torch.cuda.max_memory_allocated()) / 1e9
    say(f"  phase 12 peak device memory {out['peak_gb']:.3f} GB {tag}")
    del srv, srv8, m
    torch.cuda.empty_cache()
    say(f"  phase 12 timings JSON: {json.dumps(out)}")
    return counts, out


# Phase 13: the mesh paths.  The four ranks that share the card cut n to
# MESH_CUT_N when one of their loss+grad evaluations takes over MESH_CUT_S.
MESH_RANKS = 4
MESH_CUT_S = 60.0
MESH_CUT_N = 2048
# the 4-rank run's meshes: ('n',) 4, ('comp','n') 2x2, ('comp','out') 2x2
MESH_SPECS = (("n", 4), ("nc", 2, 2), ("co", 2, 2))


def flat_vg(loss_fn, free):
    """(vg, z0, flattener): one loss+grad evaluation as the fit drivers
    take it, at the flat free parameters z0."""
    from lcgp_tpu_torch.fit._flat import Flattener
    from lcgp_tpu_torch.fit.scipy_lbfgs import value_and_grad
    flat = Flattener(free)
    return value_and_grad(loss_fn, flat), flat.ravel(free).cpu().numpy(), flat


def check_vg(name, got, ref, flat):
    """A mesh loss (rtol 1e-9) and flat gradient (each leaf within
    GRAD_RTOL of its max |g|) against one device's."""
    import torch
    (v, g), (vr, gr) = got, ref
    rel = abs(v - vr) / abs(vr)
    say(f"  {name}: loss {v:.12e} vs one device {vr:.12e}, rel {rel:.3e} "
        "(bound 1e-9)")
    check(rel <= 1e-9, f"{name}: loss differs from one device")
    compare_grads(name, torch.as_tensor(g), torch.as_tensor(gr), flat,
                  GRAD_RTOL)


class MeshCounts:
    """K1 and K2 launches on the mesh paths, apart from the one-device
    references beside them, by the shape they run at: ``by_shape`` maps a
    key (mode, q, n1, n2) to [K1, K2].  Mode 'rows' is K1 in cross mode at
    a rank's Gram rows (q, n1, n2) and K2 at their explicit cotangent,
    'square' the same-point K1 and the fused K2 of an ('comp','out') mesh,
    'predict' K1 at a request's cross-covariance."""

    def __init__(self):
        self.by_shape = {}

    def add(self, key, k1, k2):
        c = self.by_shape.setdefault(key, [0, 0])
        c[0] += k1
        c[1] += k2

    def call(self, key, fn):
        f = family_of("matern32")
        a, b = f.gram.launches, f.vjp.launches
        out = fn()
        self.add(key, f.gram.launches - a, f.vjp.launches - b)
        return out

    def total(self):
        return tuple(sum(c[i] for c in self.by_shape.values())
                     for i in (0, 1))


def mesh_shape_label(key):
    mode, q, n1, n2 = key
    what = {"rows": "Gram rows and their cotangent, cross mode",
            "square": "square Gram and fused VJP",
            "predict": "64-point cross-covariance"}[mode]
    return f"{what} ({q}, {n1}, {n2})"


def rank_keys(spec, n, q=20, n0=64):
    """The MeshCounts keys of a rank of ``spec`` at n: its loss+grad and
    aux (and fit), and its predict."""
    kind, a, *b = spec
    if kind == "co":
        return ("square", -(-q // a), n, n), None
    qc, nb = (q, -(-n // a)) if kind == "n" else (-(-q // a), -(-n // b[0]))
    return ("rows", qc, nb, n), ("predict", qc, n0, nb)


def phase_mesh_one_rank(dev, card, x, y, xte, free_np, counts):
    """Phase 13, part 1: a world of one NCCL rank on the card, in this
    process.  Returns the (K1, K2) launches of one mesh loss+grad and the
    memory one takes beyond what was allocated before it (its peak less
    the resident bytes), the yardstick of the four ranks'."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.parallel import init_distributed, nshard
    from lcgp_tpu_torch.parallel import mesh as mesh_mod

    tag = f"[{card}]"
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    init_distributed("nccl", dev, rank=0, world_size=1,
                     store=dist.FileStore(os.path.join(store, "s"), 1))
    try:
        nmesh = nshard.make_n_mesh(device=dev)
        say(f"  one NCCL rank: {nmesh}")
        single = LCGP(y, x, q=20, device=dev)
        meshed = LCGP(y, x, q=20, device=dev)
        meshed.set_mesh(nmesh)
        fitted = free_params_from_numpy(*free_np, dev)
        mesh_loss = nshard.make_loss("full", single._data, nmesh)
        rows, pred = rank_keys(("n", 1), x.shape[0])
        square = rank_keys(("co", 1, 1), x.shape[0])[0]
        for label, free in (("init", single.free), ("committed fit", fitted)):
            vg_s, z0, flat = flat_vg(single._loss_fn(), free)
            vg_m = flat_vg(mesh_loss, free)[0]
            check_vg(f"('n',) 1 rank at the {label}", counts.call(
                rows, lambda: vg_m(z0)), vg_s(z0), flat)
        per_call = launches_of(lambda: counts.call(rows, lambda: vg_m(z0)))
        say(f"  (K1, K2) launches of one mesh loss+grad: {per_call}")
        check(per_call == (1, 1), f"a mesh loss+grad launched {per_call}")
        t_s = [timed_s(lambda: vg_s(z0)) for _ in range(3)]
        t_m = [timed_s(lambda: counts.call(rows, lambda: vg_m(z0)))
               for _ in range(3)]
        say(f"  {tag} warm loss+grad at the committed fit: mesh "
            f"{statistics.median(t_m):.4f} s, one device "
            f"{statistics.median(t_s):.4f} s (medians of 3)")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        counts.call(rows, lambda: vg_m(z0))
        peak = torch.cuda.max_memory_allocated()
        say(f"  {tag} peak memory of the mesh loss+grad: {peak / 1e9:.3f} "
            f"GB ({resident / 1e9:.3f} GB resident before it)")

        single.free, meshed.free = fitted, fitted
        x0 = xte[:64]
        ref = single.predict(x0)
        t0 = time.perf_counter()
        counts.call(rows, meshed.compute_aux_predictive_quantities)
        torch.cuda.synchronize()
        say(f"  {tag} mesh aux: {time.perf_counter() - t0:.4f} s")
        compare_normwise("('n',) 1 rank LBs vs one device", meshed.LBs,
                         single.LBs, 1e-9)
        got = counts.call(pred, lambda: meshed.predict(x0))
        for name, a, b in zip(("ypred", "ypredvar", "yconfvar"), got, ref):
            compare_normwise(f"('n',) 1 rank 64-point {name}", a, b, 1e-7)
        req = [timed_s(lambda: counts.call(pred, lambda: meshed.predict(x0)))
               for _ in range(5)]
        say(f"  {tag} mesh 64-point request: "
            f"{statistics.median(req) * 1e3:.3f} "
            f"ms (median of 5)")
        del meshed, ref, got

        rbf = LCGP(y, x, q=20, kernel="rbf", device=dev)
        vg_s, z0, flat = flat_vg(rbf._loss_fn(), rbf.free)
        vg_m = flat_vg(nshard.make_loss("full", rbf._data, nmesh,
                                        kernel="rbf"), rbf.free)[0]
        f4 = family_of("rbf")
        k4 = f4.gram.launches, f4.vjp.launches
        check_vg("('n',) 1 rank, kernel='rbf'", vg_m(z0), vg_s(z0), flat)
        k4 = f4.gram.launches - k4[0], f4.vjp.launches - k4[1]
        check(k4 == (2, 2), f"K4's Gram and VJP launched {k4} in the mesh "
              "and one-device loss+grad, expected one each")
        del rbf

        comesh = mesh_mod.make_mesh(1, 1, device=dev)
        vg_s, z0, flat = flat_vg(single._loss_fn(), single.free)
        vg_c = flat_vg(mesh_mod.make_sharded_loss(comesh, single._data),
                       single.free)[0]
        check_vg("('comp','out') 1x1", counts.call(square, lambda: vg_c(z0)),
                 vg_s(z0), flat)

        fit = LCGP(y, x, q=20, device=dev)
        got = launches_of(lambda: counts.call(
            rows, lambda: fit.fit(mesh=nmesh, method="scipy", maxiter=5)))
        nfev = int(fit._fit_result.nfev)
        say(f"  fit(mesh=('n',) 1 rank, method='scipy', maxiter=5): loss "
            f"{fit._fit_result.fun:.10g}, nfev {nfev}, (K1, K2) launches "
            f"{got}")
        check(got == (nfev, nfev), "the mesh fit did not launch K1 and K2 "
              "once per evaluation")
        return per_call, peak - resident
    finally:
        dist.destroy_process_group()


def phase_mesh_block_kernels(dev, card, xs):
    """Phase 13, part 1: K1 in cross mode at the ('n',) 4 block shape
    (20, 1024, 4096, d=8, f64), a rank's Gram rows, and K2 in cross mode at
    a random cotangent of that shape, against their plain versions, timed in
    turns with their bounds.  Returns the two kernel records."""
    import torch
    from lcgp_tpu_torch.ops._build import build
    lib = build().lib
    fam = family_of("matern32")
    q, n, d = 20, xs.shape[0], xs.shape[1]
    nb = n // MESH_RANKS
    size = 8
    ls, amp, nug = moderate_params(np.random.default_rng(41), q, d, dev,
                                   torch.float64)
    xblk = xs[nb:2 * nb].contiguous()
    M = torch.randn((q, nb, n), generator=torch.Generator(
        device=dev).manual_seed(42), dtype=torch.float64, device=dev)
    ins = (xblk.numel() + xs.numel() + ls.numel() + 2 * q) * size
    err_g = compare(f"K1 block rows (q={q}, nb={nb}, n={n}) vs plain",
                    fam.launch(xblk, xs, ls, amp, nug, same=False)[0],
                    fam.plain(xblk, xs, ls, amp, nug, same=False),
                    F64_RTOL, F64_ATOL)
    t_g = time_pair(f"K1 block rows (q={q} nb={nb} n={n})",
                    raw_gram(lib, xblk, xs, ls, amp, nug, False),
                    lambda: fam.plain(xblk, xs, ls, amp, nug, same=False),
                    q * nb * n * size, plain_reps=3)
    b_g = say_bound("K1 block rows", t_g[0], q * nb * n * size + ins,
                    q * nb * n * k1_ops_per_entry(d, False))
    got = fam.launch_vjp(xblk, xs, ls, amp, nug, same=False, M=M)
    again = fam.launch_vjp(xblk, xs, ls, amp, nug, same=False, M=M)
    ref = fam.vjp_plain(xblk, xs, ls, amp, nug, same=False, cbar=M)
    scale = fam.scale(xblk, xs, ls, amp, nug, same=False, cbar=M)
    torch.cuda.synchronize()
    check(all(torch.equal(u, v) for u, v in zip(got, again)),
          "K2 at the block shape: two launches differ")
    err_v = compare_vjp(f"K2 cross mode at a random block cotangent "
                        f"(q={q}, nb={nb}, n={n}) vs plain; two launches the "
                        "same bits", got, ref, scale, kernel="K2")
    t_v = time_pair(f"K2 block cotangent (q={q} nb={nb} n={n})",
                    raw_vjp(lib, xblk, ls, amp, nug, M, None, 0.0, None,
                            x2=xs),
                    lambda: fam.vjp_plain(xblk, xs, ls, amp, nug,
                                          same=False, cbar=M),
                    M.numel() * size, "read", plain_reps=3)
    b_v = say_bound("K2 block cotangent", t_v[0],
                    M.numel() * size + ins + q * (d + 2) * size,
                    q * nb * n * (k2_ops_per_entry(d) - 2))
    shape = f"('n',) {MESH_RANKS} block f64 q={q} nb={nb} n={n} d={d}"
    say(f"  [{card}] at the {shape}: K1 {t_g[0]:.4f} ms (plain "
        f"{t_g[1]:.4f}, bound {b_g[0]:.4f}), K2 {t_v[0]:.4f} ms (plain "
        f"{t_v[1]:.4f}, bound {b_v[0]:.4f})")
    return [dict(name="matern32_gram_block", route="cuda", source=K1_SOURCE,
                 replaces=K1_REPLACES, max_abs_err=err_g, ms=t_g[0],
                 plain_ms=t_g[1], bound_ms=b_g[0], bound_by=b_g[1],
                 library_ms=None, shape=f"Gram rows {shape}"),
            dict(name="matern32_gram_vjp_block", route="cuda",
                 source=K2_SOURCE, replaces=K2_REPLACES, max_abs_err=err_v,
                 ms=t_v[0], plain_ms=t_v[1], bound_ms=b_v[0],
                 bound_by=b_v[1], library_ms=None,
                 shape=f"random cross cotangent {shape}")]


def mesh_reference(dev, x, y, x0, free):
    """One device's loss, flat gradient, factor and predictions at the
    free parameters, to host, for the ranks' answers."""
    import torch
    from lcgp_tpu_torch import LCGP
    m = LCGP(y, x, q=20, device=dev)
    m.free = free
    vg, z0, flat = flat_vg(m._loss_fn(), m.free)
    v, g = vg(z0)
    ref = dict(loss=v, grad=g, flat=flat, LB=m.LBs.cpu().numpy(),
               predict=[t.cpu().numpy() for t in m.predict(x0)])
    del m
    torch.cuda.empty_cache()
    return ref


def check_rank(spec, r, ref, n):
    """A rank's answers against one device: loss and gradient, the sampled
    factor rows (1e-9 of the largest entry) and the predictions (1e-7 of
    each output's largest entry)."""
    import torch
    tag = f"{spec} rank {r['rank']}"
    check_vg(tag, (r["loss"], r["grad"]), (ref["loss"], ref["grad"]),
             ref["flat"])
    if "factor" in r:
        a, b = r["factor_comps"]
        got = torch.as_tensor(r["factor"])
        want = torch.as_tensor(ref["LB"][a:b][:, r["factor_rows"], :n])
        if got.numel():
            compare_normwise(f"{tag} sampled LBs rows", got, want, 1e-9)
        for name, u, v in zip(("ypred", "ypredvar", "yconfvar"),
                              r["predict"], ref["predict"]):
            compare_normwise(f"{tag} 64-point {name}", torch.as_tensor(u),
                             torch.as_tensor(v), 1e-7)


def phase_mesh_shared(dev, card, x, y, xte, free_np, peak1, counts):
    """Phase 13, part 2: MESH_RANKS gloo ranks that compute on one card,
    their collectives staged through the host, at config 4 on MESH_SPECS;
    the memory one loss+grad takes on a rank at ('n',) MESH_RANKS (its
    peak less its resident bytes) under half of ``peak1``, the same at
    ('n',) 1 (part 1's NCCL rank, or at a cut n a rank of the group).
    Adds the ranks' K1 and K2 launches to ``counts`` by shape; returns the
    (K1, K2) launches of one loss+grad on a rank at ('n',) MESH_RANKS and
    whether n was cut."""
    import torch
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.parallel import WorkerGroup, tasks
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    say(f"  compute mode: {mode}")
    check(mode == "Default", f"{MESH_RANKS} contexts on one card need "
          f"compute mode Default, not {mode}")
    fitted = free_params_from_numpy(*free_np, dev)
    free = [t.cpu().numpy() for t in fitted]
    x0 = xte[:64]
    n = x.shape[0]
    torch.cuda.empty_cache()
    with WorkerGroup(MESH_RANKS, device=str(dev), backend="gloo",
                     timeout=1200, collective_timeout=900) as group:

        def run(spec, n, fit=None):
            res = [r for r in group.run(
                tasks.measure, spec, x[:n], y[:, :n], dict(q=20), free, x0,
                device=str(dev), fit=fit) if r is not None]
            key, pred = rank_keys(spec, n)
            for r in res:
                p = r.get("launches_predict", (0, 0))
                counts.add(key, *(t - u for t, u in
                                  zip(r["launches_total"], p)))
                if pred is not None:
                    counts.add(pred, *p)
            peaks[spec] = max(r["peak_bytes"] - r["resident_bytes"]
                              for r in res)
            return res

        ref, peaks, cut = mesh_reference(dev, x, y, x0, fitted), {}, False
        for spec in MESH_SPECS:
            fit = dict(method="scipy", maxiter=2) if spec[0] == "co" else None
            res = run(spec, n, fit)
            first = max(r["first_s"] for r in res)
            if spec == ("n", MESH_RANKS) and first > MESH_CUT_S:
                say(f"  CUT: one ('n',) {MESH_RANKS} loss+grad took "
                    f"{first:.1f} s > {MESH_CUT_S:g} s; the {MESH_RANKS}-rank "
                    f"run goes on at n={MESH_CUT_N}")
                n, cut = MESH_CUT_N, True
                ref = mesh_reference(dev, x[:n], y[:, :n], x0, fitted)
                # the memory yardstick at the cut n: one rank of the group
                for r in run(("n", 1), n):
                    check_rank(("n", 1), r, ref, n)
                peak1 = peaks[("n", 1)]
                res = run(spec, n)
            for r in res:
                check_rank(spec, r, ref, n)
                check(r["launches"] == (1, 1), f"{spec} rank {r['rank']}: "
                      f"one loss+grad launched {r['launches']}")
            if spec == ("n", MESH_RANKS):
                per_rank = res[0]["launches"]
            say(f"  [{card}] {spec} at n={n}: loss+grad first "
                f"{max(r['first_s'] for r in res):.3f} s, warm "
                f"{max(r['warm_s'] for r in res):.3f} s (slowest rank); "
                "staged per loss+grad "
                + ", ".join(f"{r['staged_bytes'] / 1e9:.3f}" for r in res)
                + " GB; peak "
                + ", ".join(f"{r['peak_bytes'] / 1e9:.3f}" for r in res)
                + " GB (resident "
                + ", ".join(f"{r['resident_bytes'] / 1e9:.3f}" for r in res)
                + " GB)"
                + ("" if "aux_s" not in res[0] else
                   f"; aux {max(r['aux_s'] for r in res):.3f} s, 64-point "
                   f"request {max(r['request_s'] for r in res) * 1e3:.1f} "
                   "ms"))
            if fit is not None:
                for r in res[1:]:
                    for u, v in zip(r["fit_free"], res[0]["fit_free"]):
                        check(np.array_equal(u, v), f"{spec}: the ranks' "
                              "fitted parameters differ")
                say(f"  fit(mesh={spec}, method='scipy', maxiter=2): every "
                    f"rank's parameters the same bits ({res[0]['fit_nfev']} "
                    "evaluations)")
        share = peaks[("n", MESH_RANKS)] / peak1
        mem = peaks[("n", MESH_RANKS)]
        say(f"  [{card}] one loss+grad's memory (peak less resident) on a "
            f"rank at ('n',) {MESH_RANKS}: {mem / 1e9:.3f} GB, "
            f"{share:.3f} of the same code's at ('n',) 1 "
            f"({peak1 / 1e9:.3f} GB, "
            + (f"one rank of the group at n={n})" if cut else "part 1)"))
        check(share < 0.5, "the ('n',) per-rank memory is not under half "
              "the world-of-one memory")
    return per_rank, cut


# ---------------------------------------------------------------------------
# Phase 14: n-sharded FITC (parallel/fitc_shard.py) at config 7 and served
# mesh models (serve.py's follow())
# ---------------------------------------------------------------------------

FITC_MESH_RANKS = 4
# the 4-rank run's meshes: ('n',) 4 and ('comp','n') 2x2
FITC_MESH_SPECS = (("n", 4), ("nc", 2, 2))
FITC_MESH_REFINE_STEPS = 5
SERVE_MESH_REQUESTS = 30
# 'fast' (f32 panel work): the one-rank refine's loss within this of one
# device's (relative)
FITC_MESH_RTOL = 1e-5
# the same loss+grad in f64 on the four ranks against one device's f64:
# the loss relative, each gradient leaf as a share of its max |g| (the
# sums reordered over n; 'fast''s error shows M = I + G amplifying its
# rounding some thousand times at config 7's init)
FITC_MESH_F64_LOSS_RTOL = 1e-9
FITC_MESH_F64_GRAD_RTOL = 1e-7
# the kernel rows the phase's launches are filed on: the FITC rows of
# phase 11 by dtype, and at the ('n',) 4 block's f32 shape the block rows
FITC_ROWS_F64 = ("matern32_gram_fitc", "matern32_gram_vjp_fitc",
                 "matern32_gram_vjp_x")
FITC_ROWS_F32 = tuple(f"{r}_f32" for r in FITC_ROWS_F64)
FITC_ROWS_BLOCK = ("matern32_gram_fitc_block",
                   "matern32_gram_vjp_fitc_block", "gram_vjp_x_fitc_block")
# the one NCCL rank's f32 launches at config 7's one-device panel
FITC_ROWS_7_MESH = (*FITC_ROWS_7, FITC_ROWS_F32[2])


class FitcMeshCounts:
    """Phase 14's launches on the main path by kernel row and shape:
    ``rows`` maps a row name to {shape label: launches}.  A delta is
    ``tasks._fitc_launches``' six counts, (Gram, VJP, K5) f64 then f32."""

    def __init__(self):
        self.rows = {}

    def add(self, row, label, n):
        if n:
            by = self.rows.setdefault(row, {})
            by[label] = by.get(label, 0) + n

    def add_fitc(self, delta, f64_label, f32_label, f32_rows=FITC_ROWS_F32):
        for i in range(3):
            self.add(FITC_ROWS_F64[i], f64_label, delta[2 * i])
            self.add(f32_rows[i], f32_label, delta[2 * i + 1])

    def call(self, f64_label, f32_label, fn, f32_rows=FITC_ROWS_F32):
        from lcgp_tpu_torch.parallel.tasks import _fitc_launches
        before = _fitc_launches("matern32")
        out = fn()
        self.add_fitc(tuple(b - a for a, b in
                            zip(before, _fitc_launches("matern32"))),
                      f64_label, f32_label, f32_rows)
        return out

    def total(self, row):
        return sum(self.rows.get(row, {}).values())


def fitc7_inputs():
    """Config 7's data, a 64-point request and its inducing points in x's
    units: the farthest-point rows of the standardized design, chosen once
    here so that every model of the phase takes the same bits."""
    from lcgp_tpu_torch.models.sparse import select_inducing
    x, y, xte, _, kw = fitc_config(7)
    x_min, x_max = x.min(0), x.max(0)
    z = select_inducing((x - x_min) / (x_max - x_min), kw["inducing"])
    return x, y, xte[:64], z * (x_max - x_min) + x_min


def fitc7_model(dev, x, y, z_orig, precision="fast"):
    from lcgp_tpu_torch import LCGP
    return LCGP(y, x, q=4, inducing=z_orig, n_chunk=0, precision=precision,
                device=dev)


def phase_fitc_mesh_one_rank(dev, card, counts):
    """Phase 14, part 1: a world of one NCCL rank in this process.  At
    config 7 'fast' on the ('n',) mesh against one device's dense FITC:
    a loss+grad at the init (loss within 1e-12 relative, gradient leaves
    within 1e-6 of their max |g|), the aux (each field within 1e-6 of its
    largest entry) and a 64-point predict (1e-6), then
    ``refine_inducing(steps=5)`` (K5 launched 3 times a step; its loss
    within FITC_MESH_RTOL of one device's), the warm loss+grad seconds and
    the memory one takes beyond the resident bytes.  Then config 4's exact
    model at the committed fit served on the ('n',) mesh (request p50 and
    p95, held to the mesh ``model.predict`` and one device's).  Returns
    (the one-device reference at the init, that memory, the serving
    summary)."""
    import os
    import tempfile
    import torch
    import torch.distributed as dist
    from lcgp_tpu_torch.parallel import init_distributed, nshard

    tag = f"[{card}]"
    store = tempfile.mkdtemp(prefix="chip_smoke_store_")
    init_distributed("nccl", dev, rank=0, world_size=1,
                     store=dist.FileStore(os.path.join(store, "s"), 1))
    try:
        nmesh = nshard.make_n_mesh(device=dev)
        x, y, x0, z_orig = fitc7_inputs()
        single = fitc7_model(dev, x, y, z_orig)
        meshed = fitc7_model(dev, x, y, z_orig)
        meshed.set_mesh(nmesh)
        check(torch.equal(single._z, meshed._z), "the mesh model's z differs")
        vg_s, z0, flat = flat_vg(single._loss_fn(), single.free)
        vg_m = flat_vg(meshed._loss_fn(), meshed.free)[0]
        kmm, knm = "Kmm (4, 512, 512)", f"Knm (4, {x.shape[0]}, 512)"
        ref = dict(vg=vg_s(z0), flat=flat, z=single._z.cpu().numpy(),
                   free=[t.cpu().numpy() for t in single.free],
                   data={k: t.cpu().numpy() for k, t in
                         single._data._asdict().items()})
        got = counts.call(kmm, knm, lambda: vg_m(z0), FITC_ROWS_7_MESH)
        (v, g), (vr, gr) = got, ref["vg"]
        rel = abs(v - vr) / abs(vr)
        say(f"  ('n',) 1 rank, config 7 'fast' at the init: loss {v:.17e} vs "
            f"one device {vr:.17e}, rel {rel:.3e} (bound 1e-12), the same "
            f"bits: {v == vr}")
        check(rel <= 1e-12, "the one-rank FITC mesh loss differs from one "
              "device's")
        compare_grads("('n',) 1 rank FITC gradient", torch.as_tensor(g),
                      torch.as_tensor(gr), flat, 1e-6)
        t_s = [timed_s(lambda: vg_s(z0)) for _ in range(3)]
        t_m = [timed_s(lambda: counts.call(kmm, knm, lambda: vg_m(z0),
                                          FITC_ROWS_7_MESH))
               for _ in range(3)]
        say(f"  {tag} config 7 'fast' warm loss+grad: ('n',) 1 rank "
            f"{statistics.median(t_m):.4f} s, one device "
            f"{statistics.median(t_s):.4f} s (medians of 3)")
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        resident = torch.cuda.memory_allocated()
        counts.call(kmm, knm, lambda: vg_m(z0), FITC_ROWS_7_MESH)
        peak1 = torch.cuda.max_memory_allocated() - resident
        say(f"  {tag} one loss+grad's memory on the one rank: "
            f"{peak1 / 1e9:.3f} GB beyond {resident / 1e9:.3f} GB resident")

        a_s = single._ensure_aux()
        t_aux = timed_s(lambda: counts.call(
            kmm, knm, meshed.compute_aux_predictive_quantities,
            FITC_ROWS_7_MESH))
        say(f"  {tag} ('n',) 1 rank FITC aux: {t_aux:.4f} s")
        for name in ("Lmm", "alpha", "inner", "u"):
            compare_normwise(f"('n',) 1 rank aux {name} vs one device",
                             getattr(meshed._aux, name), getattr(a_s, name),
                             1e-6)
        ref["predict"] = [t.cpu().numpy() for t in single.predict(x0)]
        got = counts.call(kmm, "request (4, 64, 512)",
                          lambda: meshed.predict(x0))
        for name, a, b in zip(("ypred", "ypredvar", "yconfvar"), got,
                              ref["predict"]):
            compare_normwise(f"('n',) 1 rank 64-point {name}", a.cpu(),
                             torch.as_tensor(b), 1e-6)
        del a_s, got

        steps = FITC_MESH_REFINE_STEPS
        before = counts.total(FITC_ROWS_F64[2]) + counts.total(
            FITC_ROWS_F32[2])
        t0 = time.perf_counter()
        l_m = counts.call(kmm, knm, lambda: meshed.refine_inducing(
            steps=steps, learning_rate=1e-3), FITC_ROWS_7_MESH)
        torch.cuda.synchronize()
        t_ref = time.perf_counter() - t0
        k5 = counts.total(FITC_ROWS_F64[2]) + counts.total(
            FITC_ROWS_F32[2]) - before
        l_s = single.refine_inducing(steps=steps, learning_rate=1e-3)
        rel = abs(l_m - l_s) / abs(l_s)
        say(f"  {tag} refine_inducing(steps={steps}) on the one rank: "
            f"{t_ref:.3f} s, loss {l_m:.10e} vs one device {l_s:.10e} (rel "
            f"{rel:.3e}), K5 launches {k5} (3 a step)")
        check(k5 == 3 * steps, f"refine_inducing launched K5 {k5} times")
        check(rel <= FITC_MESH_RTOL, "refine_inducing on the mesh differs "
              "from one device")
        del single, meshed
        torch.cuda.empty_cache()
        # the four ranks' yardstick: one device in f64 at the init
        high = fitc7_model(dev, x, y, z_orig, precision="high")
        ref["vg64"] = flat_vg(high._loss_fn(), high.free)[0](z0)
        ref["predict64"] = [t.cpu().numpy() for t in high.predict(x0)]
        del high
        torch.cuda.empty_cache()
        serve = phase_serve_mesh_one_rank(dev, card, nmesh, counts)
        return ref, x0, z_orig, peak1, serve
    finally:
        dist.destroy_process_group()


def phase_serve_mesh_one_rank(dev, card, nmesh, counts):
    """Phase 14, part 1: config 4's exact model at the committed fit on
    the one-rank ('n',) mesh behind ``PredictServer`` (its step eager, its
    dispatches broadcast to a mesh of one): 64-point requests against the
    mesh ``model.predict`` (1e-10 of each output's largest entry) and one
    device's (1e-7), then SERVE_MESH_REQUESTS timed.  Returns the p50 and
    p95 ms."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.ops.launch import family
    from lcgp_tpu_torch.serve import PredictServer
    x, y, xte, _ = config4()
    with np.load(FITTED, allow_pickle=False) as z:
        free_np = tuple(z[k] for k in ("lLmb", "lLmb0", "lsigma2s",
                                       "lnugGPs"))
    fitted = free_params_from_numpy(*free_np, dev)
    x0 = xte[:64]
    single = LCGP(y, x, q=20, device=dev)
    single.free = fitted
    one = [t.cpu() for t in single.predict(x0)]
    del single
    k1 = family("matern32").gram
    m = LCGP(y, x, q=20, device=dev)
    m.free = fitted
    m.set_mesh(nmesh)
    c0 = k1.launches
    ref = [t.cpu() for t in m.predict(x0)]
    srv = PredictServer(m, batch_size=64)
    served = srv.predict(x0)
    lat = [1e3 * timed_s(lambda: srv.predict(x0))
           for _ in range(SERVE_MESH_REQUESTS)]
    srv.shutdown()
    counts.add("matern32_gram", "served config 4, ('n',) 1: the aux's "
               "rows (20, 4096, 4096) and requests (20, 64, 4096)",
               k1.launches - c0)
    for name, a, b, c in zip(("ypred", "ypredvar", "yconfvar"), served,
                             ref, one):
        compare_normwise(f"served ('n',) 1 config 4 {name} vs the mesh "
                         "model.predict", torch.as_tensor(a), b, 1e-10)
        compare_normwise(f"served ('n',) 1 config 4 {name} vs one device",
                         torch.as_tensor(a), c, 1e-7)
    p50, p95 = p50_p95(lat)
    say(f"  [{card}] served config 4 on the one-rank ('n',) mesh (eager "
        f"step): 64-point request p50 {p50:.3f} ms, p95 {p95:.3f} ms (of "
        f"{len(lat)})")
    return dict(exact_one_rank_p50_ms=p50, exact_one_rank_p95_ms=p95)


def by_rows(fn, x1, M=None, step=None):
    """A plain version over row blocks of x1 (and of the cotangent M) of
    ``step`` rows, so that its intermediates fit beside the kernel's
    operands: a Gram's blocks concatenated, a VJP's sums added up; one call
    when ``step`` is None or covers x1."""
    import torch
    n = x1.shape[0]
    if step is None or n <= step:
        return fn(x1) if M is None else fn(x1, M)
    if M is None:
        return torch.cat([fn(x1[s:s + step]) for s in range(0, n, step)],
                         dim=1)
    parts = [fn(x1[s:s + step], M[:, s:s + step]) for s in range(0, n, step)]
    return tuple(sum(p[i] for p in parts) for i in range(len(parts[0])))


def fitc_panel_kernels(dev, card, xs, z, rows, what, with_k5=True,
                       plain_step=None):
    """K1 (Knm), K2 (cross mode at a random cotangent) and, with_k5, K5 at
    the panel (q=4, xs's rows, z's columns), f32 (the path's) and f64,
    against their plain versions (over row blocks of ``plain_step``),
    timed in turns with their bounds.  Returns the kernel records, named
    ``rows``, f32 in the main keys and f64 under ``*_f64``."""
    import torch
    from lcgp_tpu_torch.ops._build import build
    lib = build().lib
    fam = family_of("matern32")
    q, n, d, m = 4, xs.shape[0], xs.shape[1], z.shape[0]
    rng = np.random.default_rng(61)
    out = {}
    for dt in (torch.float32, torch.float64):
        tag, size = ("f64", 8) if dt == torch.float64 else ("f32", 4)
        rtol, atol = ((F64_RTOL, F64_ATOL) if dt == torch.float64
                      else (F32_RTOL, F32_ATOL))
        vjp_bound = VJP_BOUND if dt == torch.float64 else VJP_BOUND_F32
        rate = F64_INSTR_PER_S if dt == torch.float64 else F32_INSTR_PER_S
        ls, amp, nug = moderate_params(rng, q, d, dev, torch.float64)
        ls = ls * 0.1
        x1, x2, ls_, amp_, nug_ = (t.to(dt).contiguous()
                                   for t in (xs, z, ls, amp, nug))
        M = torch.randn((q, n, m), generator=torch.Generator(
            device=dev).manual_seed(62), dtype=dt, device=dev)
        b64 = [t.double() for t in (x1, x2, ls_, amp_, nug_)]
        ins = (x1.numel() + x2.numel() + ls_.numel() + 2 * q) * size
        lab = f"{tag} (q={q}, n={n}, m={m}, d={d})"

        def plain_gram(*ts):
            return by_rows(lambda a: fam.plain(a, *ts[1:], same=False),
                           ts[0], step=plain_step)

        def plain_vjp(fn, ts, Mc):
            return by_rows(lambda a, c: fn(a, *ts[1:], same=False, cbar=c),
                           ts[0], Mc, plain_step)
        res = []
        err_g = compare(f"K1 at the {what} {lab} vs plain f64",
                        fam.launch(x1, x2, ls_, amp_, nug_, same=False)[0],
                        plain_gram(*b64), rtol, atol)
        t_g = time_pair(f"K1 {what} {lab}",
                        raw_gram(lib, x1, x2, ls_, amp_, nug_, False),
                        lambda: plain_gram(x1, x2, ls_, amp_, nug_),
                        q * n * m * size, plain_reps=3)
        b_g = say_bound(f"K1 {what} {tag}", t_g[0], q * n * m * size + ins,
                        q * n * m * k1_ops_per_entry(d, False), rate)
        res.append((err_g, t_g, b_g))
        got = fam.launch_vjp(x1, x2, ls_, amp_, nug_, same=False, M=M)
        again = fam.launch_vjp(x1, x2, ls_, amp_, nug_, same=False, M=M)
        ref = plain_vjp(fam.vjp_plain, b64, M.double())
        scale = plain_vjp(fam.scale, b64, M.double())
        torch.cuda.synchronize()
        check(all(torch.equal(u, v) for u, v in zip(got, again)),
              f"K2 at the {what} {lab}: two launches differ")
        err_v = compare_vjp(f"K2 at a random {what} cotangent {lab} vs "
                            "plain; two launches the same bits", got, ref,
                            scale, vjp_bound=vjp_bound, kernel="K2")
        t_v = time_pair(f"K2 {what} {lab}",
                        raw_vjp(lib, x1, ls_, amp_, nug_, M, None, 0.0, None,
                                x2=x2),
                        lambda: plain_vjp(fam.vjp_plain,
                                          (x1, x2, ls_, amp_, nug_), M),
                        M.numel() * size, "read", plain_reps=3)
        b_v = say_bound(f"K2 {what} {tag}", t_v[0],
                        M.numel() * size + ins + q * (d + 2) * size,
                        q * n * m * (k2_ops_per_entry(d) - 2), rate)
        res.append((err_v, t_v, b_v))
        del got, again, ref, scale
        if with_k5:
            got = fam.launch_vjp_x(x1, x2, ls_, amp_, nug_, M=M)
            again = fam.launch_vjp_x(x1, x2, ls_, amp_, nug_, M=M)
            ref = fam.vjp_x_plain(*b64, M=M.double())
            scale = fam.scale_x(*b64, M=M.double())
            torch.cuda.synchronize()
            err = (got.double() - ref).abs()
            share = float((err / scale.clamp_min(1e-300)).max())
            say(f"  K5 at the {what} {lab} vs plain: max_abs_err="
                f"{float(err.max()):.3e}, max err/magnitude={share:.3e} "
                f"(bound {vjp_bound:g}); two launches the same bits: "
                f"{torch.equal(got, again)}")
            check(bool(torch.isfinite(got).all()),
                  f"K5 at the {what} not finite")
            check(bool((err <= vjp_bound * scale).all()),
                  f"K5 at the {what} {tag} outside {vjp_bound:g} x "
                  "magnitude")
            check(torch.equal(got, again), f"K5 at the {what} is not "
                  "deterministic")
            t_x = time_pair(f"K5 {what} {lab}",
                            raw_vjp_x(lib, x1, x2, ls_, amp_, nug_, M,
                                      "matern32"),
                            lambda: fam.vjp_x_plain(x1, x2, ls_, amp_, nug_,
                                                    M=M),
                            M.numel() * size, "read", plain_reps=3)
            b_x = say_bound(f"K5 {what} {tag}", t_x[0],
                            M.numel() * size + ins + m * d * size,
                            q * n * m * k5_ops_per_entry("matern32", d),
                            rate)
            res.append((float(err.max()), t_x, b_x))
            del got, again, ref, scale, err
        out[tag] = res
        say(f"  [{card}] at the {what} {lab}: " + ", ".join(
            f"{k} {t[0]:.4f} ms (plain {t[1]:.4f}, bound {b[0]:.4f})"
            for k, (_, t, b) in zip(("K1", "K2", "K5"), res)))
        del M
        torch.cuda.empty_cache()
    shape = f"{what}, q={q} n={n} m={m} d={d}"
    records = []
    for i, (name, src, rep, kind) in enumerate(zip(
            rows, (K1_SOURCE, K2_SOURCE, K5_SOURCE),
            (K1_REPLACES, K2_REPLACES, K5_REPLACES),
            ("Knm", "random cross cotangent", "(q, n, m) cotangent"))):
        (e32, t32, b32), (e64, t64, b64_) = out["f32"][i], out["f64"][i]
        records.append(dict(
            name=name, route="cuda", source=src, replaces=rep,
            max_abs_err=e32, ms=t32[0], plain_ms=t32[1], bound_ms=b32[0],
            bound_by=b32[1], library_ms=None, max_abs_err_f64=e64,
            ms_f64=t64[0], plain_ms_f64=t64[1], bound_ms_f64=b64_[0],
            bound_by_f64=b64_[1], shape=f"{kind}, f32 (f64 in *_f64), "
                                        f"{shape}"))
    return records


def phase_fitc_block_kernels(dev, card, x, z_orig):
    """Phase 14, part 2: K1 (Knm), K2 (cross mode at a random cotangent)
    and K5 at the ('n',) 4 block of config 7, (4, 100000, 512) with d=2,
    f32 (the path's) and f64, against their plain versions, timed in turns
    with their bounds.  Returns the three kernel records, f32 in the main
    keys, f64 under ``*_f64``."""
    import torch
    x_min, x_max = x.min(0), x.max(0)
    nb = x.shape[0] // FITC_MESH_RANKS
    xs = torch.as_tensor((x[nb:2 * nb] - x_min) / (x_max - x_min),
                         device=dev)
    z = torch.as_tensor((z_orig - x_min) / (x_max - x_min), device=dev)
    return fitc_panel_kernels(dev, card, xs, z, FITC_ROWS_BLOCK,
                              "('n',) 4 block of config 7")


def phase_fitc7_kernels(dev, card):
    """Phase 11, part 1b: K1 at config 7's one-device Knm and K2 at a
    random cotangent of its shape, (4, 400000, 512) with d=2, f32 (the
    path's) and f64, against their plain versions (over blocks of 100,000
    rows), timed in turns with their bounds.  Returns the two records."""
    import torch
    x, _, _, z_orig = fitc7_inputs()
    x_min, x_max = x.min(0), x.max(0)
    xs = torch.as_tensor((x - x_min) / (x_max - x_min), device=dev)
    z = torch.as_tensor((z_orig - x_min) / (x_max - x_min), device=dev)
    recs = fitc_panel_kernels(dev, card, xs, z, FITC_ROWS_7,
                              "one-device panel of config 7", with_k5=False,
                              plain_step=100_000)
    del xs, z
    torch.cuda.empty_cache()
    return recs


def fitc_mesh_reference_check(spec, r, ref):
    """A rank's config-7 'fast' answers at the init (the loss, each
    gradient leaf, each 64-point output) against one device's f64 ones,
    each within the smaller of FITC7_FAST_BOUNDS and FITC_MESH_ERR_RATIO x
    one device's own 'fast' error."""
    fast_vs_f64_check(f"{spec} rank {r['rank']}",
                      (r["loss"], r["grad"], r["predict"]),
                      (*ref["vg64"], ref["predict64"]), ref["flat"],
                      one=(*ref["vg"], ref["predict"]))


def check_alike(what, results, key):
    for r in results[1:]:
        for u, v in zip(results[0][key], r[key]):
            check(np.array_equal(u, v), f"{what}: the ranks' {key} differ")


def phase_fitc_mesh_shared(dev, card, ref, x0, z_orig, peak1, counts):
    """Phase 14, part 3: FITC_MESH_RANKS gloo ranks on one card, their
    collectives staged through the host.  At config 7 on FITC_MESH_SPECS
    (each rank the same inducing points): an f64 loss+grad at the init
    against one device's f64; then 'fast', every rank's loss+grad, aux and
    64-point predict against one device's f64 answers
    (``fitc_mesh_reference_check``),
    refine_inducing(steps=2) on ('n',) 4, a 2-step Adam ``fit(mesh=...)``
    whose parameters and z are the same bits on every rank, the seconds,
    staged bytes and memory of a loss+grad a rank (at ('n',) 4 under half
    of part 1's one rank).  Then served mesh models: config 4's exact model
    at the committed fit and config 6's 'fast' FITC model at its init, each
    on ('n',) 4, with request p50 and p95 held to the mesh
    ``model.predict`` taken before the server started.  Returns the
    summary."""
    import torch
    from lcgp_tpu_torch.parallel import WorkerGroup, tasks
    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(mode == "Default", f"{FITC_MESH_RANKS} contexts on one card need "
          f"compute mode Default, not {mode}")
    x, y, _, _, _ = fitc_config(7)
    ctor = dict(q=4, inducing=z_orig, n_chunk=0, precision="fast")
    summary = {}
    torch.cuda.empty_cache()
    with WorkerGroup(FITC_MESH_RANKS, device=str(dev), backend="gloo",
                     timeout=900, collective_timeout=600) as group:
        for spec in FITC_MESH_SPECS:
            on_n = spec[0] == "n"
            res = group.run(tasks.fitc_loss_and_grad, spec, ref["data"],
                            ref["free"], ref["z"], device=str(dev))
            check(all(r[0] == res[0][0] for r in res), f"{spec}: the ranks' "
                  "f64 losses differ")
            v, g = res[0]
            rel = abs(v - ref["vg64"][0]) / abs(ref["vg64"][0])
            say(f"  {spec} f64 loss+grad: loss {v:.15e} vs one device's f64 "
                f"{ref['vg64'][0]:.15e}, rel {rel:.3e} (bound "
                f"{FITC_MESH_F64_LOSS_RTOL:g})")
            check(rel <= FITC_MESH_F64_LOSS_RTOL, f"{spec}: the f64 loss "
                  "differs from one device's")
            compare_grads(f"{spec} f64 gradient", torch.as_tensor(
                np.concatenate([a.ravel() for a in g])),
                torch.as_tensor(ref["vg64"][1]), ref["flat"],
                FITC_MESH_F64_GRAD_RTOL)
            del res, g
            res = group.run(
                tasks.measure_fitc, spec, x, y, ctor, x0, device=str(dev),
                fit=dict(method="adam", steps=2, learning_rate=1e-2),
                refine=dict(steps=2, learning_rate=1e-3) if on_n else None)
            qc, nb = (4, x.shape[0] // 4) if on_n else (2, x.shape[0] // 2)
            f64_l, f32_l = (f"Kmm ({qc}, 512, 512), {spec}",
                            f"Knm ({qc}, {nb}, 512), {spec}")
            # the ranks' answers are replicated: the same bits on each
            for key in ("grad", "predict"):
                check_alike(f"{spec} at the init", res, key)
            check(len({r["loss"] for r in res}) == 1, f"{spec}: the ranks' "
                  "losses differ")
            fitc_mesh_reference_check(spec, res[0], ref)
            for r in res:
                check(r["launches"] == (1, 1, 1, 1, 0, 0),
                      f"{spec} rank {r['rank']}: one loss+grad launched "
                      f"{r['launches']} (Gram, VJP, K5 f64 then f32)")
                pred = r["launches_predict"]
                main = tuple(a - b for a, b in
                             zip(r["launches_total"], pred))
                counts.add_fitc(main, f64_l, f32_l,
                                FITC_ROWS_BLOCK if on_n else FITC_ROWS_F32)
                counts.add_fitc(pred, f64_l, f"request (4, 64, 512), {spec}")
            check_alike(f"{spec} 2-step Adam fit", res, "fit_free")
            for r in res[1:]:
                check(np.array_equal(r["fit_z"], res[0]["fit_z"]),
                      f"{spec}: the ranks' fitted z differ")
            mem = max(r["peak_bytes"] - r["resident_bytes"] for r in res)
            s = summary[str(spec)] = dict(
                first_s=max(r["first_s"] for r in res),
                warm_s=max(r["warm_s"] for r in res),
                staged_mb=[r["staged_bytes"] / 1e6 for r in res],
                loss_grad_gb=mem / 1e9, share_of_one_rank=mem / peak1,
                aux_s=max(r["aux_s"] for r in res),
                request_ms=1e3 * max(r["request_s"] for r in res),
                fit_s=max(r["fit_s"] for r in res))
            say(f"  [{card}] {spec} config 7 'fast': loss+grad first "
                f"{s['first_s']:.3f} s, warm {s['warm_s']:.3f} s (slowest "
                "rank); staged per loss+grad " + ", ".join(
                    f"{b:.2f}" for b in s["staged_mb"]) + " MB; a loss+grad's "
                f"memory {mem / 1e9:.3f} GB a rank, {s['share_of_one_rank']:.3f}"
                f" of the one NCCL rank's {peak1 / 1e9:.3f} GB; aux "
                f"{s['aux_s']:.3f} s, 64-point request {s['request_ms']:.1f} "
                f"ms; 2-step Adam fit {s['fit_s']:.3f} s, every rank's "
                "parameters and z the same bits"
                + (f"; refine_inducing(steps=2) {max(r['refine_s'] for r in res):.3f} s"
                   if on_n else ""))
            if on_n:
                check(s["share_of_one_rank"] < 0.5, "a ('n',) 4 rank's "
                      "loss+grad memory is not under half the one rank's")
        summary["served"] = phase_serve_mesh_shared(dev, card, group, counts)
    return summary


def phase_serve_mesh_shared(dev, card, group, counts):
    """Phase 14, part 3: served mesh models on the four gloo ranks (the
    first rank serves, the others follow): config 4's exact model at the
    committed fit and config 6's 'fast' FITC model at its init, each on
    ('n',) 4; the served answers against the mesh ``model.predict``
    (exact 1e-10 of each output's largest entry, FITC's graph 1e-6), a
    follower's refused predict, coalesced clients, a bad request refused
    before the broadcast, and SERVE_MESH_REQUESTS timed requests."""
    import torch
    from lcgp_tpu_torch.parallel import tasks
    x4, y4, xte4, _ = config4()
    with np.load(FITTED, allow_pickle=False) as z:
        free4 = [z[k] for k in ("lLmb", "lLmb0", "lsigma2s", "lnugGPs")]
    x6, y6, xte6, _, _ = fitc_config(6)
    out = {}
    for what, x, y, ctor, free, x0, tol in (
            ("config 4 exact", x4, y4, dict(q=20), free4, xte4[:64], 1e-10),
            ("config 6 FITC 'fast'", x6, y6, dict(q=4, inducing=256,
                                                  precision="fast"),
             None, xte6[:64], 1e-6)):
        res = group.run(tasks.serve_mesh, ("n", FITC_MESH_RANKS), x, y, ctor,
                        free, x0, device=str(dev), batch_size=64,
                        requests=SERVE_MESH_REQUESTS, timeout=600)
        lead = res[0]
        for r in res[1:]:
            check("follow()" in r["follower_predict"] and r["followed"],
                  f"{what}: rank {r['rank']} did not follow")
        for name, a, b in zip(("ypred", "ypredvar", "yconfvar"),
                              lead["served"], lead["ref"]):
            compare_normwise(f"served ('n',) 4 {what} {name} vs the mesh "
                             "model.predict", torch.as_tensor(a),
                             torch.as_tensor(b), tol)
        check(lead["dispatches"] < len(lead["clients"]),
              f"{what}: {len(lead['clients'])} concurrent clients took "
              f"{lead['dispatches']} dispatches")
        check("expected (n0," in lead["bad_request"], f"{what}: a bad "
              "request was not refused")
        p50, p95 = p50_p95(lead["latency_ms"])
        say(f"  [{card}] served {what} on ('n',) 4 (4 gloo ranks): 64-point "
            f"request p50 {p50:.3f} ms, p95 {p95:.3f} ms (of "
            f"{len(lead['latency_ms'])}); {len(lead['clients'])} concurrent "
            f"clients in {lead['dispatches']} dispatches")
        out[what] = dict(p50_ms=p50, p95_ms=p95)
        launches = [r["launches"] for r in res]
        if "exact" in what:
            counts.add("matern32_gram", "served config 4, ('n',) 4: the "
                       "aux's rows (20, 1024, 4096) and requests (20, 64, "
                       "1024)", sum(la[0] for la in launches))
        else:
            for la in launches:
                counts.add_fitc(la, "Kmm (4, 256, 256), served config 6",
                                "Knm (4, 12500, 256) and requests (4, 64, "
                                "256), served config 6")
    return out


# ---------------------------------------------------------------------------
# Phase 15: the examples (examples/torch_*.py) at their default sizes
# ---------------------------------------------------------------------------

EXAMPLE_REFERENCE = ROOT / "examples" / "torch_reference_metrics.json"
# the multichip demo's differences from one device on the same rank: the
# sharded loss (relative), its gradient (of each leaf's largest entry), the
# sharded Adam fit's loss against one device's Adam (relative) and each
# mesh's predictions at the fitted parameters (of the largest)
MULTICHIP_BOUNDS = dict(sharded_loss_rel=1e-9, sharded_grad_rel=1e-7,
                        adam_loss_rel=1e-6, n_predict_rel=1e-7,
                        fitc_predict_rel=1e-7, nc_predict_rel=1e-7)


def example_module(name):
    """examples/torch_<name>.py as a module (its main(argv) -> dict)."""
    import importlib.util
    path = ROOT / "examples" / f"torch_{name}.py"
    spec = importlib.util.spec_from_file_location(f"torch_{name}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def hold_to_reference(what, got, ref, tols):
    """The metrics ``ref`` and ``tols`` both name, each within its
    tolerance of the reference's."""
    for k, tol in tols.items():
        if k not in ref:
            continue
        say(f"  {what} {k}: {got[k]:.6g} vs the reference's {ref[k]:.6g} "
            f"(tolerance {tol})")
        check(abs(got[k] - ref[k]) <= tol, f"{what}: {k} {got[k]:.6g} beyond "
              f"{tol} of the reference's {ref[k]:.6g}")


# the kernel rows of phase 15: K1 and K2 at the examples' shapes, timed at
# the borehole field's (5, 800, 800) with d=8, f64
EXAMPLE_ROWS = ("matern32_gram_examples", "matern32_gram_vjp_examples")


@contextlib.contextmanager
def fitted_models():
    """Yields the list of the models whose fit() returns inside the block,
    in order (LCGP.fit wrapped on the class, restored after)."""
    from lcgp_tpu_torch.models.lcgp import LCGP
    models = []
    fit = LCGP.fit

    def wrapped(self, *args, **kwargs):
        out = fit(self, *args, **kwargs)
        models.append(self)
        return out
    LCGP.fit = wrapped
    try:
        yield models
    finally:
        LCGP.fit = fit


def vjp_at_random(what, xs, ls, amp, nug, x2=None, seed=0):
    """K2 at a random cotangent of the shape (same-point, or cross against
    x2) against its plain version, f64; same-point components where the
    two differ are recomputed in extended precision.  Returns the max abs
    error."""
    import torch
    fam = family_of("matern32")
    same = x2 is None
    x2 = xs if same else x2
    gen = torch.Generator(device=xs.device).manual_seed(seed)
    cbar = torch.randn((ls.shape[0], xs.shape[0], x2.shape[0]),
                       generator=gen, dtype=xs.dtype, device=xs.device)
    got = fam.launch_vjp(xs, x2, ls, amp, nug, same=same, M=cbar)
    ref = fam.vjp_plain(xs, x2, ls, amp, nug, same=same, cbar=cbar)
    scale = fam.scale(xs, x2, ls, amp, nug, same=same, cbar=cbar)
    torch.cuda.synchronize()
    extended = None if not same else (
        lambda k: vjp_extended(xs, ls, amp, nug, k, cbar, None, 0.0, None))
    return compare_vjp(f"K2 at a random cotangent, {what}", got, ref,
                       scale, extended)


def phase_example_kernels(dev, card, fitted):
    """Phase 15, part 2: K1 and K2 against their plain versions, f64, at
    the examples' shapes: each one-card example's fitted model (K1 square
    at its fitted parameters, K2 at a random cotangent; the borehole
    field's K2 also fused at its loss's B^-1 and w, as its fit launches
    it), each where the plain version is imprecise held to extended
    precision; the multichip demo's (4, 256, 256) and its FITC blocks'
    (4, 64, 32), d=4, at moderate parameters.  K1 (square, the loss's
    epilogue) and K2 (fused) timed at the borehole field's (5, 800, 800)
    with d=8, with their bounds.  ``fitted``: [(label, model)], the
    borehole field's model last.  Returns the two records."""
    import torch
    from lcgp_tpu_torch.models import params as P
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.matern import (fused_cotangent,
                                           matern32_gram_vjp_fused_plain,
                                           matern32_gram_vjp_scale)
    fam = family_of("matern32")
    errs = ([], [])
    for label, m in fitted:
        xs = m._data.xs.contiguous()
        ls, amp, _, nug = (t.detach().contiguous()
                           for t in P.constrain(m.free))
        what = (f"{label}'s fitted model (q={ls.shape[0]}, n={xs.shape[0]}, "
                f"d={xs.shape[1]})")
        errs[0].append(gram_at_fitted(xs, ls, amp, nug, "matern32", what))
        errs[1].append(vjp_at_random(what, xs, ls, amp, nug))
    rng = np.random.default_rng(71)
    x = torch.as_tensor(rng.uniform(0, 1, (256, 4)), device=dev)
    z = torch.as_tensor(rng.uniform(0, 1, (32, 4)), device=dev)
    ls, amp, nug = moderate_params(rng, 4, 4, dev, torch.float64)
    for x1, x2, same in ((x, x, True), (x[:64].contiguous(), z, False)):
        what = (f"the multichip demo's shape (q=4, n1={x1.shape[0]}, "
                f"n2={x2.shape[0]}, d=4)")
        errs[0].append(compare(
            f"K1 at {what} vs plain f64",
            fam.launch(x1, x2, ls, amp, nug, same=same)[0],
            fam.plain(x1, x2, ls, amp, nug, same=same), F64_RTOL, F64_ATOL))
        errs[1].append(vjp_at_random(what, x1, ls, amp, nug,
                                     x2=None if same else x2))

    # the borehole field's fit: K1 with the loss's epilogue, K2 fused
    label, m = fitted[-1]
    xs = m._data.xs.contiguous()
    ls, amp, nug, D, a = (t.detach().contiguous()
                          for t in loss_operands(m, m.free))
    q, n, d = ls.shape[0], xs.shape[0], xs.shape[1]
    Binv, w = fused_operands(m, ls, amp, nug, D, a)
    alpha = 0.5 * D

    def p_fused():
        return matern32_gram_vjp_fused_plain(xs, ls, amp, nug, M=Binv,
                                             alpha=alpha, beta=-0.5, w=w)
    got = fam.launch_vjp(xs, xs, ls, amp, nug, same=True, M=Binv,
                         alpha=alpha, beta=-0.5, w=w)
    scale = matern32_gram_vjp_scale(xs, xs, ls, amp, nug, same=True,
                                    cbar=fused_cotangent(Binv, alpha, -0.5,
                                                         w))
    torch.cuda.synchronize()
    lab = f"{label}'s fitted model (q={q}, n={n}, d={d})"
    errs[1].append(compare_vjp(
        f"K2 fused f64 at the loss's B^-1 and w, {lab}", got, p_fused(),
        scale, lambda k: vjp_extended(xs, ls, amp, nug, k, Binv, alpha,
                                      -0.5, w)))
    lib = build().lib
    dv = torch.full((q, n), 1.0 + m._jitter, dtype=xs.dtype, device=dev)
    stack = q * n * n * 8
    t_g = time_pair(f"K1 square+epilogue f64, {lab}",
                    raw_gram(lib, xs, xs, ls, amp, nug, True, D, dv),
                    lambda: linalg.add_diag(D[:, None, None] * fam.plain(
                        xs, xs, ls, amp, nug, same=True), dv), stack)
    b_g = say_bound("K1 examples", t_g[0],
                    stack + (xs.numel() + ls.numel() + 3 * q + dv.numel())
                    * 8, q * entries(n, n, True) * k1_ops_per_entry(d, True))
    t_v = time_pair(f"K2 fused f64, {lab}",
                    raw_vjp(lib, xs, ls, amp, nug, Binv, alpha, -0.5, w),
                    p_fused, Binv.numel() * 8, "read")
    b_v = say_bound("K2 examples", t_v[0],
                    (Binv.numel() + w.numel() + xs.numel() + 5 * q
                     + ls.numel() + q * (d + 2)) * 8,
                    q * entries(n, n, True) * k2_ops_per_entry(d))
    say(f"  [{card}] at {lab}: K1 {t_g[0]:.4f} ms (plain {t_g[1]:.4f}, "
        f"bound {b_g[0]:.4f}), K2 {t_v[0]:.4f} ms (plain {t_v[1]:.4f}, "
        f"bound {b_v[0]:.4f})")
    shape = (f"timed at the borehole field's fitted model, BASELINE config "
             f"3, q={q} n={n} d={d}, f64; checked at every one-card "
             "example's fitted model and the multichip demo's shapes")
    return [dict(name=name, route="cuda", source=src, replaces=rep,
                 max_abs_err=max(e), ms=t[0], plain_ms=t[1], bound_ms=b[0],
                 bound_by=b[1], library_ms=None, shape=f"{kind}, {shape}")
            for name, src, rep, e, t, b, kind in zip(
                EXAMPLE_ROWS, (K1_SOURCE, K2_SOURCE),
                (K1_REPLACES, K2_REPLACES), errs, (t_g, t_v), (b_g, b_v),
                ("square+epilogue", "fused loss cotangent"))]


def phase_examples(dev, card):
    """Phase 15: each example's main() on the card at its default size,
    with the K1 and K2 launches it makes (counted apart for each example):
    the notebook check within TOLERANCES of examples/notebook_metrics.json,
    the three rep-1d and the three rep-3d cases (the transform check within
    1e-10) and the borehole field at config 3 ('scipy', 'high'), each
    within TOLERANCES of examples/torch_reference_metrics.json, then the
    multichip demo on four gloo ranks that share the card (compute mode
    Default), its differences from one device within MULTICHIP_BOUNDS and
    K1 and K2 launched on the ranks.  Then K1 and K2 against their plain
    versions at the examples' shapes (``phase_example_kernels``).  Returns
    the two kernel records of the examples' shapes, with the phase's
    launches (f64 and f32 alike) and each example's summary."""
    import torch
    ref = json.loads(EXAMPLE_REFERENCE.read_text())
    tols = ref["tolerances"]
    fam = family_of("matern32")
    out = {}
    total = [0, 0]
    fitted = []

    def run(name, argv=()):
        before = (fam.gram.launches, fam.vjp.launches)
        t0 = time.perf_counter()
        with fitted_models() as models:
            res = example_module(name).main(list(argv))
        torch.cuda.synchronize()
        fitted.extend((f"{name} fit {i}", m) for i, m in enumerate(models))
        secs = time.perf_counter() - t0
        launches = (fam.gram.launches - before[0],
                    fam.vjp.launches - before[1])
        total[0] += launches[0]
        total[1] += launches[1]
        say(f"  [{card}] {name}: {secs:.2f} s in all; (K1, K2) launches "
            f"{launches}")
        check(min(launches) > 0, f"{name} did not launch K1 and K2")
        return res, secs, launches

    res, secs, launches = run("check_notebook_fresh")
    check(res["failures"] == [], f"the notebook metrics drifted: "
          f"{res['failures']}")
    out["check_notebook_fresh"] = dict(fit_s=res["fit_s"], s=secs,
                                       launches=launches)
    for name, key in (("rep_1d_illustration", "rep_1d"),
                      ("rep_3d_illustration", "rep_3d")):
        res, secs, launches = run(name)
        for case, got in res.items():
            hold_to_reference(f"{key} {case}", got, ref[key][case], tols)
            if key == "rep_3d":
                say(f"  rep_3d {case} transform check "
                    f"{got['transform_check_max_abs']:.3e} (bound 1e-10)")
                check(got["transform_check_max_abs"] <= 1e-10,
                      f"rep_3d {case}: the transform check fails")
        out[name] = dict(fit_s={c: r["fit_s"] for c, r in res.items()},
                         s=secs, launches=launches)
    res, secs, launches = run("borehole_field")
    hold_to_reference("borehole config 3", res, ref["borehole_config3"],
                      tols)
    out["borehole_field"] = dict(fit_s=res["fit_s"], s=secs,
                                 launches=launches, rmse=res["rmse"])

    mode = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout.strip()
    check(mode == "Default", "four contexts on one card need compute mode "
          f"Default, not {mode}")
    t0 = time.perf_counter()
    res = example_module("multichip_sharded").main([])
    secs = time.perf_counter() - t0
    for k, bound in MULTICHIP_BOUNDS.items():
        say(f"  multichip {k}: {res[k]:.3e} (bound {bound:g})")
        check(res[k] <= bound, f"multichip demo: {k} {res[k]:.3e} beyond "
              f"{bound:g}")
    want = ref["multichip_2x2"]["single_device_loss"]
    say(f"  multichip one device's loss {res['single_loss']:.6f} vs the "
        f"reference's {want:.6f}")
    check(abs(res["single_loss"] - want) <= 1e-6 * abs(want),
          "the multichip demo's loss differs from the reference's")
    # each rank's (Gram, VJP, K5) launches, f64 then f32
    ranks = [(c[0] + c[1], c[2] + c[3]) for c in res["launches_ranks"]]
    say(f"  [{card}] multichip_sharded: {secs:.2f} s on 4 gloo ranks; "
        f"(K1, K2) launches of each rank {ranks}")
    check(all(min(c) > 0 for c in ranks), "a rank of the multichip demo "
          "did not launch K1 and K2")
    total[0] += sum(c[0] for c in ranks)
    total[1] += sum(c[1] for c in ranks)
    out["multichip_sharded"] = dict(
        s=secs, launches_ranks=ranks,
        **{k: res[k] for k in MULTICHIP_BOUNDS},
        **{k: res[k] for k in ("adam_s", "n_s", "fitc_s", "nc_s")})
    del res
    torch.cuda.empty_cache()
    check(fitted and fitted[-1][0].startswith("borehole_field"),
          "the borehole field's fitted model was not caught")
    records = phase_example_kernels(dev, card, fitted)
    for rec, n, what in zip(records, total, ("K1", "K2")):
        rec["launches"] = n
        rec["launches_by_example"] = {k: v["launches"][what == "K2"]
                                      for k, v in out.items()
                                      if "launches" in v}
        rec["launches_by_example"]["multichip_sharded"] = sum(
            c[what == "K2"] for c in out["multichip_sharded"]["launches_ranks"])
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    records[0]["examples"] = out
    return records


def other_library(root):
    """The kernel library of another checkout at ``root`` (for example the
    parent commit, unpacked with ``git archive``), built by that checkout's
    own build code into its own build directory, with every entry point it
    has bound as this one's (they keep their signatures from one version to
    the next; an older checkout lacks K3-K5, and those are left unbound)."""
    import ctypes
    from lcgp_tpu_torch.ops import _build
    code = ("import sys; sys.path.insert(0, sys.argv[1]); "
            "from lcgp_tpu_torch.ops import _build; "
            "print(_build.build().path)")
    out = subprocess.run([sys.executable, "-c", code, str(root)],
                         capture_output=True, text=True, timeout=900)
    check(out.returncode == 0,
          f"building the kernels of {root} failed:\n{out.stderr[-4000:]}")
    lib = ctypes.CDLL(out.stdout.split()[-1])
    for family in OPS_PER_ENTRY:
        for kind, argtypes in (("gram", _build.GRAM_ARGTYPES),
                               ("gram_vjp", _build.VJP_ARGTYPES),
                               ("gram_vjp_x", _build.VJP_X_ARGTYPES)):
            for dt in ("f64", "f32"):
                fn = getattr(lib, f"lcgp_{family}_{kind}_{dt}", None)
                if fn is not None:
                    fn.argtypes, fn.restype = argtypes, ctypes.c_int
    for name, argtypes in (
            ("lcgp_matern32_gram_vjp_scratch", _build.SCRATCH_ARGTYPES),
            ("lcgp_gram_vjp_x_scratch", _build.VJP_X_SCRATCH_ARGTYPES)):
        fn = getattr(lib, name, None)
        if fn is not None:
            fn.argtypes, fn.restype = argtypes, ctypes.c_longlong
    return lib


def has_entry(lib, name):
    """Whether a loaded kernel library exports ``name``."""
    return getattr(lib, name, None) is not None


def k3_gram_extended_errors(libs, xs, free_np):
    """K3's Gram of each library at the fitted config-4 parameters (1e-6
    lengthscale floor) against an extended-precision recomputation, at the
    entries where the libraries differ and at 200,000 random entries:
    {library: {"max_rel_err": where the reference is a normal f64,
    "outside": entries outside rtol 1e-12 atol 1e-14}}; fails if this
    checkout has any outside."""
    import torch
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.models import params as P
    ls, amp, _, nug = P.constrain(free_params_from_numpy(*free_np,
                                                         xs.device))
    q, n = ls.shape[0], xs.shape[0]
    outs = {}
    for key, lib in libs.items():
        fn = raw_gram(lib, xs, xs, ls, amp, nug, True, family="matern52")
        fn()
        outs[key] = fn.outputs[0]
    torch.cuda.synchronize()
    differ = (outs["this"] != outs["other"]).nonzero()
    rng = np.random.default_rng(5)
    pick = np.stack([rng.integers(0, q, 200_000), rng.integers(0, n, 200_000),
                     rng.integers(0, n, 200_000)], axis=1)
    idx = np.concatenate([differ.cpu().numpy()[:1_000_000], pick])
    k, i, j = idx[:, 0], idx[:, 1], idx[:, 2]
    ld = np.longdouble
    X = xs.cpu().numpy().astype(ld)
    L, A, N = (t.cpu().numpy().astype(ld) for t in (ls, amp, nug))
    S = np.abs(X[i] - X[j]) / L[k]
    ref = np.where(i == j, A[k],
                   A[k] * ((1 - N[k] / (1 + N[k])) * c0_extended("matern52",
                                                                 S)))
    errs = {}
    # relative errors where the reference is a normal f64 (below, f64
    # underflows), and the entries outside rtol 1e-12 atol 1e-14 anywhere
    normal = np.abs(ref) >= 1e-300
    for key, C in outs.items():
        at = [torch.as_tensor(a, device=C.device) for a in (k, i, j)]
        got = C[at[0], at[1], at[2]].cpu().numpy().astype(ld)
        err = np.abs(got - ref)
        errs[key] = {
            "max_rel_err": float(np.max(err[normal] / np.abs(ref[normal]))),
            "outside": int(np.sum(err > F64_ATOL + F64_RTOL * np.abs(ref)))}
    say(f"  K3 f64 Gram at the fitted config-4 parameters vs extended "
        f"precision ({int(differ.shape[0])} entries differ between the "
        f"checkouts; those and 200,000 random entries): this "
        f"{errs['this']}, other {errs['other']}")
    check(errs["this"]["outside"] == 0, "K3 at the fitted parameters "
          "differs from extended precision beyond rtol 1e-12 atol 1e-14")
    return errs


# The kernels whose bits may differ from the other checkout's, as (family,
# entry point): those redesigned against the parent (none now; PR 9 put
# K4's VJP and K5 here).  Each is held to its plain version instead, and
# its two launches to the same bits; every other kernel must give the
# other checkout's bits.
AGAINST_REDESIGNED = set()


def vjp_extended_shares(libs, kind, xs, ls, amp, nug, M, alpha, w, ks):
    """Each library's fused VJP of ``kind`` at the cotangent alpha_k M_k -
    w_k w_k^T / 2, components ``ks`` against vjp_extended: {library: the
    largest error over the magnitude of its sum's terms}, where a sum with
    no terms (magnitude 0) must be exactly 0.  Fails if this checkout's
    outputs are not finite."""
    import torch
    fam = family_of(kind)
    ld = np.longdouble
    refs, scales = {}, {}
    for k in ks:
        refs[k] = vjp_extended(xs, ls, amp, nug, k, M, alpha, -0.5, w,
                               kind=kind)
        sl = slice(k, k + 1)
        scales[k] = fam.scale(
            xs, xs, ls[sl], amp[sl], nug[sl], same=True,
            cbar=(alpha[sl, None, None] * M[sl]
                  - 0.5 * w[sl, :, None] * w[sl, None, :]))
    shares = {}
    for key, lib in libs.items():
        fn = raw_vjp(lib, xs, ls, amp, nug, M, alpha, -0.5, w, family=kind)
        fn()
        torch.cuda.synchronize()
        if key == "this":
            check(all(bool(torch.isfinite(o).all()) for o in fn.outputs),
                  f"{kind} VJP: non-finite outputs")
        share = 0.0
        for k in ks:
            for g, e, sc in zip(fn.outputs, refs[k], scales[k]):
                err = np.abs(g[k].cpu().numpy().astype(ld)
                             - np.asarray(e, dtype=ld))
                sk = sc[0].cpu().numpy().astype(ld)
                if bool(np.any(err[sk == 0] > 0)):
                    share = float("inf")
                pos = sk > 0
                if bool(pos.any()):
                    share = max(share, float(np.max(err[pos] / sk[pos])))
        shares[key] = share
    return shares


def phase_against(dev, xs, x0s, root, free_np):
    """The kernels of this checkout against another checkout's, in turns
    (other, this, this, other), f64 and f32: K1, K2, K3 and K4 at config
    4's square and fused shapes, K1 at the request shape, and every
    family's Gram at FITC's Knm, K2, K3's and K4's VJP at a random cross
    cotangent of that shape and K5 of each family at (4, 50000, 256).
    Every kernel must give the other's bits except those in
    AGAINST_REDESIGNED, which are held to their plain versions (the VJPs
    within 1e-12 (f64) or 1e-5 (f32) of each sum's terms' magnitude) with
    two launches of the same bits.  K3's Gram at the fitted config-4
    lengthscales, and K3's and K4's fused VJP, component 0, are held
    against extended precision, and K4's fused VJP also at the fitted
    parameters (1e-6 lengthscale floor) in the components at that floor.
    A kernel the other checkout lacks is left out.  Returns {"kernels_ms":
    {case: {"this": ms, "other": ms, "same_bits": bool, ...}},
    "extended": {...}}."""
    import torch
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.models import params as P
    from lcgp_tpu_torch.ops._build import build
    from lcgp_tpu_torch.ops.launch import fused_cotangent
    libs = {"this": build().lib, "other": other_library(root)}
    f64 = torch.float64
    rng = np.random.default_rng(1)
    q, n, d = 20, xs.shape[0], xs.shape[1]
    ls, amp, nug = moderate_params(rng, q, d, dev, f64)
    rs = torch.as_tensor(rng.uniform(0.1, 10.0, q), dtype=f64, device=dev)
    dv = torch.ones((q, n), dtype=f64, device=dev)
    gen = torch.Generator(device=dev).manual_seed(6)
    M = torch.randn((q, n, n), generator=gen, dtype=f64, device=dev)
    w = torch.randn((q, n), generator=gen, dtype=f64, device=dev)
    x64 = x0s[:64].contiguous()
    xs32, ls32, amp32, nug32, rs32, dv32, M32, w32 = (
        t.float().contiguous() for t in (xs, ls, amp, nug, rs, dv, M, w))
    # FITC's shape: config 6's points and inducing points, l ~ 1/16
    xf, _, _, _, kw = fitc_config(6)
    xf = (xf - xf.min(0)) / (xf.max(0) - xf.min(0))
    zf = torch.as_tensor(xf[rng.choice(xf.shape[0], kw["inducing"],
                                       replace=False)], device=dev)
    xf = torch.as_tensor(xf, device=dev)
    lf, af, nf = moderate_params(rng, 4, 2, dev, f64)
    lf = lf * 0.1
    Mf = torch.randn((4, xf.shape[0], zf.shape[0]), generator=gen, dtype=f64,
                     device=dev)
    fitc32 = [t.float().contiguous() for t in (xf, zf, lf, af, nf, Mf)]
    sq, fi = f"q={q}, n={n}", f"q=4, n={xf.shape[0]}, m={zf.shape[0]}"

    def cases_of(dt):
        """{label: (family, entry, make(lib) -> launch, plain(outputs,
        label) or None)}: ``plain`` holds a redesigned kernel's outputs to
        its plain version at the same inputs, in f64."""
        tag = "f64" if dt == f64 else "f32"
        bound = VJP_BOUND if dt == f64 else VJP_BOUND_F32
        if dt == f64:
            x_, l_, a_, g_, r_, v_, M_, w_ = xs, ls, amp, nug, rs, dv, M, w
            F = (xf, zf, lf, af, nf, Mf)
        else:
            x_, l_, a_, g_, r_, v_, M_, w_ = (xs32, ls32, amp32, nug32, rs32,
                                              dv32, M32, w32)
            F = fitc32
        F64 = [t.double() for t in F]

        def fused_plain(outs, label, fam):
            xd, ld_, ad, gd, Md, al, wd = (t.double() for t in (
                x_, l_, a_, g_, M_, 0.5 * r_, w_))
            ref = fam.fused_plain(xd, ld_, ad, gd, M=Md, alpha=al,
                                  beta=-0.5, w=wd)
            scale = fam.scale(xd, xd, ld_, ad, gd, same=True,
                              cbar=fused_cotangent(Md, al, -0.5, wd))
            return compare_vjp(f"{label} vs plain", outs, ref, scale,
                               vjp_bound=bound, kernel=fam.label + " VJP")

        def cross_plain(outs, label, fam):
            ref = fam.vjp_plain(*F64[:5], same=False, cbar=F64[5])
            scale = fam.scale(*F64[:5], same=False, cbar=F64[5])
            return compare_vjp(f"{label} vs plain", outs, ref, scale,
                               vjp_bound=bound, kernel=fam.label + " VJP")

        def x_plain(outs, label, fam):
            ref = fam.vjp_x_plain(*F64[:5], M=F64[5])
            scale = fam.scale_x(*F64[:5], M=F64[5])
            err = (outs[0].double() - ref).abs()
            share = float((err / scale.clamp_min(1e-300)).max())
            say(f"  {label} vs plain: max_abs_err={float(err.max()):.3e}, "
                f"max err/magnitude={share:.3e} (bound {bound:g})")
            check(bool(torch.isfinite(outs[0]).all()), f"{label}: not finite")
            check(bool((err <= bound * scale).all()),
                  f"{label}: outside {bound:g} x magnitude")
            return float(err.max())

        out = {}
        for fam, lab in (("matern32", "K1"), ("rbf", "K4"),
                         ("matern52", "K3")):
            vlab = "K2" if fam == "matern32" else f"{lab} VJP"
            out[f"{lab} {tag} square+epilogue ({sq})"] = (
                fam, "gram", lambda lib, fam=fam: raw_gram(
                    lib, x_, x_, l_, a_, g_, True, r_, v_, family=fam), None)
            out[f"{vlab} {tag} fused ({sq})"] = (
                fam, "gram_vjp", lambda lib, fam=fam: raw_vjp(
                    lib, x_, l_, a_, g_, M_, 0.5 * r_, -0.5, w_, family=fam),
                fused_plain)
            out[f"{lab} {tag} Knm ({fi})"] = (
                fam, "gram", lambda lib, fam=fam: raw_gram(
                    lib, F[0], F[1], *F[2:5], False, family=fam), None)
            out[f"{vlab} {tag} random cross cotangent ({fi})"] = (
                fam, "gram_vjp", lambda lib, fam=fam: raw_vjp(
                    lib, F[0], *F[2:5], F[5], None, 0.0, None, family=fam,
                    x2=F[1]), cross_plain)
        if dt == f64:
            out[f"K1 {tag} request (q={q}, n1=64, n2={n})"] = (
                "matern32", "gram", lambda lib: raw_gram(
                    lib, x64, xs, ls, amp, nug, False), None)
        for fam in OPS_PER_ENTRY:
            out[f"K5 {fam} {tag} ({fi})"] = (
                fam, "gram_vjp_x", lambda lib, fam=fam: raw_vjp_x(
                    lib, F[0], F[1], *F[2:5], F[5], fam), x_plain)
        return out

    result = {}
    for dt in (f64, torch.float32):
        tag = "f64" if dt == f64 else "f32"
        for label, (fam, kind, make, plain) in cases_of(dt).items():
            entry = f"lcgp_{fam}_{kind}_{tag}"
            if not has_entry(libs["other"], entry):
                say(f"  {label}: {root} has no {entry}; left out")
                continue
            fns = {k: make(lib) for k, lib in libs.items()}
            o1, t1, t2, o2 = (cuda_ms(fns[k])
                              for k in ("other", "this", "this", "other"))
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for a, b in
                       zip(fns["this"].outputs, fns["other"].outputs))
            diff = max(float((a.double() - b.double()).abs().max())
                       for a, b in zip(fns["this"].outputs,
                                       fns["other"].outputs))
            this_ms, other_ms = (t1 + t2) / 2, (o1 + o2) / 2
            result[label] = {"this": this_ms, "other": other_ms,
                             "ratio": this_ms / other_ms, "same_bits": same,
                             "max_abs_diff": diff}
            say(f"  {label}: this {this_ms:.4f} ms ({t1:.4f}/{t2:.4f}), "
                f"{root}: {other_ms:.4f} ms ({o1:.4f}/{o2:.4f}), ratio "
                f"{this_ms / other_ms:.4f}; outputs the same bits: {same} "
                f"(max abs diff {diff:.3e})")
            if (fam, kind) in AGAINST_REDESIGNED:
                first = [o.clone() for o in fns["this"].outputs]
                fns["this"]()
                torch.cuda.synchronize()
                check(all(torch.equal(a, b) for a, b in
                          zip(first, fns["this"].outputs)),
                      f"{label}: two launches give different bits")
                result[label]["max_abs_err_vs_plain"] = plain(
                    first, label, family_of(fam))
                say(f"  {label}: two launches give the same bits")
            else:
                check(same, f"{label}: this checkout's output differs from "
                      f"{root}'s")
            del fns
            torch.cuda.empty_cache()
    ext = {}
    if has_entry(libs["other"], "lcgp_matern52_gram_f64"):
        ext["k3_gram_fitted_max_rel_err"] = k3_gram_extended_errors(
            libs, xs, free_np)
    # the fused VJPs' component 0 against extended precision
    for kind in ("matern52", "rbf"):
        if not has_entry(libs["other"], f"lcgp_{kind}_gram_vjp_f64"):
            continue
        shares = vjp_extended_shares(libs, kind, xs, ls, amp, nug, M,
                                     0.5 * rs, w, [0])
        label = family_of(kind).label
        say(f"  {label} VJP f64 fused, component 0 vs extended precision: "
            f"err / magnitude this {shares['this']:.3e}, other "
            f"{shares['other']:.3e} (bound {VJP_BOUND:g})")
        check(shares["this"] <= VJP_BOUND, f"{label}'s VJP outside its "
              "bound of the extended-precision sums")
        ext[f"{kind}_vjp_fused_err_per_magnitude"] = shares
    # K4's fused VJP at the fitted config-4 parameters, where lengthscales
    # sit at the 1e-6 floor and the decay underflows for most pairs: finite,
    # and the components at the floor against extended precision
    if has_entry(libs["other"], "lcgp_rbf_gram_vjp_f64"):
        lsF, ampF, _, nugF = P.constrain(free_params_from_numpy(*free_np,
                                                                dev))
        ks = [k for k in range(lsF.shape[0]) if float(lsF[k].min()) <= 1e-5]
        shares = vjp_extended_shares(libs, "rbf", xs, lsF.contiguous(),
                                     ampF.contiguous(), nugF.contiguous(),
                                     M, 0.5 * rs, w, ks)
        say(f"  K4 VJP f64 fused at the fitted parameters, components {ks} "
            f"(lengthscales at the 1e-6 floor) vs extended precision: err / "
            f"magnitude this {shares['this']:.3e}, other "
            f"{shares['other']:.3e} (bound {VJP_BOUND:g}); outputs finite")
        check(shares["this"] <= VJP_BOUND, "K4's VJP at the fitted "
              "parameters outside its bound of the extended-precision sums")
        ext["rbf_vjp_fused_fitted_err_per_magnitude"] = shares
    return {"kernels_ms": result, "extended": ext}


def main() -> int:
    import argparse
    ap = argparse.ArgumentParser(
        description="Smoke run of lcgp_tpu_torch on one CUDA card.")
    ap.add_argument("--against", metavar="DIR",
                    help="only time the kernels of this checkout against "
                         "those of the checkout at DIR, in turns, and "
                         "compare their outputs bit for bit (K4's VJP and "
                         "K5 against their plain versions and extended "
                         "precision; a kernel DIR lacks is left out)")
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    card = smi.stdout.strip()
    say("[1] card (nvidia-smi name, power.limit):")
    say(card)
    dev = torch.device("cuda", 0)

    sys.path.insert(0, str(ROOT))
    from lcgp_tpu_torch.ops import _build
    from lcgp_tpu_torch.models import transforms as tx

    lib = _build.build()
    say(f"[2] K1-K5 built in {lib.build_seconds:.2f} s -> {lib.path}")
    registers = ptxas_report(lib.log)

    x, y, xte, ytrue = config4()
    with np.load(FITTED, allow_pickle=False) as z:
        free_np = tuple(z[k] for k in ("lLmb", "lLmb0", "lsigma2s", "lnugGPs"))
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    xs, x_min, x_max = tx.standardize_x(xt)
    x0s = ((torch.as_tensor(xte, dtype=torch.float64, device=dev) - x_min)
           / (x_max - x_min)).contiguous()
    if args.against:
        say(f"[3] the kernels against those of {args.against}")
        got = phase_against(dev, xs.contiguous(), x0s,
                            Path(args.against).resolve(), free_np)
        say(json.dumps({"against": args.against, **got}))
        return 0

    say("[3] K1 against the plain version on the card")
    record = phase_kernels(dev, xs.contiguous(), x0s)
    xs = xs.contiguous()
    phase_fitted_gram(dev, xs, free_np)
    del xt, x0s
    say("[3] K2 against the plain version on the card")
    record_vjp = phase_vjp(dev, x, y, free_np)

    say("[4] port on the card vs the NumPy oracle (n=300, p=20, q=4)")
    phase_oracle(dev)
    say("[4] rep path on the card vs the NumPy oracle (n_unique=200, "
        "replicates 1-5, p=20, q=4)")
    phase_oracle_rep(dev)

    say("[5] serving at config 4 (n=4096, p=1000, q=20, d=8, f64)")
    k1_serve, per_call = phase_main(dev, x, y, xte, ytrue, free_np)

    say("[6] training at config 4 (n=4096, p=1000, q=20, d=8, f64)")
    k1_fit, k2_fit, per_call["loss_grad"], rmse_f64 = phase_train(
        dev, x, y, xte, ytrue)

    say("[7] rep serving at config 5 (n_unique=1000 x 10 replicates, p=3, "
        "q=3, d=4, f64)")
    k1_rep_serve5, rep_calls = phase_rep_serve(dev)
    per_call.update(rep_calls)

    say("[8] rep path at full width (4096 unique sites x 10 replicates, "
        "p=1000, q=20, d=8, f64)")
    (k1_rep_fit, k2_rep_fit), k1_rep_serve, rep_calls = phase_rep_train(dev)
    per_call.update(rep_calls)
    say("[9] precision modes at config 4 (n=4096, p=1000, q=20, d=8): K1 "
        "and K2 f32 against their plain versions, then 'mixed', 'fast' and "
        "'auto'")
    rec_k1_f32, rec_k2_f32 = phase_f32_kernels(dev, x, y, xte)
    f32_main, calls_f32 = phase_precision(dev, x, y, xte, ytrue, free_np,
                                          rmse_f64)
    check(min(f32_main) > 0, f"an f32 kernel did not launch on phase 9's "
          f"main path: (K1, K2) f32 launches {f32_main}")
    for rec, i in ((rec_k1_f32, 0), (rec_k2_f32, 1)):
        rec["launches"] = f32_main[i]
        rec["launches_per_eval"] = calls_f32["fast_loss_grad"][i]
        rec["launches_per_call"] = {k: v[i] for k, v in calls_f32.items()}
        rec["registers"] = registers_of(
            registers, KERNEL_TEMPLATES["matern32"][i], "Matern32", "float")

    say("  launches per call (K1, K2): " + ", ".join(
        f"{k} {v}" for k, v in per_call.items()))
    for key in ("loss_grad", "rep_loss_grad"):
        check(per_call[key] == (1, 1),
              f"one {key} evaluation launched {per_call[key]}")
    # the main paths: serving (phases 5, 7 and 8) runs K1, the fits
    # (phases 6 and 8) K1 and K2
    k1_main = k1_serve + k1_fit + k1_rep_serve5 + k1_rep_fit + k1_rep_serve
    for rec, i, launches in ((record, 0, k1_main),
                             (record_vjp, 1, k2_fit + k2_rep_fit)):
        rec["launches"] = launches
        rec["launches_per_eval"] = per_call["loss_grad"][i]
        rec["launches_per_call"] = {k: v[i] for k, v in per_call.items()}
        rec["registers"] = registers_of(
            registers, KERNEL_TEMPLATES["matern32"][i], "Matern32")
    records = [record, record_vjp, rec_k1_f32, rec_k2_f32]
    for rec in records:
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]

    say("[10] Matern 5/2 (K3) and the squared exponential (K4) at config 4 "
        "(n=4096, p=1000, q=20, d=8): the kernels against their plain "
        "versions, f64 and f32, then the model path with each kernel")
    records += phase_kinds(dev, x, y, xte, ytrue, free_np, xs, registers)
    del x, y, xte, ytrue, xs
    torch.cuda.empty_cache()

    say("[11] the FITC inducing-point path at benchmarks/run_configs.py's "
        "configs 6-8 (n=50,000, 400,000 and 2,000,000, d=2, p=20, q=4, "
        "m=256 and 512): K1, K2, K4 and K5 against their plain versions "
        "at config 6's shapes, then the main path")
    fitc_records, m6 = phase_fitc(dev, card, registers)
    records += fitc_records

    say("[12] the prediction server (lcgp_tpu_torch/serve.py) on captured "
        "CUDA graphs: config 4 (n=4096, p=1000, q=20, d=8, f64) at batch "
        "sizes 256, 64 and 8, its rbf reload, FITC config 6 and HTTP")
    x, y, xte, _ = config4()
    counts, serve = phase_serve(dev, card, x, y, xte, free_np, m6)
    del x, y, xte, m6
    # the server's own launches (each capture and its eager warm step);
    # the replays that answer requests run no Python and add none
    by_name = {rec["name"]: rec for rec in records}
    for name, kind, f32 in (("matern32_gram", "matern32", 0),
                            ("rbf_gram", "rbf", 0),
                            ("matern32_gram_fitc_f32", "matern32", 1)):
        n = counts[kind][f32][0]
        check(n > 0, f"{name} did not launch on phase 12's main path")
        by_name[name]["launches"] += n
        by_name[name]["launches_serve"] = n
    record["serve"] = serve

    say(f"[13] the mesh paths (lcgp_tpu_torch/parallel) at config 4 "
        f"(n=4096, p=1000, q=20, d=8, f64): one NCCL rank, then "
        f"{MESH_RANKS} gloo ranks sharing the card")
    t13 = time.perf_counter()
    x, y, xte, _ = config4()
    counts13 = MeshCounts()
    per_call_mesh, peak1 = phase_mesh_one_rank(dev, card, x, y, xte,
                                               free_np, counts13)
    xs = tx.standardize_x(torch.as_tensor(x, dtype=torch.float64,
                                          device=dev))[0].contiguous()
    block = phase_mesh_block_kernels(dev, card, xs)
    del xs
    torch.cuda.empty_cache()
    per_call_block, cut = phase_mesh_shared(dev, card, x, y, xte, free_np,
                                            peak1, counts13)
    say(f"  (K1, K2) launches on the mesh paths: {counts13.total()}; by "
        "shape: " + "; ".join(f"{mesh_shape_label(k)} {tuple(c)}" for k, c
                             in sorted(counts13.by_shape.items())))
    check(min(counts13.total()) > 0,
          "K1 or K2 did not launch on the mesh paths")
    # each launch on one row: the block rows take the ('n',) MESH_RANKS
    # ranks' launches at the block shape, the config-4 rows every other
    block_key = rank_keys(("n", MESH_RANKS), x.shape[0])[0]
    for rec, i, at_block in ((record, 0, False), (record_vjp, 1, False),
                             (block[0], 0, True), (block[1], 1, True)):
        by = {mesh_shape_label(k): c[i] for k, c in
              sorted(counts13.by_shape.items())
              if (k == block_key) == at_block and c[i]}
        rec["launches_mesh"] = sum(by.values())
        rec["launches_mesh_by_shape"] = by
    for rec, i in ((record, 0), (record_vjp, 1)):
        rec["launches"] += rec["launches_mesh"]
        rec["launches_per_call"]["mesh_loss_grad"] = per_call_mesh[i]
    for rec, i in zip(block, (0, 1)):
        rec["launches"] = rec["launches_mesh"]
        rec["launches_per_call"] = ({} if cut else
                                    {"mesh_loss_grad": per_call_block[i]})
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
        check(cut or rec["launches"] > 0, f"{rec['name']} did not launch "
              "at its shape on the mesh paths")
    records += block
    say(f"[13] done in {time.perf_counter() - t13:.1f} s"
        + (f" (the {MESH_RANKS}-rank run cut to n={MESH_CUT_N})" if cut
           else ""))
    del x, y, xte
    torch.cuda.empty_cache()

    say("[14] n-sharded FITC (lcgp_tpu_torch/parallel/fitc_shard.py) at "
        "config 7 (n=400,000, m=512, d=2, p=20, q=4, 'fast'): one NCCL rank "
        f"and {FITC_MESH_RANKS} gloo ranks sharing the card; served mesh "
        "models (config 4 exact, config 6 FITC)")
    t14 = time.perf_counter()
    counts14 = FitcMeshCounts()
    ref7, x0_7, z7, peak1_7, served = phase_fitc_mesh_one_rank(dev, card,
                                                               counts14)
    block14 = phase_fitc_block_kernels(dev, card, fitc_config(7)[0], z7)
    torch.cuda.empty_cache()
    shared = phase_fitc_mesh_shared(dev, card, ref7, x0_7, z7, peak1_7,
                                    counts14)
    shared["served"]["config 4 exact, one NCCL rank"] = served
    by_name = {rec["name"]: rec for rec in records + block14}
    for rec in block14:
        rec["launches"] = 0
    for row, by in sorted(counts14.rows.items()):
        rec = by_name[row]
        rec["launches_fitc_mesh_by_shape"] = by
        rec["launches"] += sum(by.values())
    say("  launches of phase 14's main path by kernel row and shape: "
        + "; ".join(f"{row} {by}" for row, by in sorted(
            counts14.rows.items())))
    for rec in block14:
        check(rec["launches"] > 0, f"{rec['name']} did not launch at its "
              "shape on phase 14's main path")
        rec["share_of_bound"] = rec["bound_ms"] / rec["ms"]
    block14[0]["fitc_mesh"] = shared
    records += block14
    say(f"[14] done in {time.perf_counter() - t14:.1f} s")

    say("[15] the examples (examples/torch_*.py) at their default sizes: "
        "the notebook check, rep-1d, rep-3d, the borehole field at config "
        "3 and the multichip demo on four gloo ranks sharing the card")
    t15 = time.perf_counter()
    torch.cuda.empty_cache()
    records += phase_examples(dev, card)
    say(f"[15] done in {time.perf_counter() - t15:.1f} s")

    say(json.dumps({"kernels": records}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
