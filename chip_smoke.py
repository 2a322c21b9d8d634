#!/usr/bin/env python3
"""Smoke run of the PyTorch port (lcgp_tpu_torch) on one CUDA card.

    python3 chip_smoke.py

Phases, each printing its own lines:

1. fail unless CUDA is available; print the card's name and power limit;
2. build the hand-written CUDA kernel K1 (csrc/matern32_gram.cu) from the
   sources in this checkout and print the build time;
3. hold K1 against its plain PyTorch version on the card at the main path's
   shapes (f64 square with epilogue and C0, f64 rectangular), one ragged
   shape and the f32 instantiation, and time both with CUDA events;
4. run the port on the card at n=300 against the NumPy oracle
   ``tests/oracle.py`` (losses rtol 1e-9, predictions rtol 1e-7);
5. drive the main path at BASELINE config 4 (n=4096, p=1000, q=20, d=8)
   with the fitted parameters in ``benchmarks/``: ``loss()``, the
   predictive aux, four ``predict(batch_size=64)`` requests and one
   ``return_fullcov`` request, counting K1 launches.

The line before the last is a JSON object with the kernel table; the last
line is ``{"ok": true, "device": {...}}``.  Any failure exits non-zero
before those lines are printed.  Imports nothing of JAX.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FITTED = ROOT / "benchmarks" / "fitted_params_large_field_n4096_p1000_q20.npz"
K1_SOURCE = "lcgp_tpu_torch/csrc/matern32_gram.cu"
K1_REPLACES = "lcgp_tpu/ops/matern_pallas.py:200 (_fwd_call, deleted in b21a99c; live successor lcgp_tpu/ops/matern.py:27)"
F64_RTOL, F64_ATOL = 1e-12, 1e-14
F32_RTOL, F32_ATOL = 1e-4, 1e-6


def say(msg: str):
    print(msg, flush=True)


def check(cond: bool, what: str):
    if not cond:
        raise AssertionError(what)


def cuda_ms(fn, reps: int = 7) -> float:
    """Median device time of fn() in ms (CUDA events, one warm-up call)."""
    import torch
    fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def config4():
    """BASELINE config 4, exactly as benchmarks/run_configs.py:config4."""
    rng = np.random.default_rng(0)
    n, p, d = 4096, 1000, 8
    x = rng.uniform(0, 1, (n + 256, d))
    t = np.linspace(0, 1, p)[:, None]
    y = (np.sin(2 * np.pi * (t + x[:, :1].T)) + np.cos(np.pi * t * x[:, 1:2].T)
         + 0.05 * rng.standard_normal((p, n + 256)))
    return x[:n], y[:, :n], x[n:], y[:, n:]


def time_pair(label, kernel, plain, nbytes):
    """Kernel and plain times in turns (plain, kernel, kernel, plain), each
    the median of 7 launches; prints the kernel's write rate."""
    p1, k1, k2, p2 = (cuda_ms(fn) for fn in (plain, kernel, kernel, plain))
    k, p = (k1 + k2) / 2, (p1 + p2) / 2
    say(f"  time {label}: kernel {k:.4f} ms ({nbytes / k / 1e6:.0f} GB/s "
        f"written), plain {p:.4f} ms (runs {k1:.4f}/{k2:.4f} vs "
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


def phase_kernels(dev, xs, x0s):
    """Phase 3: K1 against the plain version.  Returns the kernel record."""
    import torch
    from lcgp_tpu_torch.ops import linalg
    from lcgp_tpu_torch.ops.matern import (launch_matern32,
                                           matern32_gram_plain)
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
    del B_k, c0_k, B_p, c0_p
    C_k, _ = launch_matern32(xs, xs, ls, amp, nug, same=True)
    torch.cuda.synchronize()
    check(bool((torch.diagonal(C_k, dim1=-2, dim2=-1) == amp[:, None]).all()),
          "same=True Gram diagonal is not exactly amp")
    errs.append(compare("f64 square C (no epilogue)", C_k,
                        matern32_gram_plain(xs, xs, ls, amp, nug, same=True),
                        F64_RTOL, F64_ATOL))
    del C_k
    torch.cuda.synchronize()
    stack = q * n * n * 8
    k_ms, p_ms = time_pair(f"f64 square+epilogue (aux/loss, q={q} n={n})",
                           k_sq, p_sq, stack)
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
        lambda: launch_matern32(x64, xs, ls, amp, nug, same=False),
        lambda: matern32_gram_plain(x64, xs, ls, amp, nug, same=False),
        q * 64 * n * 8)
    time_pair("f64 rectangular n1=256", k_rect, p_rect, q * 256 * n * 8)

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
                ms=k_ms, plain_ms=p_ms,
                shape=f"square+epilogue f64 q={q} n={n} d={d}",
                request_ms=req_ms, request_plain_ms=req_plain_ms)


def phase_fitted_gram(dev, xs, free_np):
    """K1 at the fitted config-4 parameters, whose lengthscales sit at the
    1e-6 floor.  There the plain version's scale-then-subtract
    (|x1/l - x2/l|, as the JAX package computes it) loses up to
    eps * max|x|/l of each S, while K1 subtracts first.  Every entry where
    the two disagree beyond rtol 1e-12 is recomputed on the host in
    extended precision, and K1 must agree with that within rtol 1e-12."""
    import torch
    from lcgp_tpu_torch.models import params as P
    from lcgp_tpu_torch.convert import free_params_from_numpy
    from lcgp_tpu_torch.ops.matern import (launch_matern32,
                                           matern32_gram_plain)
    ls, amp, _, nug = P.constrain(free_params_from_numpy(*free_np, dev))
    C_k = launch_matern32(xs, xs, ls, amp, nug, same=True)[0]
    C_p = matern32_gram_plain(xs, xs, ls, amp, nug, same=True)
    check(bool(torch.isfinite(C_k).all()), "fitted-params Gram not finite")
    err = (C_k - C_p).abs()
    outside = err > F64_ATOL + F64_RTOL * C_p.abs()
    k, i, j = (a.cpu().numpy() for a in outside.nonzero(as_tuple=True))
    say(f"  fitted config-4 params (min lengthscale {float(ls.min()):.3e}), "
        f"f64 square C: K1 vs plain max_abs_err={float(err.max()):.3e} "
        f"(max |C| {float(C_p.abs().max()):.3e}); {k.size} of {C_p.numel()} "
        f"entries outside rtol {F64_RTOL:g} atol {F64_ATOL:g}")
    if k.size:
        ld = np.longdouble
        X = xs.cpu().numpy().astype(ld)
        L, A, N = (t.cpu().numpy().astype(ld) for t in (ls, amp, nug))
        S = np.abs(X[i] - X[j]) / L[k]
        c0 = np.prod(1 + S, axis=1) * np.exp(-np.sum(S, axis=1))
        ref = np.where(i == j, A[k], A[k] * ((1 - N[k] / (1 + N[k])) * c0))
        got_k = C_k[k, i, j].cpu().numpy().astype(ld)
        got_p = C_p[k, i, j].cpu().numpy().astype(ld)
        rel_k = float(np.max(np.abs(got_k - ref) / np.abs(ref)))
        rel_p = float(np.max(np.abs(got_p - ref) / np.abs(ref)))
        say(f"  at those entries, against extended precision "
            f"({np.finfo(ld).eps:.1e} eps): K1 max_rel_err={rel_k:.3e}, "
            f"plain max_rel_err={rel_p:.3e}")
        check(bool(np.all(np.abs(got_k - ref)
                          <= F64_ATOL + F64_RTOL * np.abs(ref))),
              "K1 at the fitted parameters differs from the extended-"
              "precision reference beyond rtol 1e-12")
    del C_k, C_p, err, outside
    torch.cuda.empty_cache()


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


def profile_main_path(m, xte):
    """Device time by kernel over one aux build and one request."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        m.compute_aux_predictive_quantities()
        m.predict(xte[:64], batch_size=64)
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type == torch.autograd.DeviceType.CUDA]
    events.sort(key=lambda e: e.device_time_total, reverse=True)
    total = sum(e.device_time_total for e in events) / 1e3
    say(f"  profile of one aux + one request: {total:.3f} ms device time "
        "in kernels; top kernels:")
    for e in events[:8]:
        say(f"    {e.device_time_total / 1e3:9.3f} ms  x{e.count:<4d} "
            f"{e.key[:90]}")


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
    check(torch.cuda.is_available(), "lost the card")


def phase_main(dev, x, y, xte, ytrue, free_np):
    """Phase 5: the main path at config 4.  Returns the K1 launch count."""
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
    profile_main_path(m, xte)
    return launches


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs a card",
              file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    say("[1] card (nvidia-smi name, power.limit):")
    say(smi.stdout.strip())
    dev = torch.device("cuda", 0)

    sys.path.insert(0, str(ROOT))
    from lcgp_tpu_torch.ops import _build
    from lcgp_tpu_torch.models import transforms as tx

    lib = _build.build()
    say(f"[2] K1 built in {lib.build_seconds:.2f} s -> {lib.path}")
    for line in lib.log.splitlines():
        if "registers" in line or "spill" in line or "smem" in line:
            say(f"  ptxas: {line.strip()}")

    x, y, xte, ytrue = config4()
    with np.load(FITTED, allow_pickle=False) as z:
        free_np = tuple(z[k] for k in ("lLmb", "lLmb0", "lsigma2s", "lnugGPs"))
    xt = torch.as_tensor(x, dtype=torch.float64, device=dev)
    xs, x_min, x_max = tx.standardize_x(xt)
    x0s = ((torch.as_tensor(xte, dtype=torch.float64, device=dev) - x_min)
           / (x_max - x_min)).contiguous()

    say("[3] K1 against the plain version on the card")
    record = phase_kernels(dev, xs.contiguous(), x0s)
    phase_fitted_gram(dev, xs.contiguous(), free_np)
    del xt, xs, x0s

    say("[4] port on the card vs the NumPy oracle (n=300, p=20, q=4)")
    phase_oracle(dev)

    say("[5] main path at config 4 (n=4096, p=1000, q=20, d=8, f64)")
    record["launches"] = phase_main(dev, x, y, xte, ytrue, free_np)

    say(json.dumps({"kernels": [record]}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
