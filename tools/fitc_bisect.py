#!/usr/bin/env python3
"""One device's 'fast' FITC at config 7 on a CUDA card: how far it is from
f64 as n grows, where G = W^T Lam~^-1 W leaves f32 rounding, and the FITC
times before and after G's blocked sum.

    python3 tools/fitc_bisect.py                 # the n scan and G's stage
    python3 tools/fitc_bisect.py --losses        # f64 losses as hex floats
    python3 tools/fitc_bisect.py --times [--package DIR]

Config 7 is ``benchmarks/run_configs.py``'s (n=400,000, m=512, d=2, p=20,
q=4), built as ``chip_smoke.py``'s phase 14 builds it
(``chip_smoke.fitc7_inputs`` / ``fitc7_model``: the farthest-point rows of
the standardized design as inducing points, un-chunked), at the init.

1. **The n scan.**  For each n (a prefix of config 7's rows, the same z),
   the 'fast' model's loss, each gradient leaf and the 64-point
   predictions against the same model in 'high' (f64), on the card.
2. **G's stage** (the largest n).  W and Lam~ from the model's own
   ``sparse._panel`` in f32 on the card, in f32 on the CPU and in f64,
   each f32 one against the f64 one; then G from the card's f32 W and
   Lam~: one f32 GEMM on the card and on the CPU, and
   ``sparse._blocked_wtw`` over blocks of B rows, each against the f64
   product of the same inputs, with its device ms and the 'fast' loss it
   gives (the model's ``_fitc_terms`` with LM = chol(I + G)) against the
   f64 model's loss.
3. ``--losses``: the 'high' losses at config 4 (the committed fit) and
   config 7, and config 7's 'fast' loss, as exact hex floats.
4. ``--times``: 'fast' loss+grad (warm medians, host clock, as the fit
   drivers take it), the aux and a 64-point request at configs 6, 7 and
   8, with ``lcgp_tpu_torch`` from this checkout or from ``--package DIR``
   (another checkout, e.g. the parent commit); run it for both in turns
   in one call to compare them.

Prints one JSON line at the end.  Needs a card; imports nothing of JAX.
"""
from __future__ import annotations

import argparse
import json
import statistics
import sys
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
import chip_smoke as cs  # noqa: E402

if "--package" in sys.argv:
    # lcgp_tpu_torch (imported by chip_smoke's helpers when they run) from
    # another checkout, e.g. the parent commit
    sys.path.insert(0, str(Path(sys.argv[sys.argv.index("--package") + 1])
                           .resolve()))

G_BLOCKS = (4096, 1024, 256, 64)


def say(msg):
    print(msg, flush=True)


def normwise(a, ref):
    """max |a - ref| / max |ref|, in f64 on ref's device, a slice of the
    leading axis at a time."""
    num = top = 0.0
    for k in range(ref.shape[0]):
        r = ref[k].double()
        num = max(num, float((a[k].to(r.device).double() - r).abs().max()))
        top = max(top, float(r.abs().max()))
    return num / max(top, 1e-300)


def scan(dev, x, y, x0, z_orig, n):
    """'fast' against 'high' on the card at the first n rows."""
    out, res = {}, {}
    for prec in ("fast", "high"):
        m = cs.fitc7_model(dev, x[:n], y[:, :n], z_orig, precision=prec)
        vg, z0, flat = cs.flat_vg(m._loss_fn(), m.free)
        v, g = vg(z0)
        if prec == "fast":
            out["loss_grad_s"] = cs.timed_s(lambda: vg(z0))
        g = np.asarray(g, dtype=np.float64)
        leaves, start = {}, 0
        for nm, size in zip(cs.FITC_LEAVES, flat.sizes):
            leaves[nm] = g[start:start + size]
            start += size
        res[prec] = (v, leaves, [t.cpu().numpy() for t in m.predict(x0)])
        del m
    (v, g, p), (v64, g64, p64) = res["fast"], res["high"]
    out["loss_rel"] = abs(v - v64) / abs(v64)
    for nm in g:
        out[f"grad_{nm}"] = float(np.abs(g[nm] - g64[nm]).max()
                                  / np.abs(g64[nm]).max())
    for nm, a, b in zip(("ypred", "ypredvar", "yconfvar"), p, p64):
        out[nm] = float(np.abs(a - b).max() / np.abs(b).max())
    say(f"  n={n}: 'fast' vs 'high' " + ", ".join(
        f"{k} {v:.4g}" for k, v in out.items()))
    return out


def g_stage(dev, x, y, z_orig, n):
    """W, Lam~ and G at the first n rows (see the module's docstring)."""
    import torch
    from lcgp_tpu_torch.models import params as P, sparse
    from lcgp_tpu_torch.ops import linalg
    f32 = torch.float32
    cpu = torch.device("cpu")
    m = cs.fitc7_model(dev, x[:n], y[:, :n], z_orig, precision="high")
    with torch.no_grad():
        l64 = float(m.loss())
    del m
    m = cs.fitc7_model(dev, x[:n], y[:, :n], z_orig, precision="fast")
    out = {}
    with torch.no_grad():
        lfast = float(m.loss())
        data, z, kernel = m._data, m._z, m.kernel
        lLmb, lLmb0, _, lnug = P.constrain(m.free)
        lam, b = sparse._full_lam_b(m.free, data)
        Lmm = sparse._lmm64(z, lLmb, lLmb0, lnug, kernel)

        def panel(where, dt):
            ts = [t.to(where) for t in (data.xs, z, Lmm.to(dt), lLmb,
                                        lLmb0, lnug, lam)]
            return sparse._panel(*ts, compute_dtype=dt, kernel=kernel)
        W64, lt64 = panel(dev, torch.float64)
        Wc, ltc = panel(cpu, f32)
        W, lt = panel(dev, f32)
        for name, card, host, ref in (("W", W, Wc, W64),
                                      ("lam_t", lt, ltc, lt64)):
            out[name] = dict(card=normwise(card, ref), cpu=normwise(host, ref))
            say(f"  {name} f32 against f64 (of the largest entry): card "
                f"{out[name]['card']:.3e}, CPU {out[name]['cpu']:.3e}")
        del W64, lt64, Wc, ltc
        A = W.mT / lt[:, None, :]
        G64 = A.double() @ W.double()

        def terms(G):
            core = sparse.FitcCore(Lmm=Lmm.to(f32), W=W, lam_t=lt,
                                   LM=linalg.cholesky(linalg.add_diag(G,
                                                                      1.0)))
            _, quad, ld = sparse._fitc_terms(core, lam, b)
            return quad, ld
        # the model's own G gives its own 'fast' loss; another G moves the
        # loss by its terms' difference
        quad0, ld0 = terms(sparse._wtw(A, W))

        def loss_rel(G):
            quad, ld = terms(G)
            v = lfast + float(torch.sum(0.5 * (ld - ld0)
                                        - 0.5 * (quad - quad0)))
            return abs(v - l64) / abs(l64)
        out["loss_f64"], out["loss_fast"] = l64, lfast
        gs = {"one GEMM, card": (lambda: A @ W, True),
              "one GEMM, CPU": (lambda: A.cpu() @ W.cpu(), False)}
        for B in G_BLOCKS:
            gs[f"blocks of {B}"] = (
                lambda B=B: sparse._blocked_wtw(A, W, B), True)
        out["G"] = {}
        for name, (fn, on_card) in gs.items():
            G = fn().double().to(dev)
            r = dict(err=normwise(G, G64), loss_rel=loss_rel(G),
                     ms=cs.cuda_ms(fn, reps=3) if on_card else None)
            out["G"][name] = r
            say(f"  G, {name}: {r['err']:.3e} of its largest entry off the "
                f"f64 product; the 'fast' loss {r['loss_rel']:.4e} off f64"
                + (f"; {r['ms']:.3f} ms" if on_card else ""))
    del m
    return out


def losses(dev):
    """The 'high' (f64) losses at config 4 (the committed fit) and config 7
    (the init), and config 7's 'fast' loss, as exact hex floats."""
    import torch
    from lcgp_tpu_torch import LCGP
    from lcgp_tpu_torch.convert import free_params_from_numpy
    x, y, _, _ = cs.config4()
    with np.load(cs.FITTED, allow_pickle=False) as z:
        free = [z[k] for k in ("lLmb", "lLmb0", "lsigma2s", "lnugGPs")]
    m = LCGP(y, x, q=20, device=dev)
    m.free = free_params_from_numpy(*free, dev)
    out = {"config4_high": float(m.loss())}
    del m
    x, y, _, z_orig = cs.fitc7_inputs()
    for prec in ("high", "fast"):
        m = cs.fitc7_model(dev, x, y, z_orig, precision=prec)
        with torch.no_grad():
            out[f"config7_{prec}"] = float(m.loss())
        del m
        torch.cuda.empty_cache()
    for k, v in out.items():
        say(f"  {k}: {v.hex()} ({v:.17g})")
    return out


def times(dev):
    """'fast' FITC at configs 6, 7 and 8 at the init: warm medians of a
    loss+grad in the free parameters, the aux and a 64-point request."""
    import torch
    from lcgp_tpu_torch import LCGP
    out = {}
    for idx, reps in ((6, 7), (7, 5), (8, 3)):
        x, y, xte, _, kw = cs.fitc_config(idx)
        m = LCGP(y, x, precision="fast", device=dev, **kw)
        x0 = xte[:64]
        cs.fitc_loss_grad(m, with_z=False)
        r = out[f"config{idx}"] = {}
        for name, fn in (
                ("loss_grad_s", lambda: cs.fitc_loss_grad(m, with_z=False)),
                ("aux_s", m.compute_aux_predictive_quantities),
                ("request_s", lambda: m.predict(x0))):
            r[name] = statistics.median(cs.timed_s(fn) for _ in range(reps))
        say(f"  config {idx} 'fast' (n={m.n}, n_chunk={m.n_chunk}), warm "
            f"medians of {reps}: " + ", ".join(f"{k} {v:.5f}"
                                                for k, v in r.items()))
        del m
        torch.cuda.empty_cache()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--n", type=int, nargs="+",
                    default=[100_000, 200_000, 400_000])
    ap.add_argument("--losses", action="store_true",
                    help="only print the f64 losses at configs 4 and 7 and "
                         "config 7's 'fast' loss, as exact hex floats")
    ap.add_argument("--times", action="store_true",
                    help="only time 'fast' FITC at configs 6, 7 and 8")
    ap.add_argument("--package", metavar="DIR",
                    help="import lcgp_tpu_torch from the checkout at DIR")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("fitc_bisect: needs a CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    from lcgp_tpu_torch.ops._build import build
    import lcgp_tpu_torch
    say(f"lcgp_tpu_torch from {Path(lcgp_tpu_torch.__file__).parent}; "
        f"built in {build().build_seconds:.1f} s; torch {torch.__version__}, "
        f"CUDA {torch.version.cuda}, {torch.cuda.get_device_name(0)}")
    if args.losses:
        print(json.dumps(losses(dev)))
        return 0
    if args.times:
        print(json.dumps(times(dev)))
        return 0
    x, y, x0, z_orig = cs.fitc7_inputs()
    res = {"scan": {n: scan(dev, x, y, x0, z_orig, n) for n in args.n}}
    res["g_stage"] = g_stage(dev, x, y, z_orig, max(args.n))
    print(json.dumps(res, default=float))
    return 0


if __name__ == "__main__":
    sys.exit(main())
