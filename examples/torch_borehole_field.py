"""Borehole-style field emulation on the PyTorch port (BASELINE.json config
3): n=1000 design points, d=8 inputs, p=100-dim output field, q=5 latents;
the same data, fit and lines as ``examples/borehole_field.py``.

Usage: python examples/torch_borehole_field.py [--cpu] [--n 1000] [--p 100]
       [--precision high|fast] [--method scipy|adam|lbfgs-jax]
       (the card by default)
"""
from __future__ import annotations

import argparse
import time


def main(argv=None) -> dict:
    """Fit, predict the held-out fifth and report; returns the metrics."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (default: the card)')
    ap.add_argument('--n', type=int, default=1000)
    ap.add_argument('--p', type=int, default=100)
    ap.add_argument('--q', type=int, default=5)
    ap.add_argument('--precision', default='high', choices=['high', 'fast'])
    ap.add_argument('--method', default='scipy',
                    choices=['scipy', 'adam', 'lbfgs-jax'])
    args = ap.parse_args(argv)

    from lcgp_tpu_torch import LCGP, evaluation, datasets

    x, y = datasets.make_borehole_field(n=args.n, p=args.p, seed=0)
    n_test = args.n // 5
    xte, yte = x[-n_test:], y[:, -n_test:]
    xtr, ytr = x[:-n_test], y[:, :-n_test]

    model = LCGP(y=ytr, x=xtr, q=args.q, precision=args.precision,
                 device='cpu' if args.cpu else 'cuda')
    t0 = time.time()
    model.fit(method=args.method)
    fit_s = time.time() - t0
    ypred, ypredvar, _ = (t.cpu().numpy() for t in model.predict(xte))

    rmse = evaluation.rmse(yte, ypred)
    nrmse = evaluation.normalized_rmse(yte, ypred)
    cover, width = evaluation.intervalstats(yte, ypred, ypredvar)
    print(f"n={xtr.shape[0]} p={args.p} q={model.q} "
          f"precision={args.precision} method={args.method}")
    print(f"fit: {fit_s:.2f}s")
    print(f"test rmse:  {rmse:.5f}")
    print(f"test nrmse: {nrmse:.5f}")
    print(f"coverage: {cover:.3f}  width: {width:.4f}")
    return dict(n=int(xtr.shape[0]), p=args.p, q=int(model.q),
                fit_s=fit_s, rmse=float(rmse), nrmse=float(nrmse),
                coverage=float(cover), width=float(width))


if __name__ == '__main__':
    main()
