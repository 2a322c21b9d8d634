"""1-D, 3-output replication illustration on the PyTorch port: the same
three designs and lines as ``examples/rep_1d_illustration.py``, fitted with
``lcgp_tpu_torch``.

Three replication designs over the same smooth 3-output truth:
  uniform — every unique x replicated 1-5 times
  skewed  — heavy replication inside one input region (BASELINE.md 'Case 2')
  hotspot — a few heavily replicated locations

For each: fit LCGP (submethod='rep'), report RMSE / NRMSE / 95% coverage &
width / DSS / fitted-vs-true noise std, optionally plot.

Usage: python examples/torch_rep_1d_illustration.py [--case skewed] [--plot]
       [--cpu]      (the card by default)
"""
from __future__ import annotations

import argparse
import time

import numpy as np

NOISE_STD = (0.05, 0.08, 0.10)


def make(case, seed):
    """The original's three designs: (xtrain, ytrain, xtest, ytrue)."""
    from lcgp_tpu_torch import datasets
    if case == 'uniform':
        return datasets.make_rep_data_1d(
            n_unique=16, rep_choices=(1, 2, 3, 4, 5),
            noise_std=NOISE_STD, seed=seed)
    if case == 'skewed':
        return datasets.make_rep_data_skewed(
            n_unique=40, noise_std=NOISE_STD, seed=42)
    # hotspot: few heavily replicated locations
    rng = np.random.default_rng(seed)
    x_unique = np.linspace(0, 1, 50)
    hot = {np.argmin(np.abs(x_unique - c)): (lo, hi)
           for c, lo, hi in ((0.15, 10, 15), (0.50, 18, 25),
                             (0.80, 12, 20))}
    xs, ys = [], []
    for i, xi in enumerate(x_unique):
        r = int(rng.integers(*hot[i]) + 1) if i in hot else 1
        yi = datasets.f_true_1d([xi])[:, 0]
        for _ in range(r):
            xs.append([xi])
            ys.append(yi + rng.normal(0, NOISE_STD, 3))
    xtest = np.linspace(0, 1, 400)[:, None]
    return (np.array(xs), np.array(ys).T, xtest,
            datasets.f_true_1d(xtest[:, 0]))


def plot(case, xtrain, ytrain, xtest, ytrue, ypred, ypredvar):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.5))
    sd = np.sqrt(ypredvar)
    for j, ax in enumerate(axes):
        ax.plot(xtest[:, 0], ytrue[j], 'k-', lw=1, label='truth')
        ax.plot(xtest[:, 0], ypred[j], 'C0-', label='LCGP mean')
        ax.fill_between(xtest[:, 0], ypred[j] - 1.96 * sd[j],
                        ypred[j] + 1.96 * sd[j], alpha=0.25)
        ax.plot(xtrain[:, 0], ytrain[j], 'C3.', ms=3, alpha=0.4)
        ax.set_title(f'output {j + 1}')
    axes[0].legend()
    fig.suptitle(f'LCGP rep — {case}')
    fig.tight_layout()
    out = f'examples/torch_rep_1d_{case}.png'
    fig.savefig(out, dpi=120)
    print(f"  saved {out}")


def main(argv=None) -> dict:
    """Fit and report each case; returns {case: its metrics}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--case', choices=['uniform', 'skewed', 'hotspot', 'all'],
                    default='all')
    ap.add_argument('--plot', action='store_true')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (default: the card)')
    ap.add_argument('--seed', type=int, default=2025)
    args = ap.parse_args(argv)

    from lcgp_tpu_torch import LCGP, evaluation
    device = 'cpu' if args.cpu else 'cuda'

    cases = (['uniform', 'skewed', 'hotspot'] if args.case == 'all'
             else [args.case])
    results = {}
    for case in cases:
        xtrain, ytrain, xtest, ytrue = make(case, args.seed)
        model = LCGP(y=ytrain, x=xtrain, submethod='rep',
                     diag_error_structure=[1, 1, 1], device=device)
        t0 = time.time()
        model.fit()
        fit_s = time.time() - t0
        ypred, ypredvar, yconfvar = (t.cpu().numpy()
                                     for t in model.predict(xtest))

        rmse = evaluation.rmse(ytrue, ypred)
        nrmse = evaluation.normalized_rmse(ytrue, ypred)
        cover, width = evaluation.intervalstats(ytrue, ypred, ypredvar)
        dss = evaluation.dss(ytrue, ypred, ypredvar, use_diag=True)
        fitted_noise = np.sqrt(np.exp(model.lsigma2s.cpu().numpy()))

        print(f"[{case}] N={xtrain.shape[0]} n_unique={model.n} "
              f"fit={fit_s:.2f}s")
        print(f"  rmse={rmse:.4f} nrmse={nrmse:.4f} "
              f"coverage={cover:.3f} width={width:.4f} dss={dss:.2f}")
        print(f"  fitted noise std={np.round(fitted_noise, 3)} "
              f"vs true {NOISE_STD}")
        results[case] = dict(
            N=int(xtrain.shape[0]), n_unique=int(model.n), fit_s=fit_s,
            rmse=float(rmse), nrmse=float(nrmse), coverage=float(cover),
            width=float(width), dss=float(dss),
            fitted_noise_std=[float(v) for v in fitted_noise])

        if args.plot:
            plot(case, xtrain, ytrain, xtest, ytrue, ypred, ypredvar)
    return results


if __name__ == '__main__':
    main()
