"""Notebook freshness check on the PyTorch port: re-run the illustration
notebook's computation with ``lcgp_tpu_torch`` and hold its key metrics to
the committed ``examples/notebook_metrics.json`` (the JAX package's, written
by ``check_notebook_fresh.py --update``) within that script's tolerances.
The JSON is only read here.

Usage:
  python examples/torch_check_notebook_fresh.py          # on the card
  python examples/torch_check_notebook_fresh.py --cpu    # on the CPU

Exits 1 when a metric drifts beyond its tolerance.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

METRICS_PATH = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                            'notebook_metrics.json')

# check_notebook_fresh.py's: deterministic up to BLAS reduction order;
# fit() is an optimizer, so allow small slack
TOLERANCES = dict(rmse=0.02, nrmse=0.02, coverage=0.03, width=0.02,
                  dss=0.5)


def compute(device):
    """The notebook's metrics and the fit's seconds on ``device``."""
    from lcgp_tpu_torch import LCGP, datasets, evaluation

    xtrain, ytrain, xtest, ytrue = datasets.make_rep_data_skewed(seed=42)
    model = LCGP(y=ytrain, x=xtrain, submethod='rep',
                 diag_error_structure=[1, 1, 1], device=device)
    t0 = time.time()
    model.fit()
    fit_s = time.time() - t0
    ypred, ypredvar, _ = (t.cpu().numpy() for t in model.predict(xtest))
    cover, width = evaluation.intervalstats(ytrue, ypred, ypredvar)
    return dict(
        rmse=float(evaluation.rmse(ytrue, ypred)),
        nrmse=float(evaluation.normalized_rmse(ytrue, ypred)),
        coverage=float(cover),
        width=float(width),
        dss=float(evaluation.dss(ytrue, ypred, ypredvar, use_diag=True)),
    ), fit_s


def main(argv=None) -> dict:
    """Recompute and compare; returns the metrics with ``fit_s`` and
    ``failures`` (one line per drifted metric, empty when fresh)."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (default: the card)')
    args = ap.parse_args(argv)

    got, fit_s = compute('cpu' if args.cpu else 'cuda')
    print('recomputed:', json.dumps(got, indent=1))
    print(f'fit: {fit_s:.2f}s')
    with open(METRICS_PATH) as f:
        want = json.load(f)
    failures = []
    for k, tol in TOLERANCES.items():
        if not abs(got[k] - want[k]) <= tol:
            failures.append(f'{k}: committed {want[k]:.4f} vs '
                            f'recomputed {got[k]:.4f} (tol {tol})')
    if failures:
        print('NOTEBOOK METRICS DRIFTED:\n  ' + '\n  '.join(failures))
    else:
        print('notebook metrics fresh')
    return dict(got, fit_s=fit_s, failures=failures)


if __name__ == '__main__':
    sys.exit(1 if main()['failures'] else 0)
