"""3-output replication case study on the PyTorch port: the same three
designs, checks and lines as ``examples/rep_3d_illustration.py``, run
through ``lcgp_tpu_torch.runner.LCGPRun``.

  uniform — every unique x replicated a few times
  skewed  — heavy replication inside one input region (BASELINE.md 'Case 2')
  hotspot — a few heavily replicated locations, singles elsewhere

For each case this script:
  * fits LCGP (submethod='rep', q=3, per-output error groups) through the
    LCGPRun harness, timing the fit;
  * prints the basis check (diag_D == diag(phi^T phi)), fitted
    hyperparameters, fitted vs true noise std, and replication stats;
  * runs the transform-consistency check: recompose y from the latent
    predictions (Psi @ ghat, un-standardized) and compare to the harness's
    predictive mean, to machine precision;
  * reports RMSE / NRMSE / 95% interval coverage & width / DSS;
  * with --plot, renders the output-space and the latent-GP figures.

Usage: python examples/torch_rep_3d_illustration.py [--case all] [--plot]
       [--cpu] [--json FILE]      (the card by default)
"""
from __future__ import annotations

import argparse
import json
import time
from pathlib import Path

import numpy as np

NOISE_STD = (0.05, 0.08, 0.10)


def host(t):
    """A model tensor as a NumPy array on the host."""
    return t.detach().cpu().numpy() if hasattr(t, 'detach') else \
        np.asarray(t)


def transform_consistency_check(run, predmean, xtest):
    """Recompose the predictive mean from the latent ghat with the model's
    actual Psi = phi * sqrt(sigma2_used) (rep_3d_illustration.py's
    version) and compare with the harness's predictive mean."""
    mdl = run.model
    mdl.predict(xtest, return_fullcov=False)
    ghat = host(mdl.ghat)
    phi = host(mdl.phi)
    lsigma2s = host(mdl.get_param()[2])
    sigma_sqrt = np.sqrt(np.exp(lsigma2s))                  # (p,)
    if mdl.submethod == 'rep':
        if mdl.rep_standardize_ybar:
            scale = host(mdl.ybar_std)[:, 0]
            psi = phi * (sigma_sqrt / scale)[:, None]
            y_from_g = (psi @ ghat) * host(mdl.ybar_std) + \
                host(mdl.ybar_mean)
        else:
            psi = phi * sigma_sqrt[:, None]
            y_from_g = psi @ ghat
    else:
        psi = phi * sigma_sqrt[:, None]
        y_from_g = host(mdl.tx_y(mdl._tensor(psi @ ghat)))
    diff = float(np.max(np.abs(y_from_g - predmean)))
    print(f"[transform check] max |recomposed - harness| = {diff:.3e}")
    return diff


def plot_outputs(case, outdir, xtrain, ytrain, xtest, ytrue, predmean,
                 yconfvar):
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    order = np.argsort(xtest[:, 0])
    fig, ax = plt.subplots(3, 1, figsize=(10, 7), sharex=True)
    for i in range(3):
        ax[i].scatter(xtrain[:, 0], ytrain[i], s=12, alpha=0.6,
                      label='replicates' if i == 0 else None)
        ax[i].plot(xtest[order, 0], ytrue[i, order], lw=1.8,
                   label='true' if i == 0 else None)
        ax[i].plot(xtest[order, 0], predmean[i, order], lw=1.5,
                   label='LCGP mean' if i == 0 else None)
        sd = np.sqrt(yconfvar[i, order])
        ax[i].fill_between(xtest[order, 0], predmean[i, order] - 1.96 * sd,
                           predmean[i, order] + 1.96 * sd, alpha=0.22,
                           label='95% credible band' if i == 0 else None)
        ax[i].set_ylabel(f'$f_{i + 1}(x)$')
    ax[-1].set_xlabel('x')
    ax[0].legend(loc='best', fontsize=9)
    fig.tight_layout()
    out = outdir / f'torch_rep_3d_{case}_outputs.png'
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"  saved {out}")


def plot_latents(case, outdir, run, xtest):
    """Latent g_k(x) means/bands with training-point latent means (mks)."""
    import matplotlib
    matplotlib.use('Agg')
    import matplotlib.pyplot as plt
    mdl = run.model
    mdl.predict(xtest, return_fullcov=False)
    ghat = host(mdl.ghat)
    gstd = np.sqrt(np.maximum(host(mdl.gvar), 0.0))
    x_tr = host(mdl.x_unique)[:, 0]
    order_tr = np.argsort(x_tr)
    ghat_tr = host(mdl.mks)
    order = np.argsort(xtest[:, 0])
    q = ghat.shape[0]
    fig, axes = plt.subplots(q, 1, figsize=(10, 1.9 * q), sharex=True)
    axes = np.atleast_1d(axes)
    for k, ax in enumerate(axes):
        m, s = ghat[k, order], gstd[k, order]
        ax.plot(xtest[order, 0], m, lw=1.8, label=fr'$g_{{{k + 1}}}(x)$ mean')
        ax.fill_between(xtest[order, 0], m - 1.96 * s, m + 1.96 * s,
                        alpha=0.22, label='95% band')
        ax.scatter(x_tr[order_tr], ghat_tr[k, order_tr], s=12, alpha=0.65,
                   label='train pts')
        ax.set_ylabel(fr'$g_{{{k + 1}}}(x)$')
        ax.legend(loc='best', fontsize=8)
    axes[-1].set_xlabel('x')
    fig.tight_layout()
    out = outdir / f'torch_rep_3d_{case}_latents.png'
    fig.savefig(out, dpi=150)
    plt.close(fig)
    print(f"  saved {out}")


def make(case):
    """The original's three designs: (xtrain, ytrain, xtest, ytrue)."""
    from lcgp_tpu_torch import datasets
    if case == 'uniform':
        return datasets.make_rep_data_1d(
            n_unique=16, rep_choices=(1, 2, 3, 4, 5),
            noise_std=NOISE_STD, seed=2025)
    if case == 'skewed':
        return datasets.make_rep_data_skewed(
            n_unique=40, noise_std=NOISE_STD, seed=123)
    return datasets.make_rep_data_hotspots(
        n_unique=50, noise_std=NOISE_STD, seed=7)


def main(argv=None) -> dict:
    """Fit and report each case; returns {case: its metrics}."""
    ap = argparse.ArgumentParser()
    ap.add_argument('--case', choices=['uniform', 'skewed', 'hotspot', 'all'],
                    default='all')
    ap.add_argument('--plot', action='store_true')
    ap.add_argument('--cpu', action='store_true',
                    help='run on the CPU (default: the card)')
    ap.add_argument('--json', help='write the per-case metrics to this file')
    args = ap.parse_args(argv)

    from lcgp_tpu_torch import evaluation
    from lcgp_tpu_torch.runner import LCGPRun

    outdir = Path(__file__).resolve().parent / 'figures'
    if args.plot:
        outdir.mkdir(exist_ok=True)

    cases = (['uniform', 'skewed', 'hotspot'] if args.case == 'all'
             else [args.case])
    results = {}
    for case in cases:
        xtrain, ytrain, xtest, ytrue = make(case)
        run = LCGPRun(runno=f'rep_3d_{case}',
                      data=dict(xtrain=xtrain, ytrain=ytrain, xtest=xtest,
                                ytest=ytrue, ytrue=ytrue),
                      num_latent=3, submethod='rep',
                      err_struct=[1, 1, 1], robust=True,
                      device='cpu' if args.cpu else 'cuda')
        run.define_model()
        t0 = time.time()
        run.train()
        fit_s = time.time() - t0
        predmean, ypredvar, yconfvar = run.predict()

        mdl = run.model
        phi = host(mdl.phi)
        print(f"\n===== case: {case} =====")
        print("=== BASIS ===")
        print(f"diag_D values:        {host(mdl.diag_D)}")
        print(f"phi^T @ phi diagonal: {np.diag(phi.T @ phi)}")
        lLmb, lLmb0, lsigma2s, lnugGPs = map(host, mdl.get_param())
        print("=== FITTED PARAMETERS ===")
        for k in range(lLmb.shape[0]):
            print(f"  lengthscale component {k}: {lLmb[k]}")
        print(f"variances (lLmb0):    {lLmb0}")
        print(f"noise log-var:        {lsigma2s}")
        fitted_noise = np.sqrt(np.exp(lsigma2s))
        print(f"noise std (fitted):   {np.round(fitted_noise, 4)}")
        print(f"noise std (true):     {list(NOISE_STD)}")
        print(f"GP nuggets:           {lnugGPs}")
        r = host(mdl.r)
        print("=== STATS ===")
        print(f"replications: mean {np.mean(r):.2f}  min/max "
              f"{int(np.min(r))}/{int(np.max(r))}  total N {int(np.sum(r))}  "
              f"unique n {len(r)}")
        tdiff = transform_consistency_check(run, predmean, xtest)

        rmse = evaluation.rmse(ytrue, predmean)
        nrmse = evaluation.normalized_rmse(ytrue, predmean)
        cover, width = evaluation.intervalstats(ytrue, predmean, yconfvar)
        dss = evaluation.dss(ytrue, predmean, yconfvar, use_diag=True)
        print("train time (s):", round(fit_s, 3))
        print(f"RMSE: {rmse:.4f}  NRMSE: {nrmse:.4f}")
        print(f"95% PI coverage: {cover:.3f}  width: {width:.4f}")
        print(f"DSS: {dss:.2f}")
        results[case] = dict(
            N=int(np.sum(r)), n_unique=len(r), fit_s=round(fit_s, 3),
            rmse=float(rmse), nrmse=float(nrmse), coverage=float(cover),
            width=float(width), dss=float(dss),
            fitted_noise_std=[round(float(v), 4) for v in fitted_noise],
            transform_check_max_abs=tdiff)

        if args.plot:
            plot_outputs(case, outdir, xtrain, ytrain, xtest, ytrue,
                         predmean, yconfvar)
            plot_latents(case, outdir, run, xtest)

    if args.json:
        with open(args.json, 'w') as f:
            json.dump(results, f, indent=1)
        print(f"\nwrote {args.json}")
    return results


if __name__ == '__main__':
    main()
