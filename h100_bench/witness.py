"""A configuration's fit loss along one fit, against three witnesses, on the
card.

    python3 h100_bench/witness.py \\
        --config h100_bench/configs/fitc_n400k_m512.json --seed <n> \\
        [--maxiter 10]

Runs a fit of method 'auto' once from the init and, at the init and at
every iterate the fit's callback hands over, prints one JSON line: the loss
the fit reported, the program's loss at the configuration's precision and
at 'high' (float64), the reference's in float64, in float32 (TF32 off) and
in TF32, and each one's gap to the float64 reference per output entry.  It
shows whether a gap that grows along a fit is the program's or the
precision's.  The benchmark's runs do not run this.
"""
import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--config", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--maxiter", type=int, default=10)
    args = ap.parse_args(argv)

    import torch

    from hb import Context, build_model, check, data_for, inducing_points
    from hb.manifest import Manifest
    from reference import lcgp_ref as R

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    refit = Manifest().kind("refit")
    with open(args.config) as f:
        cfg = {**json.load(f), "fit": {"method": "auto"}}
    ctx = Context(name="witness", cell={}, cfg=cfg, traffic={}, limits={},
                  kind=refit, seed=args.seed, seconds=0.0, traced=False,
                  device=torch.device("cuda:0"), t_start=time.perf_counter())
    ctx.x, ctx.y = data_for(ctx)
    model = build_model(ctx)
    ctx.free0 = tuple(t.detach().clone() for t in model.free)
    seen = refit.run_fit(ctx, model, args.maxiter)["iters"]
    high = build_model(ctx, precision="high")
    prob = R.prepare(ctx.x, ctx.y, int(cfg["model"]["q"]))
    th0 = R.init_free(prob)
    z = inducing_points(ctx, prob)
    per = int(cfg["n"]) * int(cfg["p"])
    refs = {"ref64": refit.lossfn(ctx, prob, z),
            "ref32": check.failing_as_inf(
                refit.lossfn(ctx, prob, z, torch.float32, False)),
            "reftf32": check.failing_as_inf(
                refit.lossfn(ctx, prob, z, torch.float32, True))}
    from lcgp_tpu_torch.models.params import FreeParams
    points = [(0, None, R.flat(th0).cpu().numpy())] + [
        (k, v[0], v[1]) for k, v in sorted(seen.items())]
    for it, reported, vec in points:
        free = R.unflat(vec, th0)
        leaves = [free[k] for k in R.LEAVES]
        with torch.no_grad():
            model.free = FreeParams(*leaves)
            high.free = FreeParams(*leaves)
            row = {"iterate": it, "reported": reported,
                   "program": float(model.loss()),
                   "program_high": float(high.loss())}
        row.update({k: fn(free)[0] for k, fn in refs.items()})
        row.update({f"gap_{k}": (row[k] - row["ref64"]) / per
                    for k in ("reported", "program", "program_high",
                              "ref32", "reftf32")
                    if row[k] is not None})
        print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
