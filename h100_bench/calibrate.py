"""The readings the correctness limits are set from, on the card, at the
cell's own size: the program's numbers over many seeds, and the control's
(the reference in the precision below the configuration's, in the
program's place) and, for a fit cell, a planted fault's (half the rows
left out, the loss scaled up) over a few.

    python3 h100_bench/calibrate.py --workload <cell> --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--seconds 3]

One process sets the cell up for each seed in turn and runs its window for
``--seconds``: a fit cell's window runs at least one whole fit, a serve
cell's its open-loop mix at the cell's rate; then it reads the numbers a
run checks.  Prints one line of numbers per seed and
reading, and the largest program reading and smallest control reading of
each number.  The benchmark's runs do not run this.
"""
import argparse
import gc
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def readings(man, cell, seed, seconds, with_control, device="cuda:0"):
    """{'program': numbers, ['control': ..., 'half_batch': ...]} for one
    seed."""
    import torch

    from hb import runner

    ctx = runner.context(man, cell, seed, seconds, False, device,
                         time.perf_counter())
    k = ctx.kind
    k.setup(ctx)
    k.window(ctx)
    k.release(ctx)
    gc.collect()
    if device != "cpu":
        torch.cuda.empty_cache()
    out = {"program": k.numbers(ctx)}
    if with_control:
        out.update(k.stand_in_numbers(ctx))
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    args = ap.parse_args(argv)

    import torch

    from hb.manifest import Manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = Manifest()
    seeds = [int(s) for s in args.seeds.split(",")]
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    worst, least = {}, {}
    for seed in sorted(set(seeds) | ctl):
        t0 = time.perf_counter()
        res = readings(man, args.workload, seed, args.seconds, seed in ctl)
        for kind, nums in res.items():
            print(json.dumps({"seed": seed, "reading": kind, **nums}),
                  flush=True)
            for k, v in nums.items():
                if kind == "program":
                    worst[k] = max(worst.get(k, 0.0), v)
                else:
                    key = (kind, k)
                    least[key] = min(least.get(key, float("inf")), v)
        print(f"seed {seed}: {time.perf_counter() - t0:.1f} s", flush=True)
    print("largest program readings:", json.dumps(worst))
    print("smallest stand-in readings:",
          json.dumps({f"{a}.{b}": v for (a, b), v in least.items()}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
