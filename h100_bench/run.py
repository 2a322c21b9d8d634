"""Run one cell of the H100 benchmark of ``lcgp_tpu_torch`` once.

    python3 h100_bench/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
Set-up (data from the seed, the model, a warm-up of every shape the
cell's traffic uses) counts as ``setup_s``; then the window runs for
``--seconds``, traced by ``torch.profiler`` with ``--trace 1``.  After the
window the run checks what the timed path produced against the plain
reference and prints one JSON line: ``--trace 0`` carries the cell's
end-to-end metrics, ``--trace 1`` its per-layer metrics and a breakdown.
Exits non-zero, printing no result, without the cards, or when JAX or the
JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
sys.path[:0] = [HERE, ROOT]
# a library the port uses could load JAX's flavour of itself: keep it off
os.environ.setdefault("USE_FLAX", "0")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from hb import runner
    from hb.manifest import Manifest

    man = Manifest()
    chips = int(man.cell(args.workload)["chips"])
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"{args.workload} needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              , file=sys.stderr)
        return 2
    torch.cuda.init()
    ctx = runner.context(man, args.workload, args.seed, args.seconds,
                         bool(args.trace), "cuda:0", T_START)
    ctx.mark("CUDA initialisation")
    runner.measure(ctx)
    line = runner.result(man, ctx, chips)
    bad = runner.forbidden_modules()
    if bad:
        print("JAX or the JAX package was loaded: " + ", ".join(bad),
              file=sys.stderr)
        return 3
    runner.report(ctx, line)
    return 0


if __name__ == "__main__":
    sys.exit(main())
