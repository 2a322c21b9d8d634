"""Find a serve cell's knee: the highest offered rate whose requests keep
up, with no backlog growing through the window.

    python3 h100_bench/sweep.py --workload <serve cell> --seed <n> \\
        --rates 200,400,800 --seconds 6

Sets the cell up once, then runs the cell's open-loop mix at each rate in
turn (its ``rate_per_s`` replaced) and prints, per rate, the requests sent
and completed, p50 and p95 latency, the achieved rate, the p95 of the
window's last third against its first third, and how long after the last
request was due the last one returned (a backlog drains then).  The knee is
read off these lines; the cell's mix then fixes its rate as a number.
"""
import argparse
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path[:0] = [HERE, os.path.dirname(HERE)]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rates", required=True)
    ap.add_argument("--seconds", type=float, default=6.0)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from hb import runner
    from hb.manifest import Manifest

    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    man = Manifest()
    ctx = runner.context(man, args.workload, args.seed, args.seconds, False,
                         "cuda:0", time.perf_counter())
    serve = ctx.kind
    serve.setup(ctx)
    print(f"{args.workload} on {torch.cuda.get_device_name(0)}: set-up "
          f"{time.perf_counter() - ctx.t_start:.2f} s", flush=True)
    for rate in (float(r) for r in args.rates.split(",")):
        traffic = dict(ctx.traffic, rate_per_s=rate)
        sched = serve.schedule(traffic, args.seconds, args.seed,
                               int(ctx.cfg["d"]))
        t_first = time.perf_counter()
        res = serve.open_loop(ctx.model, sched, int(traffic["threads"]),
                              float(traffic["close_wait_s"]))
        elapsed = time.perf_counter() - t_first
        lat = res["lat"]
        third = max(1, len(lat) // 3)
        drain = elapsed - float(sched["offs"][-1])
        print(f"rate {rate:8.1f}/s: sent {res['attempted']}, completed "
              f"{res['attempted'] - res['failed']}, achieved "
              f"{(res['attempted'] - res['failed']) / elapsed:9.2f}/s, p50 "
              f"{np.percentile(lat, 50) * 1e3:9.3f} ms, p95 "
              f"{np.percentile(lat, 95) * 1e3:9.3f} ms, p95 first third "
              f"{np.percentile(lat[:third], 95) * 1e3:9.3f} ms, last third "
              f"{np.percentile(lat[-third:], 95) * 1e3:9.3f} ms, drain "
              f"{drain * 1e3:9.3f} ms, lateness p95 "
              f"{np.percentile(res['late'], 95) * 1e3:.3f} ms", flush=True)
    serve.release(ctx)
    return 0


if __name__ == "__main__":
    sys.exit(main())
