"""The ``open_loop`` traffic: requests to ``PredictServer.predict`` at a
fixed offered rate, from independent users.

Arrivals are Poisson and request sizes log-uniform integers between the
mix's bounds; inputs are uniform over the training box.  Every seed sends
the same set of sizes and inter-arrival gaps (the quantiles of their laws),
in an order and with inputs drawn from the seed, so that seeds differ in
order and values and not in work.  A pool of sender threads calls the
in-process server; each request is timed from when it was due, so a stall
delays the requests queued behind it.  The generator's own lateness (a
request handed to the pool after it was due) is reported apart.  The
window's last ``batch_seconds`` send full-batch requests back to back
from one client instead: ``predict_batch_ms``, a latency without queueing.
"""
from __future__ import annotations

import queue
import sys
import threading
import time

import numpy as np
import torch

from hb import build_model, check, data_for, inducing_points
from hb.manifest import ROOT
from reference import lcgp_ref as R


def schedule(traffic: dict, seconds: float, seed: int, d: int) -> dict:
    """Due offsets (s), sizes, inputs and the checked sample of one window."""
    rate = float(traffic["rate_per_s"])
    lo, hi = int(traffic["size_min"]), int(traffic["size_max"])
    n = max(1, int(round(rate * seconds)))
    rng = np.random.default_rng(int(seed))
    u = (np.arange(n) + 0.5) / n
    sizes = np.floor(np.exp(np.log(lo) + rng.permutation(u)
                            * (np.log(hi + 1) - np.log(lo)))).astype(int)
    sizes = np.clip(sizes, lo, hi)
    gaps = -np.log1p(-rng.permutation(u)) / rate
    offs = np.cumsum(gaps)
    ends = np.cumsum(sizes)
    x = rng.uniform(0.0, 1.0, (int(ends[-1]), d))
    k = min(int(traffic["check_requests"]), n)
    keep = set(int(i) for i in rng.choice(n, size=k, replace=False))
    keep.add(int(np.argmax(sizes)))
    return dict(offs=offs, sizes=sizes, starts=ends - sizes, x=x, keep=keep)


def request(sched: dict, i: int) -> np.ndarray:
    s = int(sched["starts"][i])
    return sched["x"][s:s + int(sched["sizes"][i])]


def open_loop(srv, sched: dict, threads: int, close_wait: float) -> dict:
    """Send every request of ``sched`` at its due time through ``threads``
    sender threads; wait for each (up to ``close_wait`` seconds past the
    last due time).  The senders are daemon threads, so a request that
    never returns is counted failed and keeps no process alive."""
    n = len(sched["sizes"])
    lat = np.full(n, np.nan)
    late = np.zeros(n)
    kept, lock = {}, threading.Lock()
    keep = sched["keep"]
    work: queue.SimpleQueue = queue.SimpleQueue()

    def sender():
        while True:
            item = work.get()
            if item is None:
                return
            i, due = item
            try:
                res = srv.predict(request(sched, i))
            except Exception as e:  # noqa: BLE001 — counted as failed
                print(f"request {i} failed: {e!r}", file=sys.stderr)
                continue
            lat[i] = time.perf_counter() - due
            if i in keep:
                with lock:
                    kept[i] = res

    pool = [threading.Thread(target=sender, daemon=True)
            for _ in range(threads)]
    for t in pool:
        t.start()
    t0 = time.perf_counter() + 0.01
    for i in range(n):
        due = t0 + float(sched["offs"][i])
        delay = due - time.perf_counter()
        if delay > 0:
            time.sleep(delay)
        late[i] = time.perf_counter() - due
        work.put((i, due))
    for _ in pool:
        work.put(None)
    end = t0 + float(sched["offs"][-1]) + close_wait
    for t in pool:
        t.join(timeout=max(0.0, end - time.perf_counter()))
    with lock:
        done = ~np.isnan(lat)
        kept = dict(kept)
    return dict(lat=lat[done], late=late, attempted=n,
                failed=int(n - done.sum()), kept=kept,
                rows=int(np.sum(sched["sizes"][done])),
                seconds=time.perf_counter() - t0)


def _committed(ctx) -> dict:
    """The configuration's committed fit, free parameters by leaf: a file
    that the program and the reference both read."""
    with np.load(ROOT / ctx.cfg["serve"]["params"], allow_pickle=False) as f:
        return {k: f[k] for k in R.LEAVES}


def _served_free(ctx, prob) -> dict:
    """The served parameters: the committed fit or the reference's own
    init."""
    if ctx.cfg["serve"]["params"] == "init":
        return R.init_free(prob)
    return {k: torch.as_tensor(v, dtype=torch.float64, device=prob.xs.device)
            for k, v in _committed(ctx).items()}


def setup(ctx):
    from lcgp_tpu_torch.serve import PredictServer
    from lcgp_tpu_torch.models.params import FreeParams
    cfg = ctx.cfg
    ctx.x, ctx.y = data_for(ctx)
    ctx.mark("data")
    model = build_model(ctx)
    if cfg["serve"]["params"] != "init":
        committed = _committed(ctx)
        model.free = FreeParams(*(committed[k] for k in R.LEAVES))
    ctx.mark("construction")
    ctx.model = PredictServer(model, batch_size=int(cfg["serve"]["batch"]))
    ctx.mark("aux, graph capture and one full dispatch (builds or loads "
             "the kernel library)")
    # a short burst of the mix through the senders
    warm = schedule(dict(ctx.traffic, rate_per_s=200.0, check_requests=0),
                    0.1, ctx.seed, int(cfg["d"]))
    open_loop(ctx.model, warm, int(ctx.traffic["threads"]), 60.0)
    ctx.mark("warm-up requests")


def _batch_seconds(ctx) -> float:
    return min(float(ctx.traffic["batch_seconds"]), ctx.seconds / 2)


def open_loop_window(ctx, seconds: float):
    t = ctx.traffic
    ctx.sched = schedule(t, seconds, ctx.seed, int(ctx.cfg["d"]))
    ctx.window = open_loop(ctx.model, ctx.sched, int(t["threads"]),
                           float(t["close_wait_s"]))
    late = ctx.window["late"]
    print(f"generator lateness: median {np.median(late) * 1e3:.4f} ms, "
          f"p95 {np.percentile(late, 95) * 1e3:.4f} ms, max "
          f"{late.max() * 1e3:.4f} ms over {len(late)} requests",
          file=sys.stderr)


def window(ctx):
    """The open loop for the window's time less the mix's
    ``batch_seconds``, then the closed loop of full batches for those."""
    bs = _batch_seconds(ctx)
    open_loop_window(ctx, ctx.seconds - bs)
    ctx.sub = full_batch_subwindow(ctx, bs)


def traced_window(ctx):
    from hb.trace import traced
    with traced() as held:
        open_loop_window(ctx, min(ctx.seconds,
                                  float(ctx.traffic["trace_seconds"])))
    ctx.trace = held.trace
    ctx.sub = full_batch_subwindow(ctx, _batch_seconds(ctx))


def full_batch_subwindow(ctx, seconds: float) -> dict:
    """Full ``batch`` requests back to back, closed loop, until ``seconds``
    have passed (at least three): one dispatch each.  The last answer is
    kept for the check."""
    srv = ctx.model
    bs = int(ctx.cfg["serve"]["batch"])
    x0 = np.random.default_rng(int(ctx.seed) + 1).uniform(
        0.0, 1.0, (bs, int(ctx.cfg["d"])))
    calls0 = srv._fn.calls
    n = 0
    t0 = time.perf_counter()
    while n < 3 or time.perf_counter() - t0 < seconds:
        last = srv.predict(x0)
        n += 1
    return dict(dispatches=srv._fn.calls - calls0, requests=n,
                seconds=time.perf_counter() - t0, batch=bs, x0=x0,
                last=last)


def release(ctx):
    if ctx.model is not None:
        ctx.model.shutdown()
    ctx.model = None


def numbers(ctx, stand_in=None) -> dict:
    """The serve cell's compared numbers over the checked sample of the
    open loop and the closed loop's last full batch: each request's
    (ypred, ypredvar, yconfvar) as served, against the reference worked
    out from the raw inputs at the served parameters; or, with
    ``stand_in`` ((dtype, tf32), the control), that reference in the lower
    precision in the program's place.  A sampled request that never came
    back reads infinity."""
    prob = R.prepare(ctx.x, ctx.y, int(ctx.cfg["model"]["q"]))
    free = _served_free(ctx, prob)
    z = inducing_points(ctx, prob)
    served = [(request(ctx.sched, i), ctx.window["kept"].get(i))
              for i in sorted(ctx.sched["keep"])]
    served.append((ctx.sub["x0"], ctx.sub["last"]))
    x0 = torch.as_tensor(np.concatenate([x for x, _ in served]),
                         dtype=torch.float64, device=prob.xs.device)

    def predict(dtype=torch.float64, tf32=False):
        outs = []
        with check.precision(dtype, tf32):
            for s in range(0, x0.shape[0], 2048):
                part = x0[s:s + 2048]
                outs.append(R.fitc_predict(free, prob, z, part, dtype)
                            if z is not None
                            else R.exact_predict(free, prob, part, dtype))
        return [torch.cat([o[i] for o in outs], dim=1) for i in range(3)]

    ref = predict()
    alt = predict(*stand_in) if stand_in is not None else None
    ymad = prob.ymad.cpu().numpy()
    mean = var = 0.0
    ofs = 0
    for x, got in served:
        k = x.shape[0]
        r = [t[:, ofs:ofs + k] for t in ref]
        if alt is not None:
            got = [t[:, ofs:ofs + k].cpu().numpy() for t in alt]
        ofs += k
        if got is None:
            return dict(mean_gap=float("inf"), var_gap=float("inf"))
        m, v = check.serve_gaps(got, r, ymad)
        mean, var = max(mean, m), max(var, v)
    return dict(mean_gap=mean, var_gap=var)


def stand_in_numbers(ctx) -> dict:
    """The control's numbers, for setting limits."""
    return {"control": numbers(
        ctx, stand_in=check.CONTROL[ctx.cfg["model"]["precision"]])}
