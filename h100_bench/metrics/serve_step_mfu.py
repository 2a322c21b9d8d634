"""serve_step_mfu: predict_batch_ms's closed loop of full-batch requests:
the FLOPs of one dispatch (hb/flops.py, from the shapes) times the
dispatches, over the closed loop's wall time times 67e12 FLOP/s."""
from hb import flops


def read(ctx):
    sub = ctx.sub
    if not sub.get("dispatches"):
        return None
    return (100.0 * flops.dispatch_flops(ctx.cfg, sub["batch"])
            * sub["dispatches"] / (sub["seconds"] * flops.STEP_PEAK_FLOPS))
