"""fit_step_mfu: the FLOPs one loss+grad needs (hb/flops.py, from the
configuration's shapes) times the loss_grad_ms sub-window's evaluations,
over that sub-window's wall time times 67e12 FLOP/s (the H100 SXM's f64
tensor-core and f32 non-tensor rates)."""
from hb import flops


def read(ctx):
    sub = ctx.sub
    if not sub.get("evals"):
        return None
    return (100.0 * flops.loss_grad_flops(ctx.cfg) * sub["evals"]
            / (sub["seconds"] * flops.STEP_PEAK_FLOPS))
