"""loss_grad_ms.fit: host clock around model.loss() and its backward at
the init, outside the optimizer, each ending in a synchronize: the whole
sub-window over its evaluations."""


def read(ctx):
    sub = ctx.sub
    if not sub.get("evals"):
        return None
    return sub["seconds"] * 1e3 / sub["evals"]
