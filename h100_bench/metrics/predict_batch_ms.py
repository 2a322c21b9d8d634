"""predict_batch_ms: the latency of a full-batch request on its own: the
closed loop after the open loop sends ``batch`` points at a time from one
client, back to back; its time over its requests (host clock)."""


def read(ctx):
    sub = ctx.sub
    if not sub.get("requests"):
        return None
    return sub["seconds"] * 1e3 / sub["requests"]
