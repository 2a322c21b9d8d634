"""predict_p50_ms: median latency of the window's completed requests,
each timed from when it was due to the return of PredictServer.predict."""
import numpy as np


def read(ctx):
    lat = ctx.window.get("lat")
    return float(np.percentile(lat, 50)) * 1e3 if lat is not None and len(
        lat) else None
