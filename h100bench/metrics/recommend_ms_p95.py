"""End to end: the 95th percentile, in ms, of every batch request of the
window, from the host's first call for the batch (its index gather) until
its results are in host memory."""

import numpy as np


def read(ctx):
    lat = ctx["window"].get("latencies")
    return float(np.percentile(lat, 95)) * 1e3 if lat else None
