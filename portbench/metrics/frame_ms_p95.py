"""frame_ms_p95: the 95th percentile of every frame time of the window
(end event to end event, CUDA events)."""

import numpy as np


def read(ctx):
    times = ctx["window"]["frame_ms"]
    if ctx["mode"] != "hybrid" or not times:
        return None
    return float(np.percentile(times, 95))
