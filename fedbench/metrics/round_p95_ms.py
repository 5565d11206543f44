"""The 95th percentile of the latency of every round in the window
(linear interpolation between order statistics)."""

import numpy as np


def read(r):
    if len(r.latencies_ms) < 20:
        return None
    return float(np.percentile(np.asarray(r.latencies_ms), 95))
