"""The 95th percentile of every request's latency in the window, in ms
(numpy's linear interpolation between order statistics); scoring cells
only."""

import numpy as np


def read(rec):
    if rec["unit"] != "pokes":
        return None
    return float(np.percentile(rec["window"]["latencies"], 95)) * 1e3
