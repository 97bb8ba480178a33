"""``solve_ms_p95``: the 95th percentile (linear interpolation) of the host
clock's time from the entry call to a usable result, over every request
of the window, in ms."""

import numpy as np


def read(ctx):
    if not ctx.latencies_s:
        return None
    return float(np.percentile(ctx.latencies_s, 95)) * 1e3
