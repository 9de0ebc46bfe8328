"""range_p95_ms: the 95th percentile (nearest rank) of every request's
time in the window, from the call of the range decode to its return,
failed requests included."""

import math


def read(run):
    if run.kind != "range" or not run.window.calls:
        return None
    times = sorted(c[2] for c in run.window.calls)
    return 1e3 * times[math.ceil(0.95 * len(times)) - 1]
