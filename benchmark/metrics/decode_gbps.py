"""decode_gbps: the frames' bytes of every call the window completed, over
the whole window (from the first call's enqueue to the device sync after
the last), in the plain staged cells."""

from benchmark.metrics_common import staged_gbps


def read(run):
    return None if run.config["codec"]["temporal"] else staged_gbps(run)
