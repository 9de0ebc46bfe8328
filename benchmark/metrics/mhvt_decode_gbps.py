"""mhvt_decode_gbps: the true frames' bytes of every MHVT call (decode and
fold) the window completed, over the whole window (from the first call's
enqueue to the device sync after the last), in the temporal staged cells.
Apart from ``decode_gbps`` because the fold's host dispatch makes its runs
spread ten times as wide, which would loosen B1's bound."""

from benchmark.metrics_common import staged_gbps


def read(run):
    return staged_gbps(run) if run.config["codec"]["temporal"] else None
