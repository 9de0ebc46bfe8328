"""device_idle_pct.batch: the share of the traced window in which no
kernel, copy or set ran on the card, in the plain staged cells."""

from benchmark.metrics_common import idle_pct


def read(run):
    if run.kind != "staged" or run.config["codec"]["temporal"]:
        return None
    return idle_pct(run)
