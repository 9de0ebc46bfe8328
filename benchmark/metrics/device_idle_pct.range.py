"""device_idle_pct.range: the share of the traced window in which no
kernel, copy or set ran on the card, in the range cells."""

from benchmark.metrics_common import idle_pct


def read(run):
    return idle_pct(run) if run.kind == "range" else None
