"""device_idle_pct.b16: the share of the traced window in which no kernel,
copy or set ran on the card, in the packed-block staged cells."""

from benchmark.metrics_common import idle_pct
from benchmark.packed import packed


def read(run):
    return idle_pct(run) if packed(run) else None
