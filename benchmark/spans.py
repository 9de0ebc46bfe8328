"""What the readers of the port's own marks and spans compute.

Under a profiler the port marks where each stretch of its work that issues
device operations starts (``metalhuffman_tpu_torch.utils.profiling.mark``,
a span of no length): ``range.stage``, ``range.decode`` and
``range.fetch`` in a range request, ``fold`` in an MHVT call. It spans
``range.crc``, host work alone (``profiling.span``). A mark's stretch runs
to the port's next mark or span inside the benchmark's ``request`` or
``call``, else to that span's end; a span's is the span. Neither holds a
device operation, so the profiler draws neither on the card's timeline,
where :mod:`benchmark.trace` would keep it among the card's work. The
:class:`~benchmark.trace.Recorder` keeps both among the trace's host
operations, on the device's clock. A program without them reads nothing.
"""

from __future__ import annotations

import bisect

#: the port's marks and spans that open a stretch
PORT = ("range.stage", "range.decode", "range.fetch", "range.crc", "fold")
#: those of them that are spans, each its own stretch
PORT_SPANS = ("range.crc",)


def mhvt(run) -> bool:
    """Whether the run is a temporal staged cell's."""
    return run.kind == "staged" and run.config["codec"]["temporal"]


def stretches(trace, name: str, per: str) -> list[tuple[float, float]]:
    """(start, end) of the stretch that each of the port's marks or spans
    named ``name`` opens inside a benchmark span ``per`` (``request`` or
    ``call``), by start; one outside every ``per`` span is left out."""
    each = trace.spans.get(per, [])
    heads = [s for s, _ in each]
    port = sorted(s for s, _, n in trace.host if n in PORT)
    out = []
    for s, e, n in trace.host:
        if n != name:
            continue
        k = bisect.bisect_right(heads, s) - 1
        if k < 0 or each[k][1] < e:
            continue
        if n not in PORT_SPANS:
            j = bisect.bisect_right(port, s)
            e = each[k][1] if j == len(port) else min(each[k][1], port[j])
        out.append((s, e))
    return out


def per_stretch_ms(run, name: str, per: str):
    """The total time of the port's ``name`` stretches over the benchmark's
    ``per`` spans of the window, in ms; None without a device trace (one
    with a device operation) or without either."""
    if run.trace is None or not run.trace.device:
        return None
    got = stretches(run.trace, name, per)
    each = run.trace.spans.get(per, [])
    if not got or not each:
        return None
    return 1e3 * sum(e - s for s, e in got) / len(each)


def launches_within(run, name: str, per: str):
    """The CUDA runtime's kernel launches (``cudaLaunchKernel*``) that start
    inside the port's ``name`` stretches, over those stretches; None
    without a device trace or without such a stretch."""
    tr = run.trace
    if tr is None or not tr.device:
        return None
    got = stretches(tr, name, per)
    if not got:
        return None
    starts = [s for s, _, n in tr.host if n.startswith("cudaLaunchKernel")]
    n = sum(bisect.bisect_left(starts, b) - bisect.bisect_left(starts, a)
            for a, b in got)
    return n / len(got)
