"""fold.host_ms: the port's ``fold`` stretches (from the mark at the start
of ``temporal.fold_planes`` to the end of the benchmark's ``call``) over
the window's calls, in ms, in the temporal staged cells. It is traced host
time: each launch carries the profiler's own cost, and the motion vectors'
pageable copy, which waits for the card's queue to drain, is part of it.
The untraced time of a whole call is the window's seconds over its
calls."""

from benchmark.spans import mhvt, per_stretch_ms


def read(run):
    return per_stretch_ms(run, "fold", "call") if mhvt(run) else None
