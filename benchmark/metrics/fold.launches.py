"""fold.launches: the CUDA runtime's kernel launches (``cudaLaunchKernel*``)
that start inside the port's ``fold`` stretches, over those stretches: the
launches of one fold call, in the temporal staged cells."""

from benchmark.spans import launches_within, mhvt


def read(run):
    return launches_within(run, "fold", "call") if mhvt(run) else None
