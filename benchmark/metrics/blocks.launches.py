"""blocks.launches: the CUDA runtime's kernel launches (``cudaLaunchKernel*``)
that start inside the port's ``blocks`` stretches (from the mark at the
start of the packed-block route of ``frame_stream.decode_shared_step`` to
the end of the benchmark's ``call``), over those stretches: the launches of
one call, in the packed-block staged cells."""

from benchmark.packed import packed
from benchmark.spans import launches_within


def read(run):
    return launches_within(run, "blocks", "call") if packed(run) else None
