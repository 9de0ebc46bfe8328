"""range.decode_launches: the CUDA runtime's kernel launches
(``cudaLaunchKernel*``) that start inside the port's ``range.decode``
stretches (from the mark before a range request's decode to its
``range.fetch`` mark), over those stretches: the decode's launches and,
where the card checks the per-frame CRC-32s, the CRC kernel's, in the range
cells."""

from benchmark.spans import launches_within


def read(run):
    if run.kind != "range":
        return None
    return launches_within(run, "range.decode", "request")
