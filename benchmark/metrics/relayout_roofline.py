"""relayout_roofline: the relayout of B2's blocks into frames
(``core.blocks.blocks_to_image_torch`` and its copy) against its byte bound
in the packed-block staged cells: its least time per call over its device
time per call, in the traced window. The least time counts the blocks read
once and the frames written once (``peaks.least_s`` of twice the frames'
bytes); the relayout's device time is every device operation of the window
but B2 and the copies and sets."""

from benchmark import peaks
from benchmark.packed import B2, packed


def _relayout(name: str) -> bool:
    return not (B2 in name or name.startswith(("Memcpy", "Memset")))


def read(run):
    if run.trace is None or not packed(run):
        return None
    busy, ops = run.trace.device_s(_relayout)
    if not ops or not sum(run.window.calls) or busy <= 0:
        return None
    least = sum(n * peaks.least_s(2 * s["frame_bytes"])
                for n, s in zip(run.window.calls, run.shapes))
    return 100.0 * least / busy
