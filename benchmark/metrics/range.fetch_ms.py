"""range.fetch_ms: the port's ``range.fetch`` stretches (from the mark to
the ``range.crc`` span: the frames' ``.cpu().numpy()``, the wait on the
card and the pageable copy down) over the window's requests, in ms."""

from benchmark.spans import per_stretch_ms


def read(run):
    if run.kind != "range":
        return None
    return per_stretch_ms(run, "range.fetch", "request")
