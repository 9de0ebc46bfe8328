"""range.stage_ms: the port's ``range.stage`` stretches (from the mark to
the next: ``prepare_shared`` of the frames asked for, the lookup table, the
code words' window, their pageable copy up and byte swap, the offsets) over
the window's requests, in ms."""

from benchmark.spans import per_stretch_ms


def read(run):
    if run.kind != "range":
        return None
    return per_stretch_ms(run, "range.stage", "request")
