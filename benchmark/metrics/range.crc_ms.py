"""range.crc_ms: the port's ``range.crc`` spans (each frame's CRC-32
against the container's table, on the host) over the window's requests,
in ms."""

from benchmark.spans import per_stretch_ms


def read(run):
    if run.kind != "range":
        return None
    return per_stretch_ms(run, "range.crc", "request")
