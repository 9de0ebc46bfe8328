"""seek.fold_ms: the port's ``fold`` stretches in a range request of a
temporal (MHVT) configuration (from the mark in ``temporal.fold_planes``
to the ``range.fetch`` mark: the fold's host tables, the fold kernel's
launch, the crop, the CRC kernel's launch) over the window's requests, in
ms."""

from benchmark.spans import per_stretch_ms


def read(run):
    if run.kind != "range" or not run.config["codec"]["temporal"]:
        return None
    return per_stretch_ms(run, "fold", "request")
