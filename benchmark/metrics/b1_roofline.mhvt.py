"""b1_roofline.mhvt: B1 (``decode_images_kernel``) on the residual planes of
the temporal staged cells, against its byte bound: its least time per call
over its mean device time per launch, in the traced window
(``metrics_common.b1_roofline``)."""

from benchmark.metrics_common import b1_roofline


def read(run):
    return b1_roofline(run) if run.config["codec"]["temporal"] else None
