"""b1_roofline: B1 (``decode_images_kernel``) against its byte bound in the
plain staged cells: its least time per call over its mean device time per
launch, in the traced window (``metrics_common.b1_roofline``)."""

from benchmark.metrics_common import b1_roofline


def read(run):
    return None if run.config["codec"]["temporal"] else b1_roofline(run)
