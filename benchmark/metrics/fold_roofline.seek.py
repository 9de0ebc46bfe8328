"""fold_roofline.seek: the fold kernel (``temporal_fold_kernel``) against
its byte bound in the range cells of a temporal (MHVT) configuration: the
least time of the window's folds over the kernel's device time in the
traced window, in percent. A request [a, b) folds frames [kf, b) from the
keyframe kf = keyint * (a // keyint) before a (the benchmark's containers
open a group every keyint frames from frame 0). The fold works in place:
it reads every frame of the span once and writes every frame but the
span's keyframes once, so n frames holding g keyframes move 2n - g frames;
a span of keyframes alone folds nothing and counts nothing. The count is
of the work, whatever implements it."""

from benchmark import peaks

#: the fold kernel in the trace
F1 = "temporal_fold_kernel"


def frames_moved(a: int, b: int, keyint: int) -> int:
    """The frames' worth of bytes the fold of request [a, b) reads and
    writes."""
    n = b - keyint * (a // keyint)
    g = -(-n // keyint)
    return 2 * n - g if n > g else 0


def read(run):
    if (run.trace is None or run.kind != "range"
            or not run.config["codec"]["temporal"]):
        return None
    busy, ops = run.trace.device_s(lambda name: F1 in name)
    if not ops or busy <= 0:
        return None
    keyint = run.config["codec"]["keyint"]
    frame = run.config["height"] * run.config["width"]
    moved = sum(frames_moved(a, b, keyint)
                for a, b, _s, _ok in run.window.calls)
    return 100.0 * peaks.least_s(moved * frame) / busy
