"""fold_roofline: the temporal fold's least time per call over its
device time per call, in the traced window. The least time counts the
residual frames read once and the true frames written once
(``peaks.fold_least_s``); the fold's device time is every device operation
of the window but B1 and the copies and sets."""

from benchmark import peaks

from benchmark.metrics_common import B1


def _fold(name: str) -> bool:
    return not (B1 in name or name.startswith(("Memcpy", "Memset")))


def read(run):
    if (run.trace is None or run.kind != "staged"
            or not run.config["codec"]["temporal"]):
        return None
    busy, ops = run.trace.device_s(_fold)
    calls = sum(run.window.calls)
    if not ops or not calls or busy <= 0:
        return None
    least = sum(n * peaks.fold_least_s(s["frame_bytes"])
                for n, s in zip(run.window.calls, run.shapes))
    return 100.0 * least / busy
