"""range.copy_ms: the mean device time of the host-to-device and
device-to-host copies per request, from the trace."""


def read(run):
    if run.trace is None or run.kind != "range" or not run.window.calls:
        return None
    busy, n = run.trace.device_s(lambda name: name.startswith("Memcpy"))
    return 1e3 * busy / len(run.window.calls) if n else None
