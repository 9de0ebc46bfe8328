"""range.host_ms: the mean over requests of the benchmark's ``request``
span less the device's busy time inside it: the host work of a request
(slicing, staging, launches, the fetch's host side, the CRC-32 of the
frames)."""


def read(run):
    if run.trace is None or run.kind != "range" or not run.trace.device:
        return None
    spans = run.trace.spans.get("request", [])
    if not spans:
        return None
    inside = run.trace.busy_within(spans)
    host = [(e - s) - d for (s, e), d in zip(spans, inside)]
    return 1e3 * sum(host) / len(host)
