"""What more than one metric reader computes."""


def idle_pct(run):
    """The share of the traced window with nothing running on the card, or
    None without a trace or with no device operation in it."""
    tr = run.trace
    if tr is None or not tr.device or tr.window_s <= 0:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def staged_gbps(run):
    """The frames' bytes of every call the window completed, over the whole
    window, in GB/s; None outside a staged mix."""
    if run.kind != "staged":
        return None
    done = sum(n * s["frame_bytes"] for n, s in zip(run.window.calls,
                                                    run.shapes))
    return done / run.window.seconds / 1e9


#: B1's kernel in the trace
B1 = "decode_images_kernel"


def b1_roofline(run):
    """B1's least time per call over its mean device time per launch, in
    percent; None without a trace or a launch. The least time counts every
    staged code word, block offset and the symbol table read once and every
    decoded byte written once (``peaks.decode_least_s``), averaged over the
    window's calls by rotation."""
    from benchmark import peaks

    if run.trace is None or run.kind != "staged":
        return None
    busy, launches = run.trace.device_s(lambda name: B1 in name)
    calls = sum(run.window.calls)
    if not launches or not calls or busy <= 0:
        return None
    least = sum(n * peaks.decode_least_s(s["words"], s["offsets"],
                                         s["symbols"])
                for n, s in zip(run.window.calls, run.shapes)) / calls
    return 100.0 * least / (busy / launches)
