"""Timing and profiling helpers (counterpart of
``metalhuffman_tpu/utils/profiling.py``).

:func:`span` names a stretch of the port's host work for a profiler that
records, and :func:`mark` the start of a stretch that issues device work;
each costs one check when no profiler records. :func:`time_fn` times a device
function with CUDA events on a CUDA device, after synchronizing it, and with
the host clock on the CPU, where the plain versions run synchronously.
:func:`trace` captures a ``torch.profiler`` trace (Chrome trace format) in
place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from pathlib import Path

import torch

#: what :func:`span` returns while no profiler records
_NO_SPAN = contextlib.nullcontext()
#: True while a profiler records: ``torch.profiler.profile`` and the
#: autograd profiler's ``_enable_profiler`` both turn it on
_profiler_enabled = torch._C._autograd._profiler_enabled


def span(name: str):
    """A ``torch.profiler.record_function`` named ``name`` while a profiler
    records, else one shared null context: tracing has no switch of its own.

    Recorded spans sit on the profiler's clock with the device's activity
    and nest on the host thread, so each finds its parent span. A span holds
    host work alone: under CUDA activity the profiler also draws a span on
    the card's timeline, from the first to the last device operation issued
    while it is the innermost, and a reader of the card's busy time would
    count that as work. Where a stretch issues device work, :func:`mark` its
    start instead.
    """
    if _profiler_enabled():
        return torch.profiler.record_function(name)
    return _NO_SPAN


def mark(name: str) -> None:
    """Record a span of no length named ``name`` while a profiler records:
    the start of a stretch of the port's work that issues device
    operations. The stretch runs to the port's next mark or span, or to the
    end of the caller's span around it; nothing is drawn on the card's
    timeline, as no device operation is issued inside the mark."""
    if _profiler_enabled():
        with torch.profiler.record_function(name):
            pass


def tensor_device(x):
    """The device of the first tensor in ``x`` (a tensor, or a tuple or list
    holding tensors), or None."""
    if isinstance(x, torch.Tensor):
        return x.device
    if isinstance(x, (tuple, list)):
        for y in x:
            d = tensor_device(y)
            if d is not None:
                return d
    return None


def elapsed_s(device, fn) -> float:
    """Seconds ``fn()`` takes on ``device``: between two CUDA events on a
    CUDA device (the device synchronized first), on the host clock
    otherwise."""
    device = torch.device(device)
    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def time_fn(fn, *args, iters: int = 10, warmup: int = 2,
            payload_bytes: int = 0):
    """Time a device function: returns (mean seconds, GB/s of
    ``payload_bytes`` per call). The device is that of the arguments'
    tensors, else of the result's, and a call that holds no tensor is
    refused; :func:`elapsed_s` times the ``iters`` calls together."""
    result = None
    for _ in range(max(warmup, 1)):
        result = fn(*args)
    device = tensor_device(args) or tensor_device(result)
    if device is None:
        raise ValueError("time_fn: neither the arguments nor the result "
                         "hold a tensor, so the device to time is unknown")

    def loop():
        for _ in range(iters):
            fn(*args)

    dt = elapsed_s(device, loop) / iters
    return dt, (payload_bytes / dt / 1e9 if payload_bytes else 0.0)


@contextlib.contextmanager
def trace(log_dir: str | Path | None = None):
    """Capture a ``torch.profiler`` trace of the block (the CPU, and the
    CUDA activity where the build supports it) and write it to
    ``log_dir/trace.json`` (Chrome trace format, viewable in Perfetto); a
    new temporary directory when ``log_dir`` is None."""
    log_dir = Path(log_dir or tempfile.mkdtemp(prefix="mht_trace_"))
    log_dir.mkdir(parents=True, exist_ok=True)
    prof = torch.profiler.profile(
        activities=list(torch.profiler.supported_activities()))
    prof.start()
    try:
        yield log_dir
    finally:
        prof.stop()
        prof.export_chrome_trace(str(log_dir / "trace.json"))
