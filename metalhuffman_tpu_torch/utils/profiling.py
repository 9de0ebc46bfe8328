"""Timing and profiling helpers (counterpart of
``metalhuffman_tpu/utils/profiling.py``).

:class:`Timer` is a copy (a wall-clock accumulator with GB/s accounting).
:func:`time_fn` times a device function with CUDA events on a CUDA device,
after synchronizing it, and with the host clock on the CPU, where the plain
versions run synchronously. :func:`trace` captures a ``torch.profiler``
trace (Chrome trace format) in place of ``jax.profiler``'s.
"""

from __future__ import annotations

import contextlib
import tempfile
import time
from dataclasses import dataclass, field
from pathlib import Path


@dataclass
class Timer:
    """Accumulating wall-clock timer with GB/s accounting."""

    name: str = "timer"
    total_s: float = 0.0
    count: int = 0
    bytes_processed: int = 0
    _t0: float = field(default=0.0, repr=False)

    def __enter__(self):
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        self.total_s += time.perf_counter() - self._t0
        self.count += 1
        return False

    def add_bytes(self, n: int) -> None:
        self.bytes_processed += n

    @property
    def mean_s(self) -> float:
        return self.total_s / max(self.count, 1)

    @property
    def gbps(self) -> float:
        return self.bytes_processed / max(self.total_s, 1e-12) / 1e9

    def report(self) -> str:
        s = f"{self.name}: {self.mean_s*1e3:.3f} ms/iter x{self.count}"
        if self.bytes_processed:
            s += f", {self.gbps:.3f} GB/s"
        return s


def tensor_device(x):
    """The device of the first tensor in ``x`` (a tensor, or a tuple or list
    holding tensors), or None."""
    import torch

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
    import torch

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
    import torch

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
