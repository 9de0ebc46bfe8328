"""The device trace of a ``--trace 1`` run, read into intervals.

The profiler records the card's operations of the window and, on the
host, the CUDA runtime's calls and the benchmark's own spans alone
(``record_function``: ``window``, and ``call`` or ``request`` around each
call into the port), so spans and device operations share one clock and
no operator of the port is recorded on the host: that would slow the
host's dispatch, which some cells measure. :func:`read` turns the profiler's raw
events into a :class:`Trace`: the device operations (kernels, copies, sets)
and the host's spans and operations, in seconds, inside the window.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
from collections import defaultdict
from dataclasses import dataclass

#: the benchmark's own span names
SPANS = ("window", "call", "request")
#: longest name kept in a breakdown
NAME_CHARS = 96


@dataclass
class Trace:
    """One traced window. Times are seconds from the window's start."""

    window_s: float
    #: (start, end, name) of every device operation, by start
    device: list
    #: name -> [(start, end)] of the benchmark's spans
    spans: dict
    #: (start, end, name) of every host operation of the profiler, by start
    host: list

    def busy(self) -> list[tuple[float, float]]:
        """The union of the device operations, as disjoint intervals."""
        merged: list[list[float]] = []
        for s, e, _ in self.device:
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return [(s, e) for s, e in merged]

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy())

    def device_s(self, match) -> tuple[float, int]:
        """(seconds, count) of the device operations whose name passes
        ``match``."""
        ops = [e - s for s, e, n in self.device if match(n)]
        return sum(ops), len(ops)

    def busy_within(self, spans) -> list[float]:
        """For each (start, end) span: the device's busy seconds inside it."""
        busy = self.busy()
        starts = [s for s, _ in busy]
        out = []
        for a, b in spans:
            k = max(bisect.bisect_right(starts, a) - 1, 0)
            total = 0.0
            while k < len(busy) and busy[k][0] < b:
                total += max(0.0, min(b, busy[k][1]) - max(a, busy[k][0]))
                k += 1
            out.append(total)
        return out

    def host_at(self, t: float) -> str:
        """What the host was doing at ``t``: the innermost benchmark span,
        and the innermost profiler operation running then, if any."""
        span = "window"
        for name in ("call", "request"):
            iv = self.spans.get(name, [])
            k = bisect.bisect_right(iv, (t, float("inf"))) - 1
            if k >= 0 and iv[k][1] >= t:
                span = name
        k = bisect.bisect_right(self.host_starts, t) - 1
        for j in range(k, max(k - 64, -1), -1):
            s, e, name = self.host[j]
            if e >= t:
                return f"{span} > {name}"[:NAME_CHARS]
        return span

    @functools.cached_property
    def host_starts(self) -> list[float]:
        return [s for s, _, _ in self.host]

    def idle_gaps(self) -> list[tuple[float, float]]:
        """The window's spans in which no device operation ran."""
        gaps, t = [], 0.0
        for s, e in self.busy():
            if s > t:
                gaps.append((t, s))
            t = max(t, e)
        if t < self.window_s:
            gaps.append((t, self.window_s))
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle time by
        what the host was doing, each at most ``top``, in seconds."""
        ops: dict[str, float] = defaultdict(float)
        for s, e, n in self.device:
            ops[n[:NAME_CHARS]] += e - s
        idle: dict[str, float] = defaultdict(float)
        for a, b in self.idle_gaps():
            idle[self.host_at((a + b) / 2)] += b - a
        order = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n, s] for n, s in order(ops)],
                "idle_gaps": [[n, s] for n, s in order(idle)]}


class Recorder:
    """The profiler over the window, recording on the host only the
    benchmark's spans (``RecordScope.USER_SCOPE``) and the CUDA runtime."""

    def __init__(self):
        import torch
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, RecordScope,
                                        _ExperimentalConfig)

        self._torch = torch
        self._config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                      False, False, False,
                                      _ExperimentalConfig())
        self._activities = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self._activities.add(ProfilerActivity.CUDA)
        self._scopes = {RecordScope.USER_SCOPE}
        self._result = None

    def span(self, name: str):
        return self._torch.profiler.record_function(name)

    def __enter__(self):
        from torch.autograd import _enable_profiler, _prepare_profiler

        _prepare_profiler(self._config, self._activities)
        _enable_profiler(self._config, self._activities, self._scopes)
        return self

    def __exit__(self, *exc):
        from torch.autograd import _disable_profiler

        self._result = _disable_profiler()

    def read(self) -> Trace | None:
        """The window's :class:`Trace`, or None without a ``window`` span."""
        return read(self._result.events(),
                    self._torch.autograd.DeviceType.CPU)


def read(events, cpu) -> Trace | None:
    """Kineto events -> the :class:`Trace` of the ``window`` span."""
    device, host, spans = [], [], defaultdict(list)
    for ev in events:
        s = ev.start_ns() * 1e-9
        e = s + ev.duration_ns() * 1e-9
        name = ev.name()
        if name in SPANS:
            # the profiler marks a span on the device too, from its first
            # operation to its last: that is no operation
            if ev.device_type() == cpu:
                spans[name].append((s, e))
        elif ev.device_type() != cpu:
            device.append((s, e, name))
        else:
            host.append((s, e, name))
    if len(spans["window"]) != 1:
        return None
    w0, w1 = spans["window"][0]

    def clip(items):
        out = []
        for it in items:
            s, e = max(it[0], w0), min(it[1], w1)
            if e > s or (e == s and w0 <= s <= w1):
                out.append((s - w0, e - w0, *it[2:]))
        return sorted(out)

    return Trace(w1 - w0, clip(device),
                 {k: clip(v) for k, v in spans.items() if k != "window"},
                 clip(host))


def recorder(trace: bool):
    """A :class:`Recorder` when ``trace``, else a context that records
    nothing and whose spans cost nothing."""
    return Recorder() if trace else _Off()


class _Off(contextlib.nullcontext):
    def span(self, name: str):
        return contextlib.nullcontext()

    def read(self):
        return None
