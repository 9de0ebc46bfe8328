"""The one traffic generator: a mix file's parameters -> the window's loop.

A mix (``traffic/<mix>.json``) names its ``kind`` and the numbers of it:

- ``staged``: ``rotations`` frame-order rotations of a ``clip_frames``
  clip, rotation ``v`` rolled by ``v * rotation_frames`` frames, each
  staged in set-up; one host thread queues the calls round-robin with no
  host sync between them, and the window ends with one device sync.
- ``range``: a ``clip_frames`` container; each request asks for ``k`` frames
  from ``a``, ``k`` running through ``frames`` = [least, most] once in each
  block of requests in the seed's order (so every seed asks for the same
  sizes), ``a`` uniform in [0, clip_frames - k]; one client sends each
  request after the last answer (a closed loop).

Both loops keep, for the comparison, the answers of the calls at the
seed's sample points (each a share of the window); the staged loop also
the last call's, the range loop each request longer than any before it.
"""

from __future__ import annotations

import contextlib
import time
from collections.abc import Callable, Iterator
from dataclasses import dataclass, field

import numpy as np


@dataclass
class Window:
    """What one measured window did, on the host clock."""

    start: float = 0.0
    end: float = 0.0
    #: staged: calls per rotation; range: one (a, b, seconds, ok) a request
    calls: list = field(default_factory=list)
    #: call index -> (rotation or (a, b), answer)
    kept: dict = field(default_factory=dict)
    failed: int = 0
    errors: list = field(default_factory=list)

    @property
    def seconds(self) -> float:
        return self.end - self.start


def rotation_orders(mix: dict) -> list[np.ndarray]:
    """The frame order of each rotation of a staged mix."""
    t = mix["clip_frames"]
    return [np.roll(np.arange(t), v * mix["rotation_frames"])
            for v in range(mix["rotations"])]


def range_requests(mix: dict, seed: int) -> Iterator[tuple[int, int]]:
    """The seed's endless request sequence of a range mix: (a, b) pairs."""
    lo, hi = mix["frames"]
    t = mix["clip_frames"]
    rng = np.random.default_rng([seed, 2])
    while True:
        for k in rng.permutation(np.arange(lo, hi + 1)):
            a = int(rng.integers(0, t - k + 1))
            yield a, a + int(k)


def sample_points(seed: int, n: int) -> list[float]:
    """The seed's ``n`` sample points, as shares of the window."""
    return sorted(np.random.default_rng([seed, 3]).random(n).tolist())


def no_span(name: str):
    return contextlib.nullcontext()


def run_staged(calls: list[Callable], seconds: float, points: list[float],
               sync: Callable, span=no_span) -> Window:
    """Queue ``calls`` round-robin for ``seconds``, then ``sync``."""
    win = Window(calls=[0] * len(calls))
    n, i, nk, out = len(calls), 0, 0, None
    with span("window"):
        win.start = now = time.perf_counter()
        deadline = win.start + seconds
        while now < deadline:
            v = i % n
            try:
                with span("call"):
                    out = calls[v]()
            except (RuntimeError, ValueError) as e:
                win.failed += 1
                win.errors.append(repr(e))
                out = None
            if out is not None and nk < len(points) and (
                    now - win.start >= points[nk] * seconds):
                win.kept[i] = (v, out)
                nk += 1
            win.calls[v] += 1
            i += 1
            now = time.perf_counter()
        if out is not None:
            win.kept[i - 1] = ((i - 1) % n, out)
        sync()
        win.end = time.perf_counter()
    return win


def run_range(decode: Callable, requests: Iterator, seconds: float,
              points: list[float], span=no_span) -> Window:
    """Send ``requests`` to ``decode(a, b)`` one after another for
    ``seconds``; keep the answers at the sample points and of the longest
    request first seen."""
    win = Window()
    nk, longest = 0, 0
    with span("window"):
        win.start = time.perf_counter()
        deadline = win.start + seconds
        for j, (a, b) in enumerate(requests):
            t0 = time.perf_counter()
            if t0 >= deadline:
                break
            ok, out = True, None
            try:
                with span("request"):
                    out = decode(a, b)
            except (RuntimeError, ValueError) as e:
                ok = False
                win.failed += 1
                win.errors.append(repr(e))
            t1 = time.perf_counter()
            win.calls.append((a, b, t1 - t0, ok))
            if ok and ((nk < len(points)
                        and t0 - win.start >= points[nk] * seconds)
                       or b - a > longest):
                win.kept[j] = ((a, b), out)
                if b - a > longest:
                    longest = b - a
                else:
                    nk += 1
            win.end = t1
    return win
