"""Decode throughput of the shared-table video batch (counterpart of the
repository root's ``bench.py::run_video``).

A batch of ``frames`` frames of ``height`` x ``width`` (synthetic gradients
or the panned bridge photo) is encoded on the host with one shared table,
in ``VARIANTS`` frame-order rotations: the same symbol multiset, so the same
table, but distinct bitstreams staged in distinct device buffers, which the
timed loop round-robins. Each rotation's decode is checked equal to its
frames before any timing. The timed call is
``frame_stream.decode_shared_step(prep, cfg, raw=True)`` on a batch that
``prepare_shared`` staged beforehand: one launch of the image kernel (B1).

Times come from CUDA events on a CUDA device and from the host clock on
the CPU (:func:`..utils.profiling.elapsed_s`). The result is the median of
5 repetitions of ``iters`` calls, with the spread (max - min) / median; the
same-input loop and the per-call latencies are diagnostics on stderr.

    python -m metalhuffman_tpu_torch bench --frames 30 --device cuda
"""

from __future__ import annotations

import sys
import time

import numpy as np

REPS = 5  #: timed repetitions of the round-robin loop
VARIANTS = 4  #: frame-order rotations


def run_video(height: int, width: int, frames: int, iters: int,
              content: str = "synthetic", precoder: str = "delta",
              device="cuda"):
    """Decode GB/s of the batch -> ``(median GB/s, repetitions, spread
    in percent)``. Raises ValueError when a rotation decodes wrong."""
    import torch

    from .models import frame_stream
    from .models.config import CodecConfig
    from .utils import fixtures
    from .utils.profiling import elapsed_s

    dev = torch.device(device)
    cfg = CodecConfig(delta2d=precoder == "delta2d")
    if content == "photo":
        base = fixtures.photo_frames(height, width, frames)
    else:
        base = fixtures.synthetic(frames, height, width)
    variants = min(VARIANTS, frames)
    batches = [np.roll(base, v, axis=0) for v in range(variants)]
    t0 = time.perf_counter()
    streams = [frame_stream.encode_frames_shared(b, cfg) for b in batches]
    t_enc = time.perf_counter() - t0
    preps = [frame_stream.prepare_shared(s, frames, height, width, cfg,
                                         device=dev) for s in streams]
    decodes = [(lambda p=p: frame_stream.decode_shared_step(p, cfg, raw=True))
               for p in preps]
    for v, (d, b) in enumerate(zip(decodes, batches)):
        out = frame_stream.frames_from_raw(d(), frames, height,
                                           width).cpu().numpy()
        if not np.array_equal(out, b):
            raise ValueError(f"decode mismatch on variant {v} "
                             f"({int((out != b).sum())} bytes)")

    def timed_loop(seq, reps: int = REPS) -> list[float]:
        """Seconds of each of ``reps`` runs over the call sequence."""

        def run():
            for d in seq:
                d()

        return [elapsed_s(dev, run) for _ in range(reps)]

    timed_loop(decodes, reps=1)  # warm up
    # the headline: round-robin the distinct batches
    times = timed_loop([decodes[i % variants] for i in range(iters)])
    rates = sorted(base.size * iters / t / 1e9 for t in times)
    gbps = rates[len(rates) // 2]  # median
    spread_pct = 100.0 * (rates[-1] - rates[0]) / gbps if gbps else 0.0
    # diagnostic: the same input every call
    dt_same = min(timed_loop([decodes[0]] * iters, reps=3))
    gbps_same = base.size * iters / dt_same / 1e9
    print(f"per-rep GB/s (n={len(rates)}): "
          + " ".join(f"{r:.2f}" for r in rates)
          + f"  median={gbps:.2f} spread={spread_pct:.1f}%  "
          f"same-input={gbps_same:.2f}", file=sys.stderr)
    dt = sorted(times)[len(times) // 2]
    lat = sorted(elapsed_s(dev, decodes[i % variants]) * 1e3
                 for i in range(3 * variants))
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    ratio = streams[0].compressed_size / base.size
    print(
        f"device={kind} frames={frames} frame={height}x{width} "
        f"iters={iters} content={content} variants={variants} "
        f"precoder={precoder}\n"
        f"encode(host)={t_enc:.2f} s for {variants}x"
        f"{base.size/1e6:.0f} MB  compressed="
        f"{streams[0].compressed_size} B ({ratio:.1%})\n"
        f"decode={dt / iters / frames * 1e3:.3f} ms/frame  "
        f"varied={gbps:.2f} GB/s  same-input={gbps_same:.2f} GB/s  "
        f"({gbps*1e9/(height*width):.0f} FPS-equivalent)\n"
        f"per-call ms (n={len(lat)}): min={lat[0]:.3f} "
        f"p50={lat[len(lat)//2]:.3f} max={lat[-1]:.3f}",
        file=sys.stderr)
    return gbps, len(rates), spread_pct
