#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

Run from the root of the checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit (nvcc):

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Build the CUDA kernel library from ``metalhuffman_tpu_torch/csrc`` (nvcc,
   sm_90a) and print the build time.
2. Phase A: the kernel against its plain PyTorch version on the same CUDA
   inputs, byte for byte (tolerance 0: the codec is lossless integer
   arithmetic), and both against the source frames.
3. Phase B: the main path at full size -- host encode of a 30-frame
   2048x1536 batch, ``prepare_shared`` on the card, one kernel launch through
   ``decode_shared_step(raw=True)``, ``frames_from_raw`` -- for synthetic and
   photographic content, the 2-D predictor, 30 frames of 1920x1080, and
   ``decode_video`` of an MHTV container with its CRC check. The kernel's
   launch count over this phase must match the decodes it made.
4. Times: the kernel against its plain version, byte for byte, on each
   staged 30x2048x1536 input, then the median of timed decodes of that batch,
   kernel and plain version, with CUDA events over the distinct inputs.

The last two lines are a JSON object describing the kernel and the result
line ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL = (30, 1536, 2048)  # (T, H, W): 94.4 MB decoded, 1,474,560 blocks
HD = (30, 1080, 1920)
PHOTO = ROOT / "tests" / "assets" / "bridge_2048x1536.png"
TIMED_ITERS = 12
VARIANTS = 4
KERNEL = {
    "name": "decode_images",
    "route": "cuda",
    "source": "metalhuffman_tpu_torch/csrc/decode_images.cu",
    "replaces": "metalhuffman_tpu/ops/decode_pallas.py:532",
}


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def synthetic_frame(h: int, w: int, seed: int = 0, phase: int = 0) -> np.ndarray:
    """Smooth gradients + mild noise (delta+Huffman compresses it to ~55%,
    like a natural photo); ``phase`` pans the gradient between frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 96 + 80 * np.sin((xx + 3 * phase) / 97.0) * np.cos(yy / 71.0) + xx * 0.01
    img = base + rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic(t: int, h: int, w: int) -> np.ndarray:
    return np.stack([synthetic_frame(h, w, seed=0, phase=i) for i in range(t)])


def photo_frames(h: int, w: int, t: int) -> np.ndarray:
    """(T, H, W) photographic frames: the committed 2048x1536 grayscale bridge
    photo, tiled to (H, W) and panned 8 px per frame in both axes."""
    from PIL import Image

    img = np.asarray(Image.open(PHOTO).convert("L"))
    reps = (-(-h // img.shape[0]), -(-w // img.shape[1]))
    img = np.tile(img, reps)[:h, :w]
    return np.stack([np.roll(img, (8 * i, 8 * i), axis=(0, 1))
                     for i in range(t)])


def phase_a(device, cases) -> int:
    """Kernel vs plain version on the same device inputs; returns the max
    absolute byte difference seen (must be 0)."""
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    worst = 0
    for name, (t, h, w), kw in cases:
        cfg = CodecConfig(**kw)
        frames = synthetic(t, h, w)
        stream = fs.encode_frames_shared(frames, cfg)
        prep = fs.prepare_shared(stream, t, h, w, cfg, device=device)
        args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
        geo = dict(num_frames=t, bh=prep.bh, bw=prep.bw,
                   delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d)
        kern = decode_cuda.decode_images(*args, **geo)
        plain = decode_cuda.decode_images_plain(*args, **geo)
        err = int((kern.int() - plain.int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"phase A {name}: kernel differs from plain by {err}")
        if cfg.zero_init:
            got = fs.decode_shared_step(prep, cfg).cpu().numpy()
        else:
            got = fs.frames_from_raw(kern, t, h, w).cpu().numpy()
        check(np.array_equal(got, frames),
              f"phase A {name}: {int((got != frames).sum())} bytes differ "
              "from the source frames")
        print(f"phase A ok: {name}: kernel == plain == source "
              f"({kern.numel()} bytes, table depth {int(stream.widths.max())})")
    return worst


def phase_b(device) -> int:
    """The main path at full size; returns the kernel launches it made."""
    from metalhuffman_tpu_torch import decode_video
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, h, w = FULL
    synth = synthetic(t, h, w)
    cases = [
        ("synthetic 30x2048x1536 delta", synth, CodecConfig()),
        ("photo 30x2048x1536 delta", photo_frames(h, w, t),
         CodecConfig()),
        ("synthetic 30x2048x1536 delta2d", synth, CodecConfig(delta2d=True)),
        ("synthetic 30x1920x1080 delta", synthetic(*HD), CodecConfig()),
    ]
    streams = [(name, frames, cfg, fs.encode_frames_shared(frames, cfg))
               for name, frames, cfg in cases]
    blob = fs.write_shared(streams[0][3], t, h, w, CodecConfig(),
                           source_crc32=zlib.crc32(synth.tobytes()))

    decode_cuda.launches = 0
    for name, frames, cfg, stream in streams:
        ft, fh, fw = frames.shape
        t0 = time.perf_counter()
        prep = fs.prepare_shared(stream, ft, fh, fw, cfg, device=device)
        raw = fs.decode_shared_step(prep, cfg, raw=True)
        got = fs.frames_from_raw(raw, ft, fh, fw).cpu().numpy()
        dt = time.perf_counter() - t0
        check(np.array_equal(got, frames),
              f"phase B {name}: {int((got != frames).sum())} bytes differ")
        print(f"phase B ok: {name}: {frames.size} bytes equal, compressed "
              f"{stream.compressed_size} B "
              f"({stream.compressed_size / frames.size:.4f}), "
              f"stage+decode+fetch {dt:.3f} s")
    got = decode_video(blob, device)
    check(np.array_equal(got, synth), "phase B decode_video: frames differ")
    print(f"phase B ok: decode_video MHTV ({len(blob)} B) CRC-checked, "
          f"{got.size} bytes equal")
    launches = decode_cuda.launches
    expected = len(streams) + 1
    check(launches == expected,
          f"phase B: {launches} kernel launches, expected {expected}")
    return launches


def timings(device, card: str) -> tuple[float, float, int]:
    """Median ms of decodes of the 30x2048x1536 batch, kernel and plain, and
    the max absolute byte difference of the two on every staged input."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, h, w = FULL
    cfg = CodecConfig()
    base = synthetic(t, h, w)
    # distinct staged inputs: frame-order rotations share one table but are
    # different bitstreams in different buffers
    preps = [fs.prepare_shared(
        fs.encode_frames_shared(np.roll(base, v, axis=0), cfg), t, h, w, cfg,
        device=device) for v in range(VARIANTS)]

    def kernel(p):
        return fs.decode_shared_step(p, cfg, raw=True)

    def plain(p):
        return decode_cuda.decode_images_plain(
            p.words, p.offsets, p.symbols, p.bounds, p.adj,
            num_frames=t, bh=p.bh, bw=p.bw, delta=True)

    # the kernel against its plain version at the main path's own shape
    # (1,474,560 blocks, bit offsets near 4.1e8)
    worst = 0
    for v, p in enumerate(preps):
        err = int((kernel(p).int() - plain(p).int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"timed input {v}: kernel differs from plain by {err}")
    print(f"full-size check ok: kernel == plain on {VARIANTS} staged "
          f"30x2048x1536 inputs")

    result = []
    for label, fn in (("kernel", kernel), ("plain", plain)):
        for p in preps:  # warm up
            fn(p)
        torch.cuda.synchronize()
        times = []
        for i in range(TIMED_ITERS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn(preps[i % VARIANTS])
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        times.sort()
        med = times[len(times) // 2]
        print(f"time {label}: median {med:.4f} ms over {len(times)} decodes "
              f"of 30x2048x1536 (min {times[0]:.4f}, max {times[-1]:.4f}), "
              f"{base.size / med / 1e6:.3f} GB/s decoded, on {card}")
        # back to back: the host's launch work overlaps the device's, so the
        # mean approaches the device time of one decode
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for i in range(TIMED_ITERS):
            fn(preps[i % VARIANTS])
        end.record()
        end.synchronize()
        mean = start.elapsed_time(end) / TIMED_ITERS
        print(f"time {label} back-to-back: mean {mean:.4f} ms over "
              f"{TIMED_ITERS} queued decodes, "
              f"{base.size / mean / 1e6:.3f} GB/s decoded, on {card}")
        result.append(med)
    return result[0], result[1], worst


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    os.environ.setdefault("MHT_CACHE_DIR", str(ROOT / "build" / "native"))
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")

    from metalhuffman_tpu_torch import _build
    from metalhuffman_tpu_torch.models import frame_stream

    host = frame_stream.host_backend()
    print(f"host encoder: {host}")
    check(host == "native", "the C++ host encoder did not build")
    t0 = time.perf_counter()
    _build.lib()
    print(f"kernel build+load {time.perf_counter() - t0:.2f} s "
          f"-> {_build.library_path().name}")
    for line in _build.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"ptxas: {line.strip()}")

    device = torch.device("cuda", 0)
    t, h, w = FULL
    max_err = phase_a(device, [
        ("delta 2x2048x1536", (2, h, w), {}),
        ("delta2d 2x2048x1536", (2, h, w), {"delta2d": True}),
        ("no-delta 2x2048x1536", (2, h, w), {"delta": False}),
        ("delta 1x1920x1080", (1, 1080, 1920), {}),
        ("delta 2x(20 rows x 1212 columns)", (2, 20, 1212), {}),
        ("zero-init image form 2x256x256", (2, 256, 256),
         {"zero_init": True}),
    ])
    launches = phase_b(device)
    print(f"phase B launches: {launches}")
    ms, plain_ms, full_err = timings(device, card)
    print(json.dumps({"kernels": [{
        **KERNEL, "launches": launches, "max_abs_err": max(max_err, full_err),
        "ms": ms, "plain_ms": plain_ms}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except Exception:  # any phase failure: report it and exit nonzero
        traceback.print_exc()
        sys.exit(1)
