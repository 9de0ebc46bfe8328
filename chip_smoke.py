#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

Run from the root of the checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Build both CUDA kernel libraries from ``metalhuffman_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, in parallel) and the host C++
   codec (g++), and print the build time and ptxas's register, shared-memory
   and spill lines.
2. Phase A: each kernel against its plain PyTorch version on the same CUDA
   inputs, byte for byte and end bit for end bit (tolerance 0: the codec is
   lossless integer arithmetic), and both against the source. B1
   (``decode_images``): 8x8 batches in every precoder, and its end bits
   against ``block_end_targets``. B2 (``decode_blocks``): one 2048x1536
   frame at block sizes 2, 4, 8 and 16, 1-D delta and none, and delta2d at 8
   (in the kernel) and 16 (torch post-pass).
3. Phase B, the video main path at full size: host encode of a 30-frame
   2048x1536 batch, ``prepare_shared`` on the card, one launch through
   ``decode_shared_step(raw=True)``, ``frames_from_raw``, for synthetic and
   photographic content, the 2-D predictor, 30 frames of 1920x1080, and
   ``decode_video`` of an MHTV container with its CRC check.
4. Phase C, the image path at full size on the 2048x1536 bridge photo:
   ``encode_image`` -> ``decode_image`` with the CRC check at block sizes 8
   (B1) and 2, 4, 16 (B2); ``ImageCodec.decode_region(check=True)`` on a
   512x512 region, clean, with a flipped bit inside (must raise) and outside
   (must not); ``decode_shared_step_checked`` on the 30x2048x1536 batch at
   8x8 and 16x16, clean and with a flipped bit, its mask equal to the plain
   version's.
   Each kernel's launch count is set to 0 just before phases B and C and
   must match the decodes each made.
5. Times, with CUDA events over distinct staged inputs: B1 with and without
   end bits, B2 at 16x16 and 4x4, each against its plain version on the
   30x2048x1536 batch; one ``decode_image`` of the photo at 8x8 and 16x16.

The last two lines are a JSON object describing the kernels and the result
line ``{"ok": true, "device": {...}}``.

    python3 chip_smoke.py --ab BASELINE.cu

builds the kernels, then only times B1 against ``BASELINE.cu`` (another
commit's ``decode_images.cu``, for instance from ``git archive <commit>
metalhuffman_tpu_torch/csrc``) in turns within one process; see ``ab``. Two
versions are compared only within one call: B1's median moves several
percent between calls with identical code.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent
FULL = (30, 1536, 2048)  # (T, H, W): 94.4 MB decoded, 1,474,560 8x8 blocks
HD = (30, 1080, 1920)
PHOTO = ROOT / "tests" / "assets" / "bridge_2048x1536.png"
TIMED_ITERS = 12
VARIANTS = 4
KERNELS = {
    "decode_images": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/decode_images.cu",
        "replaces": "metalhuffman_tpu/ops/decode_pallas.py:532",
    },
    "decode_blocks": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/decode_blocks.cu",
        "replaces": "metalhuffman_tpu/ops/decode_pallas.py:462",
    },
}
# The least time the card could take: the larger of the bytes moved over the
# HBM rate, and integer operations over the INT32 rate, from the
# H100 SXM data sheet and the Hopper white paper (132 SMs x 64 INT32 lanes
# at the 1.98 GHz boost clock).
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
# Integer operations a minimal canonical decode needs per symbol, whatever
# the kernel: with a left-justified bit window and one lookup table indexed
# by the next 16 bits, a peek (1 shift), the lookup (1 load), the code width
# out of the entry (1 and) and the consume (1 shift). This kernel's
# 15-compare interval chain is its own choice, not the function's work.
# Refills, stores, the precoder and the table's build are left out, so the
# bound is a floor.
OPS_PER_SYMBOL = 4
AB_ROUNDS = 5


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


def photo() -> np.ndarray:
    """The committed 2048x1536 grayscale bridge photo, (1536, 2048) uint8."""
    from PIL import Image

    return np.asarray(Image.open(PHOTO).convert("L"))


def photo_frames(h: int, w: int, t: int) -> np.ndarray:
    """(T, H, W) photographic frames: the bridge photo, tiled to (H, W) and
    panned 8 px per frame in both axes."""
    img = photo()
    reps = (-(-h // img.shape[0]), -(-w // img.shape[1]))
    img = np.tile(img, reps)[:h, :w]
    return np.stack([np.roll(img, (8 * i, 8 * i), axis=(0, 1))
                     for i in range(t)])


def flip_bit(stream, bit: int):
    """The stream with code bit ``bit`` (MSB-first) flipped."""
    code = stream.code_bytes.copy()
    code[bit // 8] ^= 128 >> (bit % 8)
    return dataclasses.replace(stream, code_bytes=code)


def build() -> None:
    """Build the kernel libraries and the host codec; print what ptxas says."""
    from metalhuffman_tpu_torch import _build, native

    t0 = time.perf_counter()
    paths = _build.build()
    for name in _build.KERNELS:
        _build.lib(name)
    print(f"kernel build+load {time.perf_counter() - t0:.2f} s -> "
          f"{', '.join(p.name for p in paths.values())}")
    for name in _build.KERNELS:  # kept beside each library, cached or not
        for line in _build.build_log(name).splitlines():
            if any(k in line for k in ("Compiling entry", "registers", "spill",
                                       "stack frame")):
                print(f"ptxas {name}: {line.strip()}")
    t0 = time.perf_counter()
    native.build()
    print(f"host codec build {time.perf_counter() - t0:.2f} s -> "
          f"{native.library_path().name}")


def phase_a(device, cases) -> int:
    """B1 against its plain version on the same device inputs; returns the
    max absolute byte difference seen (must be 0)."""
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


def phase_a_end_bits(device) -> int:
    """B1 with end bits on 2x2048x1536: kernel == plain, end bits ==
    block_end_targets with the exact last end; returns the max abs error."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import blocks
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, h, w = 2, FULL[1], FULL[2]
    frames = synthetic(t, h, w)
    stream = fs.encode_frames_shared(frames)
    payload = np.concatenate([native.delta_encode(
        blocks.image_to_blocks(f).ravel(), 64) for f in frames])
    total_bits = int(stream.widths.astype(np.int64)[payload].sum())
    prep = fs.prepare_shared(stream, t, h, w, device=device)
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    geo = dict(num_frames=t, bh=prep.bh, bw=prep.bw, delta=True, emit_end=True)
    img, end = decode_cuda.decode_images(*args, **geo)
    pimg, pend = decode_cuda.decode_images_plain(*args, **geo)
    err = max(int((img.int() - pimg.int()).abs().max()),
              int((end - pend).abs().max()))
    check(err == 0, f"phase A B1 end bits: kernel differs from plain by {err}")
    targets = torch.from_numpy(
        decode_cuda.block_end_targets(stream.block_offsets, total_bits))
    check(torch.equal(end.cpu(), targets),
          "phase A B1 end bits differ from block_end_targets")
    check(np.array_equal(img.cpu().numpy(), frames),
          "phase A B1 end bits: frames differ from the source")
    print(f"phase A ok: B1 emit_end 2x2048x1536: kernel == plain == source, "
          f"{end.numel()} end bits == block_end_targets")
    return err


def phase_a_blocks(device) -> int:
    """B2 against its plain version on one synthetic 2048x1536 frame at every
    block size; returns the max absolute byte or end-bit difference."""
    import torch

    from metalhuffman_tpu_torch.core import blocks, delta as delta_mod
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    frame = synthetic_frame(FULL[1], FULL[2])
    cases = [(bd, {"delta": d}) for bd in (2, 4, 8, 16) for d in (True, False)]
    cases += [(8, {"delta2d": True}), (16, {"delta2d": True})]
    worst = 0
    for bd, kw in cases:
        cfg = CodecConfig(block_dim=bd, **kw)
        name = f"B2 {bd}x{bd} " + ("delta2d" if cfg.delta2d else
                                   "delta" if cfg.delta else "none")
        stream = fs.encode_frames_shared(frame[None], cfg)
        meta, words, offsets = decode_cuda.prepare_stream(stream)
        args = (torch.from_numpy(words).to(device),
                torch.from_numpy(offsets).to(device),
                torch.from_numpy(meta.symbols).to(device), meta.bounds, meta.adj)
        in_kernel_d2 = cfg.delta2d and bd == 8
        geo = dict(num_steps=bd * bd, delta=cfg.delta and not cfg.delta2d,
                   delta2d=in_kernel_d2, emit_end=True)
        out, end = decode_cuda.decode_blocks(*args, **geo)
        pout, pend = decode_cuda.decode_blocks_plain(*args, **geo)
        err = max(int((out.int() - pout.int()).abs().max()),
                  int((end - pend).abs().max()))
        worst = max(worst, err)
        check(err == 0, f"phase A {name}: kernel differs from plain by {err}")
        targets = torch.from_numpy(
            decode_cuda.block_end_targets(stream.block_offsets, None))
        check(not decode_cuda.check_block_ends(end.cpu(), targets).any(),
              f"phase A {name}: end bits miss their targets")
        if cfg.delta2d and not in_kernel_d2:
            out = delta_mod.delta2d_decode_blocks(out, bd)
        got = blocks.blocks_to_image_torch(out, FULL[1], FULL[2], bd)
        check(np.array_equal(got.cpu().numpy(), frame),
              f"phase A {name}: the blocks differ from the source frame")
        print(f"phase A ok: {name} 2048x1536: kernel == plain == source, "
              f"{end.numel()} end bits on target")
    return worst


def phase_b(device) -> int:
    """The video main path at full size; returns the B1 launches it made."""
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

    for name in decode_cuda.launches:
        decode_cuda.launches[name] = 0
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
    counts = dict(decode_cuda.launches)
    expected = {"decode_images": len(streams) + 1, "decode_blocks": 0}
    check(counts == expected,
          f"phase B: kernel launches {counts}, expected {expected}")
    return counts["decode_images"]


def plain_mask(prep, cfg) -> np.ndarray:
    """The checked step's error mask, computed with the plain versions."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    kdelta = cfg.delta and not cfg.delta2d
    if prep.block_dim == 8:
        _, end = decode_cuda.decode_images_plain(
            *args, num_frames=prep.num_frames, bh=prep.bh, bw=prep.bw,
            delta=kdelta, delta2d=cfg.delta2d, emit_end=True)
    else:
        _, end = decode_cuda.decode_blocks_plain(
            *args, num_steps=prep.block_dim ** 2, delta=kdelta, emit_end=True)
    err = decode_cuda.check_block_ends(end, prep.end_targets)
    lo, hi = prep.last_window
    err[-1] = (end[-1] < lo) | (end[-1] > hi)
    return err.cpu().numpy()


def phase_c(device) -> dict:
    """The image path and the checked decode at full size; returns the
    launches each kernel made, after checking them against the decodes."""
    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.image_codec import ImageCodec
    from metalhuffman_tpu_torch.ops import decode_cuda

    img = photo()
    h, w = img.shape
    t = FULL[0]
    synth = synthetic(*FULL)
    blobs = {bd: mt.encode_image(img, CodecConfig(block_dim=bd))
             for bd in (8, 2, 4, 16)}
    codec = ImageCodec()
    stream = codec.encode(img)
    batches = {bd: fs.encode_frames_shared(synth, CodecConfig(block_dim=bd))
               for bd in (8, 16)}
    expected = {"decode_images": 0, "decode_blocks": 0}

    for name in decode_cuda.launches:
        decode_cuda.launches[name] = 0
    for bd, blob in blobs.items():
        t0 = time.perf_counter()
        got = mt.decode_image(blob, device=device)  # CRC-checked
        dt = time.perf_counter() - t0
        expected["decode_images" if bd == 8 else "decode_blocks"] += 1
        check(np.array_equal(got, img), f"phase C decode_image {bd}x{bd}")
        print(f"phase C ok: decode_image photo 2048x1536 {bd}x{bd} "
              f"({len(blob)} B, {len(blob) / img.size:.4f}) CRC-checked, "
              f"equal to the photo, {dt:.3f} s")

    # a 512x512 region: block rows 64..127, columns 96..159
    y0, x0, rh, rw = 512, 768, 512, 512
    offs = stream.block_offsets.astype(np.int64)
    bw = w // 8
    region = codec.decode_region(stream, h, w, y0, x0, rh, rw, check=True,
                                 device=device)
    expected["decode_blocks"] += 1
    check(np.array_equal(region, img[y0:y0 + rh, x0:x0 + rw]),
          "phase C decode_region: the crop differs from the photo")
    print("phase C ok: decode_region 512x512 check=True, clean, equal")
    # inside: a seeded bit in block (74, 116); the next bit while the flip
    # resynchronises (the documented blind spot of the end-bit check)
    b = 74 * bw + 116
    bit = int(offs[b] + np.random.default_rng(1).integers(0, offs[b + 1] - offs[b]))
    for _ in range(64):
        expected["decode_blocks"] += 1
        try:
            codec.decode_region(flip_bit(stream, bit), h, w, y0, x0, rh, rw,
                                check=True, device=device)
        except ValueError as e:
            check("integrity" in str(e), f"phase C inside flip: {e}")
            print(f"phase C ok: a flipped bit inside the region (bit {bit}, "
                  f"block {b}) raises: {e}")
            break
        bit += 1
    else:
        raise PhaseError("phase C: 64 flipped bits inside the region, none "
                         "detected")
    # outside: block (74, 200) shares the region's block rows, so its bytes
    # lie inside the staged word range, but it is not decoded
    b = 74 * bw + 200
    bit = int(offs[b] + np.random.default_rng(2).integers(0, offs[b + 1] - offs[b]))
    region = codec.decode_region(flip_bit(stream, bit), h, w, y0, x0, rh, rw,
                                 check=True, device=device)
    expected["decode_blocks"] += 1
    check(np.array_equal(region, img[y0:y0 + rh, x0:x0 + rw]),
          "phase C outside flip: the crop differs from the photo")
    print(f"phase C ok: a flipped bit outside the region (bit {bit}, block "
          f"{b}) passes, crop equal")

    for bd, bstream in batches.items():
        cfg = CodecConfig(block_dim=bd)
        kernel = "decode_images" if bd == 8 else "decode_blocks"
        prep = fs.prepare_shared(bstream, *FULL, cfg, device=device,
                                 check=True)
        out, err = fs.decode_shared_step_checked(prep, cfg)
        expected[kernel] += 1
        check(not err.any(), f"phase C checked {bd}x{bd}: clean stream flagged")
        check(np.array_equal(out.cpu().numpy(), synth),
              f"phase C checked {bd}x{bd}: frames differ")
        rng = np.random.default_rng(bd)
        bit = int(rng.integers(0, 8 * (bstream.code_bytes.size - 2)))
        for _ in range(64):
            bad = fs.prepare_shared(flip_bit(bstream, bit), *FULL, cfg,
                                    device=device, check=True)
            ref = plain_mask(bad, cfg)
            if ref.any():
                break
            bit += 1
        else:
            raise PhaseError(f"phase C checked {bd}x{bd}: 64 flips, none "
                             "flagged by the plain version")
        _, err = fs.decode_shared_step_checked(bad, cfg)
        expected[kernel] += 1
        check(np.array_equal(err, ref),
              f"phase C checked {bd}x{bd}: mask differs from the plain "
              f"version's ({int(err.sum())} vs {int(ref.sum())} flagged)")
        print(f"phase C ok: decode_shared_step_checked 30x2048x1536 "
              f"{bd}x{bd}: clean mask all false, frames equal; bit {bit} "
              f"flipped: {int(err.sum())} of {err.size} blocks flagged, "
              "equal to the plain version's mask")
    counts = dict(decode_cuda.launches)
    check(counts == expected,
          f"phase C: kernel launches {counts}, expected {expected}")
    print(f"phase C launches: {counts}")
    return counts


def timed(label: str, fn, inputs, card: str, nbytes: int) -> float:
    """Median ms of ``fn`` over TIMED_ITERS calls cycling over ``inputs``,
    with CUDA events; prints it beside the card."""
    import torch

    for x in inputs:  # warm up
        fn(x)
    torch.cuda.synchronize()
    times = []
    for i in range(TIMED_ITERS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn(inputs[i % len(inputs)])
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    times.sort()
    med = times[len(times) // 2]
    print(f"time {label}: median {med:.4f} ms over {len(times)} calls "
          f"(min {times[0]:.4f}, max {times[-1]:.4f}), "
          f"{nbytes / med / 1e6:.3f} GB/s decoded, on {card}")
    return med


def bound(label: str, prep, n_symbols: int) -> tuple[float, str]:
    """(least ms, what binds) for a decode of a staged batch, printed with
    both terms: every input byte read once and every output byte written
    once, or OPS_PER_SYMBOL integer operations per symbol."""
    nbytes = 4 * prep.words.numel() + 4 * prep.offsets.numel() + 256 + n_symbols
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_symbols * OPS_PER_SYMBOL / INT32_OPS_PER_S * 1e3
    by = "bytes" if by_bytes >= by_ops else "operations"
    print(f"bound {label}: {max(by_bytes, by_ops):.4f} ms ({by}; bytes "
          f"{nbytes} -> {by_bytes:.4f} ms, operations "
          f"{n_symbols * OPS_PER_SYMBOL} -> {by_ops:.4f} ms)")
    return max(by_bytes, by_ops), by


def staged_batches(device, cfg):
    """VARIANTS staged 30x2048x1536 batches under one config: frame-order
    rotations of the synthetic batch, so distinct bitstreams in distinct
    buffers."""
    from metalhuffman_tpu_torch.models import frame_stream as fs

    base = synthetic(*FULL)
    return base, [fs.prepare_shared(
        fs.encode_frames_shared(np.roll(base, v, axis=0), cfg), *FULL, cfg,
        device=device) for v in range(VARIANTS)]


def timings(device, card: str) -> dict:
    """Times of both kernels and their plain versions on the 30x2048x1536
    batch, after holding each kernel byte-equal to its plain version on
    every staged input; returns the kernels' JSON entries (launches left 0)."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    entries = {}
    base, preps = staged_batches(device, CodecConfig())
    t = FULL[0]

    def args(p):
        return (p.words, p.offsets, p.symbols, p.bounds, p.adj)

    def b1(p):  # the main path's own call
        return fs.decode_shared_step(p, CodecConfig(), raw=True)

    def b1_plain(p):
        return decode_cuda.decode_images_plain(
            *args(p), num_frames=t, bh=p.bh, bw=p.bw, delta=True)

    def b1_end(p):
        return decode_cuda.decode_images(
            *args(p), num_frames=t, bh=p.bh, bw=p.bw, delta=True,
            emit_end=True)

    def b1_no_end(p):
        return decode_cuda.decode_images(
            *args(p), num_frames=t, bh=p.bh, bw=p.bw, delta=True)

    # the kernel against its plain version at the main path's own shape
    # (1,474,560 blocks, bit offsets near 4.1e8)
    worst = 0
    for v, p in enumerate(preps):
        err = int((b1(p).int() - b1_plain(p).int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"timed input {v}: kernel differs from plain by {err}")
    print(f"full-size check ok: B1 == plain on {VARIANTS} staged "
          f"30x2048x1536 inputs")
    ms = timed("B1 kernel (decode_shared_step raw) 30x2048x1536", b1, preps,
               card, base.size)
    plain_ms = timed("B1 plain 30x2048x1536", b1_plain, preps, card, base.size)
    timed("B1 kernel without emit_end 30x2048x1536", b1_no_end, preps, card,
          base.size)
    timed("B1 kernel with emit_end 30x2048x1536", b1_end, preps, card,
          base.size)
    # back to back: the host's launch work overlaps the device's, so the
    # mean approaches the device time of one decode
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TIMED_ITERS):
        b1(preps[i % VARIANTS])
    end.record()
    end.synchronize()
    mean = start.elapsed_time(end) / TIMED_ITERS
    print(f"time B1 kernel back-to-back: mean {mean:.4f} ms over "
          f"{TIMED_ITERS} queued decodes, {base.size / mean / 1e6:.3f} GB/s "
          f"decoded, on {card}")
    bms, by = bound("B1 30x2048x1536", preps[0], base.size)
    entries["decode_images"] = dict(max_abs_err=worst, ms=ms,
                                    plain_ms=plain_ms, bound_ms=bms,
                                    bound_by=by)
    del preps

    worst = 0
    for bd in (16, 4):
        cfg = CodecConfig(block_dim=bd)
        base, preps = staged_batches(device, cfg)

        def b2(p, bd=bd):
            return decode_cuda.decode_blocks(*args(p), num_steps=bd * bd,
                                             delta=True)

        def b2_plain(p, bd=bd):
            return decode_cuda.decode_blocks_plain(*args(p), num_steps=bd * bd,
                                                   delta=True)

        for v, p in enumerate(preps):
            err = int((b2(p).int() - b2_plain(p).int()).abs().max())
            worst = max(worst, err)
            check(err == 0, f"timed B2 {bd}x{bd} input {v}: kernel differs "
                  f"from plain by {err}")
        print(f"full-size check ok: B2 {bd}x{bd} == plain on {VARIANTS} "
              "staged 30x2048x1536 inputs")
        ms = timed(f"B2 kernel {bd}x{bd} 30x2048x1536", b2, preps, card,
                   base.size)
        plain_ms = timed(f"B2 plain {bd}x{bd} 30x2048x1536", b2_plain, preps,
                         card, base.size)
        bms, by = bound(f"B2 {bd}x{bd} 30x2048x1536", preps[0], base.size)
        if bd == 16:  # the kernels line carries the 16x16 batch
            entries["decode_blocks"] = dict(max_abs_err=worst, ms=ms,
                                            plain_ms=plain_ms, bound_ms=bms,
                                            bound_by=by)
        del preps
    return entries


def image_timings(device, card: str) -> None:
    """One decode_image of the photo at 8x8 and 16x16: the device step
    (CUDA events, staged inputs) and the whole call (host clock)."""
    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.image_codec import ImageCodec

    img = photo()
    # distinct inputs: the photo panned 8 px per variant
    imgs = [np.ascontiguousarray(np.roll(img, 8 * v, axis=1))
            for v in range(VARIANTS)]
    for bd in (8, 16):
        codec = ImageCodec(CodecConfig(block_dim=bd))
        preps = [codec.prepare(codec.encode(x), *img.shape, device=device)
                 for x in imgs]
        timed(f"decode_image device step {bd}x{bd} photo 2048x1536",
              codec.decode_step, preps, card, img.size)
        blobs = [mt.encode_image(x, CodecConfig(block_dim=bd)) for x in imgs]
        for blob in blobs:  # warm up
            mt.decode_image(blob, device=device)
        walls = []
        for i in range(TIMED_ITERS):
            t0 = time.perf_counter()
            mt.decode_image(blobs[i % VARIANTS], device=device)
            walls.append((time.perf_counter() - t0) * 1e3)
        walls.sort()
        print(f"time decode_image wall {bd}x{bd} photo 2048x1536 (parse, "
              f"stage, decode, fetch, CRC): median {walls[len(walls) // 2]:.4f}"
              f" ms over {TIMED_ITERS} (min {walls[0]:.4f}, max "
              f"{walls[-1]:.4f}), on {card}")


def ab(baseline: Path, device, card: str) -> None:
    """B1 against ``baseline``, another commit's ``decode_images.cu`` with
    the same C entry point (with or without the end pointer), in one
    process: the baseline built under another name, both held byte-equal on
    the staged batches of ``timings``, then timed in AB_ROUNDS rounds of
    baseline, current, current, baseline. Both launch straight through
    ctypes into preallocated outputs, so no host work differs."""
    import ctypes
    import re

    import torch

    from metalhuffman_tpu_torch import _build
    from metalhuffman_tpu_torch.models.config import CodecConfig

    nvcc = _build.find_nvcc()
    check(nvcc is not None, "A/B: nvcc not found")
    path = _build.hashed_path("libmht_ab_decode_images", _build.NVCC_FLAGS,
                              (baseline,))
    if not path.exists():
        _build.compile_all([([nvcc, *_build.NVCC_FLAGS, str(baseline)], path)])
    takes_end = re.search(r"mht_decode_images\([^)]*\bend\b",
                          baseline.read_text(), re.S) is not None
    fns = {"baseline": ctypes.CDLL(str(path)).mht_decode_images,
           "current": _build.lib("decode_images").mht_decode_images}
    fns["baseline"].argtypes = [
        a for i, a in enumerate(_build._ARGTYPES["decode_images"])
        if takes_end or i != 11]  # argument 11 is the end pointer
    fns["baseline"].restype = ctypes.c_int
    ends = {"baseline": [None] if takes_end else [], "current": [None]}
    frames, preps = staged_batches(device, CodecConfig())
    outs = {k: torch.empty(FULL, dtype=torch.uint8, device=device)
            for k in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(which):
        def launch(p):
            err = fns[which](
                p.words.data_ptr(), p.words.numel(), p.offsets.data_ptr(),
                p.offsets.numel(), p.bh, p.bw,
                (ctypes.c_uint32 * 16)(*p.bounds),
                (ctypes.c_int32 * 16)(*p.adj), p.symbols.data_ptr(), 1,
                outs[which].data_ptr(), *ends[which], stream)
            check(err == 0, f"A/B {which}: CUDA error {err}")
        return launch

    launch = {k: launcher(k) for k in fns}
    for p in preps:
        launch["baseline"](p)
        launch["current"](p)
        check(torch.equal(outs["baseline"], outs["current"]),
              "A/B: the two kernels write different bytes")
    print(f"A/B: baseline == current on {VARIANTS} staged 30x2048x1536 "
          f"batches (baseline {'with' if takes_end else 'without'} the end "
          "pointer)")
    results = {k: [] for k in fns}
    for r in range(AB_ROUNDS):
        for which in ("baseline", "current", "current", "baseline"):
            results[which].append(timed(
                f"A/B round {r} {which} B1 30x2048x1536", launch[which],
                preps, card, frames.size))
    for which, ms in results.items():
        ms.sort()
        print(f"A/B {which}: median {ms[len(ms) // 2]:.4f} ms of {len(ms)} "
              f"medians (min {ms[0]:.4f}, max {ms[-1]:.4f}), B1 on "
              f"30x2048x1536, on {card}")


USAGE = "usage: python3 chip_smoke.py [--ab BASELINE_decode_images.cu]"


def main(argv: list[str]) -> int:
    import torch

    if argv and not (len(argv) == 2 and argv[0] == "--ab"):
        print(USAGE, file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    card = smi.stdout.strip()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    build()

    device = torch.device("cuda", 0)
    if argv:  # the A/B alone: no phases and no result line
        ab(Path(argv[1]), device, card)
        return 0
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
    max_err = max(max_err, phase_a_end_bits(device))
    b2_err = phase_a_blocks(device)
    b1_launches = phase_b(device)
    print(f"phase B launches: decode_images {b1_launches}")
    launches = phase_c(device)
    launches["decode_images"] += b1_launches
    entries = timings(device, card)
    image_timings(device, card)
    entries["decode_images"]["max_abs_err"] = max(
        max_err, entries["decode_images"]["max_abs_err"])
    entries["decode_blocks"]["max_abs_err"] = max(
        b2_err, entries["decode_blocks"]["max_abs_err"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [
        {"name": name, **KERNELS[name], "launches": launches[name],
         **entries[name], "library_ms": None}
        for name in KERNELS]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main(sys.argv[1:]))
    except Exception:  # any phase failure: report it and exit nonzero
        traceback.print_exc()
        sys.exit(1)
