#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

Run from the root of the checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Build the seven CUDA kernel libraries from ``metalhuffman_tpu_torch/csrc``
   (nvcc, sm_90a, one process per source, in parallel) and the host C++
   codec (g++), and print the build time and ptxas's register, shared-memory
   and spill lines.
2. Phase A: each kernel against its plain PyTorch version on the same CUDA
   inputs, byte for byte and end bit for end bit (tolerance 0: the codec is
   lossless integer arithmetic), and both against the source. B1
   (``decode_images``): 8x8 batches in every precoder, and its end bits
   against ``block_end_targets``. B2 (``decode_blocks``): one 2048x1536
   frame at block sizes 2, 4, 8 and 16, 1-D delta and none, and delta2d at
   8 (in the kernel) and 16 (torch post-pass). B1 and B2 on inputs only the
   lookup table can get wrong: the one-symbol stream and random words under
   the one-symbol, the 16-bit-code and a malformed all-16-bit table (T2 read
   through L1), and under an incomplete two-symbol code whose 52 KB table
   takes shared memory past 48 KB; every path of both kernels (T2 in shared
   memory or through L1) must have launched. On 2048x1536 and 1920x1080
   delta payloads and on three tables of the encoder tests (16-bit codes,
   1-bit codes, one symbol), from aligned and unaligned symbol buffers:
   ``encode_stream`` (B3 redesigned), stream bytes, offsets and total,
   against its plain version and the host encoder, alone and with 1- and
   17-symbol tails; B3's row form (``encode_rows``), every row word and
   count word, the count words equal to the blocks' bit counts.
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
5. Phase D, the device encode at full size: ``encode_symbols_hybrid`` on
   the card (through ``encode_stream``) for the 1-D delta payloads of the
   30x2048x1536 synthetic and photo batches, each also with a 17-symbol
   tail, byte-equal to the host encoder; each stream written as MHTV and
   decoded back by ``decode_video`` on the card (CRC-checked, equal to the
   frames).
6. Phase E, the probes of B1 (``metalhuffman_tpu_torch.probes``), each
   against its plain version, tolerance 0: S1 (``decode_strips``) and every
   S2 variant (``ablate_decode``) on 2x2048x1536 and 1x1920x1080 photo and
   synthetic frames (also against the frames), on the 16-bit-code table of
   the encoder tests and on a table of 128 secondary lookup tables (the
   ``lut`` variant's T2 read through L1); every S3 variant (``int16_rate``)
   on 2^16 elements.
7. Phase F, segmented video, random access and MHTS at full size. F1: 150
   photo frames through ``encode_video`` (per-frame CRCs on), an MHV2 of
   segments [136, 14]; on the card ``decode_video``, the checked segmented
   decode, ``decode_range`` of frames 130-140 (across the segments, checked
   against the per-frame CRCs), ``decode_frame`` 135 and 140 and
   ``decode_video_region`` 512x512 over frames 134-138 with the end-bit
   check. F2: 137 frames of i.i.d. near-uniform bytes, no delta, an MHV2
   whose segment 0 runs to about 3.4e9 bits, so every block of frames
   86-135 starts past 2^31: ``decode_video``, the checked decode clean and
   with a flipped bit in frame 120 (it must name segment 0), and
   ``decode_range`` of frames 128-137. F3: an MHTS clip of 30 photo frames,
   a table each: ``decode_batch``, ``iter_stream_frames(check=True)`` and
   ``decode_range``. Every output equals its source frames; then B1 equals
   its plain version, bytes and end bits, on F1's segment 1, on F2's
   segment 0 and its flipped mask, and on each of F3's frames, and B2 on
   F1's region selections.
8. Phase G, temporal (MHVT), color (MHTC) and gray16 video at full size,
   keyframe every 8. G1: 30 panned 2048x1536 photo frames as MHVT;
   ``decode_video`` (B1, the group fold on the card, one fetch) equals the
   frames and the numpy ``temporal_decode`` of the fetched residuals. G2:
   the same frames and 30 frames of 768x1366 (a width no multiple of 8)
   with motion compensation, equal to the frames and to
   ``temporal_decode_mc``. G3: 30x1080x1920x3 sub-green temporal frames
   and a 4-channel MHTC video: ``decode_color_video``, a frame and a
   checked 512x512 region. G4: 30x2048x1536 u16 depth-like frames with
   motion compensation (the lo-to-hi carry), a gray16 image and a gray16
   video. G5, on G1 and G2: ``decode_temporal_range`` 5-13 (across a
   keyframe), ``decode_temporal_frame`` 29, ``iter_temporal_video`` in
   chunks of 10 with its CRC chain, a checked 512x512 region, a flipped
   bit inside the region (raises) and outside (passes), and a wrapper with
   a changed keyint (raises). G6: F1's 150 frames as MHVT over an MHV2.
   Then B1 against its plain version on G2's 768x1366 residuals and G3's
   color planes, B2 on G1's region selection.
9. Phase H, multi-GPU decode and encode (``metalhuffman_tpu_torch.parallel``)
   through a one-rank NCCL group on the card (the machine holds one GPU),
   at 30x2048x1536: ``decode_shared_sharded`` + ``gather_shared`` (B1),
   ``decode_blocks_sharded`` at 16x16 (B2), ``decode_batch_sharded`` of
   F3's 30-table MHTS clip (B2), each equal to the frames and to the
   single-device decode; ``encode_symbols_sharded`` (which
   ``encode_symbols_multihost`` names too) on the synthetic delta payload,
   alone and with a 17-symbol tail, equal to the host encoder and to
   ``encode_symbols_hybrid``; ``encode_rows_sharded``'s totals. Then the
   seams: the local steps of worlds 3 and 4, rank by rank in this process
   with no collective, on 3 photo frames (B1 at 8x8, B2 at 16x16), 3 frames
   of the MHTS clip (B2) and two payloads of odd-width codes
   (``encode_stream``), each rank's output equal to its plain version and
   the ranks, assembled by the port's gather and splice code, equal to the
   source; the bit phases of the encode seams are printed. Then its times:
   each sharded call against its single-device call, the 94.4 MB
   all-gather, the cross-check and the splice apart; one ``phase H`` JSON
   line before the last two lines holds them with the launch counts.
   Every kernel's launch count is set to 0 just before phases B, C, D, E,
   F, G and H and must match the decodes, encodes and probes each made.
10. Times, with CUDA events over distinct staged inputs: B1 with and without
   end bits, B2 at 16x16 and 4x4, each against its plain version on the
   30x2048x1536 batch, each with its grid (resident CUDA blocks per SM,
   shared memory per CUDA block) and its registers and spills, and B1 and
   B2 queued back to back; on that batch's payload ``encode_stream`` (each
   pass alone, the scan, the whole wrapper) and B3's row form, each against
   its plain version, and on the host's clock each step of the hybrid
   encode, the whole call, the host encoder and the row-form path it
   replaced (host bit counts, B3, rows back, row merge); one ``decode_image`` of
   the photo at 8x8 and 16x16; B1, S1 and every S2 variant
   in interleaved rounds on 4 staged 30x2048x1536 photo batches and 4
   synthetic ones (one table each), each held equal to its plain version
   there first (S2 ``base`` is B1's interval body before its redesign); every S3
   variant and its plain version on 2^22 elements, and the SASS opcodes of
   the S3 kernels; phase F's: the MHV2 decode of F1 whole and each segment
   alone (host clock; staging, B1 and fetch apart), the host build of each
   of F3's lookup tables, and F3's MHTS decode (a launch per frame) against
   one MHTV launch of the same 30 frames; phase G's, for G1-G4: staging,
   B1, the plane fold, the temporal fold (each fold beside its byte bound),
   the fetch, the CRC and the whole ``decode_video`` call, the MHTV decode
   of the same residuals as the yardstick, and the motion-compensated
   folds' gather-rolls and adds apart.

The last two lines are a JSON object describing the kernels and the result
line ``{"ok": true, "device": {...}}``; the ``phase H`` line comes before
them.

    python3 chip_smoke.py --ab BASELINE.cu

builds the kernels, then only times B1 against ``BASELINE.cu`` (another
commit's ``decode_images.cu``, for instance from ``git archive <commit>
metalhuffman_tpu_torch/csrc``, on the interval table or the lookup table)
in turns within one process; see ``ab``. Two
versions are compared only within one call: B1's median moves several
percent between calls with identical code.
"""

from __future__ import annotations

import dataclasses
import json
import struct
import sys
import time
import traceback
import zlib
from pathlib import Path

import numpy as np

from metalhuffman_tpu_torch import probes
from metalhuffman_tpu_torch.utils.fixtures import (  # noqa: F401
    photo, photo_frames, synthetic, synthetic_frame)

FULL = (30, 1536, 2048)  # (T, H, W): 94.4 MB decoded, 1,474,560 8x8 blocks
HD = (30, 1080, 1920)
F1_FRAMES = 150  # phase F1: MHV2 of segments [136, 14] at 2048x1536
F2_FRAMES = 137  # phase F2: segment 0 runs past 2^31 bits
F3_FRAMES = 30  # phase F3: the MHTS clip
F_REGION = (512, 768, 512, 512)  # (y0, x0, rh, rw) of F1's region decode
G_FRAMES = 30  # phase G: temporal clips of 30 frames, keyframe every 8
G_KEYINT = 8
G_SMALL = (768, 1366)  # G2's second size: a width no multiple of 8
G_COLOR = (1080, 1920)  # G3's color frames
G_SHORT = 10  # G3's 4-channel MHTC and G4's gray16 video, without temporal
G_REGION = (512, 768, 512, 512)  # (y0, x0, rh, rw) of G's region decodes
TIMED_ITERS = 12
VARIANTS = 4
RATE_SMALL = 1 << 16  # S3 elements in phase E
H_WORLDS = (3, 4)  # phase H: worlds whose local steps run rank by rank
H_DEPTH = 3  # frames of phase H's seam inputs
# phase H's odd-width payloads: their encode seams in worlds 3 and 4 reach
# every bit phase (base & 7) between them
H_SKEWED = (1 << 20) + 5
H_SEEDS = (9, 10, 11)
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
    "encode_stream": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/encode_stream.cu",
        "replaces": "metalhuffman_tpu/ops/encode_pallas.py:138",
    },
    "encode_rows": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/encode_rows.cu",
        "replaces": "metalhuffman_tpu/ops/encode_pallas.py:138",
    },
    "decode_strips": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/decode_strips.cu",
        "replaces": "scratch/kernel_strips.py:123",
    },
    "ablate_decode": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/ablate_decode.cu",
        "replaces": "scratch/ablate_decode.py:223",
    },
    "int16_rate": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/int16_rate.cu",
        "replaces": "scratch/int16_rate.py:39",
    },
}
# The least time the card could take: the larger of the bytes moved over the
# HBM rate, and integer operations over the rate the SMs issue them, from the
# H100 SXM data sheet and the Hopper white paper: 132 SMs x 4 schedulers x 32
# lanes at the 1.98 GHz boost clock. The INT32 pipe alone takes 64 lanes per
# SM and clock, but integer adds and moves also issue to the FMA pipe as
# IMAD: S3's int32 chain ran above 132 x 64 lanes x 1.98 GHz on the H100.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 128 * 1.98e9
# Integer operations a minimal canonical decode needs per symbol, whatever
# the kernel: with a left-justified bit window and one lookup table indexed
# by the next 16 bits, a peek (1 shift), the lookup (1 load), the code width
# out of the entry (1 and) and the consume (1 shift). This kernel's
# 15-compare interval chain is its own choice, not the function's work.
# Refills, stores, the precoder and the table's build are left out, so the
# bound is a floor.
OPS_PER_SYMBOL = 4
# The same count for a minimal encode: the (code, width) lookup (1 load),
# the shift of the accumulator by the width (1), the OR of the code (1) and
# the advance of the bit count (1). Word stores are left out: a floor.
ENCODE_OPS_PER_SYMBOL = 4
HOST_ITERS = 5  # host-clock repetitions of each host stage of the encode
AB_ROUNDS = 5


class PhaseError(Exception):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise PhaseError(msg)


def flip_bit(stream, bit: int):
    """The stream with code bit ``bit`` (MSB-first) flipped."""
    code = stream.code_bytes.copy()
    code[bit // 8] ^= 128 >> (bit % 8)
    return dataclasses.replace(stream, code_bytes=code)


def delta_payload(frames: np.ndarray) -> np.ndarray:
    """The symbols ``encode_frames_shared`` encodes for (T, H, W) frames:
    each frame's 8x8 blocks in raster order, 1-D delta per block, frames
    concatenated."""
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import blocks

    return np.concatenate([native.delta_encode(
        blocks.image_to_blocks(f).ravel(), 64) for f in frames])


def encoder_sets() -> list:
    """Payloads shaped like the encoder tests' sets: frequencies 2^i for
    24 symbols (16-bit codes), two symbols (1-bit codes, every block ends on
    a word boundary), one symbol."""
    rng = np.random.default_rng(7)
    adv = np.repeat(np.arange(24, dtype=np.uint8), 2 ** np.arange(24))
    rng.shuffle(adv)
    return [
        ("longcodes", adv[: adv.size // 64 * 64]),
        ("two-sym", rng.choice([7, 200], size=64 * 130,
                               p=[0.93, 0.07]).astype(np.uint8)),
        ("constant", np.full(64 * 10 + 5, 9, np.uint8)),
    ]


def stage_encode(data: np.ndarray, device):
    """A payload's whole blocks and canonical table on ``device``, as
    ``encode_symbols_hybrid`` stages them -> (symbols, table, bits per
    block, wmax)."""
    import torch

    from metalhuffman_tpu_torch.ops import encode_cuda

    widths, codes = encode_cuda.canonical_table(data)
    body = data[: data.size // 64 * 64].reshape(-1, 64)
    bits = encode_cuda.block_bits(body, widths)
    return (torch.from_numpy(body).to(device),
            torch.from_numpy(encode_cuda.code_table(widths, codes)).to(device),
            bits, int(bits.max()) // 32 + 2)


def same_stream(a, b) -> bool:
    """Two EncodedStreams hold the same symbols count and the same arrays,
    value and type."""
    return a.num_symbols == b.num_symbols and all(
        getattr(a, f).dtype == getattr(b, f).dtype
        and np.array_equal(getattr(a, f), getattr(b, f))
        for f in ("widths", "code_bytes", "block_offsets"))


def launch_counts() -> tuple:
    """The launch-count dicts of every kernel's wrapper module."""
    from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda
    from metalhuffman_tpu_torch.probes import ablate_decode, int16_rate, strips

    return (decode_cuda.launches, encode_cuda.launches, strips.launches,
            ablate_decode.launches, int16_rate.launches)


def reset_launches() -> None:
    """Set every kernel's launch count, and the decode kernels' counts by
    path, to 0."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    for counts in (*launch_counts(), decode_cuda.path_launches):
        for name in counts:
            counts[name] = 0


def read_launches() -> dict:
    """Every kernel's launch count since the last ``reset_launches``."""
    return {name: n for counts in launch_counts() for name, n in counts.items()}


def expect(**counts) -> dict:
    """Every kernel's expected launch count: ``counts``, else 0."""
    return {**dict.fromkeys(KERNELS, 0), **counts}


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
        plain = decode_cuda.decode_images_plain(*args, **geo)
        kern = decode_cuda.decode_images(*args, **geo, table=prep.table)
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
        print(f"phase A ok: {name}: kernel == plain "
              f"== source ({kern.numel()} bytes, table depth "
              f"{int(stream.widths.max())})")
    return worst


def phase_a_end_bits(device) -> int:
    """B1 with end bits on 2x2048x1536: kernel == plain, end bits ==
    block_end_targets with the exact last end; returns the max abs error."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, h, w = 2, FULL[1], FULL[2]
    frames = synthetic(t, h, w)
    stream = fs.encode_frames_shared(frames)
    payload = delta_payload(frames)
    total_bits = int(stream.widths.astype(np.int64)[payload].sum())
    prep = fs.prepare_shared(stream, t, h, w, device=device)
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    geo = dict(num_frames=t, bh=prep.bh, bw=prep.bw, delta=True, emit_end=True)
    img, end = decode_cuda.decode_images(*args, **geo, table=prep.table)
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
        out, end = decode_cuda.decode_blocks(
            *args, **geo, table=decode_cuda.lookup_table(meta, device))
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


def table_cases() -> list:
    """Phase A's inputs that only the lookup table can get wrong -> [(name,
    widths, words, offsets, source blocks or None)]: streams and random
    words under tables whose windows reach lengths no code uses."""
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import decode_cuda

    rng = np.random.default_rng(11)
    sets = dict(encoder_sets())

    def garbage():  # random words, random offsets inside them
        words = rng.integers(0, 1 << 32, 1 << 16, dtype=np.uint64)
        offsets = rng.integers(0, 32 << 16, 4096, dtype=np.uint64)
        return (words.astype(np.uint32).view(np.int32),
                offsets.astype(np.uint32).view(np.int32))

    stream = native.encode_symbols(sets["constant"])
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    cases = [("one-symbol stream", stream.widths, words, offsets,
              sets["constant"][:offsets.size * 64].reshape(-1, 64))]
    incomplete = np.zeros(256, np.uint8)  # codes 0 and 100: 768 T2 tables
    incomplete[5], incomplete[200] = 1, 3
    for name, widths in (
            ("one-symbol table", native.code_lengths(
                np.bincount(sets["constant"], minlength=256))),
            ("longcodes table", native.code_lengths(
                np.bincount(sets["longcodes"], minlength=256))),
            # malformed: every window escapes
            ("all-16-bit table", np.full(256, 16, np.uint8)),
            # malformed: 52 KB, T2 in shared memory past 48 KB
            ("incomplete two-symbol table", incomplete)):
        cases.append((f"random words under the {name}", widths, *garbage(),
                      None))
    return cases


def phase_a_tables(device) -> int:
    """B1 and B2 against their plain versions, bytes and end bits, on
    :func:`table_cases`; returns the max abs difference."""
    import torch

    from metalhuffman_tpu_torch.ops import decode_cuda

    worst = 0
    for name, widths, words, offsets, src in table_cases():
        meta = decode_cuda.canonical_meta(widths)
        nb = offsets.size
        args = (torch.from_numpy(words).to(device),
                torch.from_numpy(offsets).to(device),
                torch.from_numpy(meta.symbols).to(device), meta.bounds, meta.adj)
        b1_geo = dict(num_frames=1, bh=1, bw=nb, delta=True, emit_end=True)
        b2_geos = [dict(num_steps=64, delta=False, delta2d=True),
                   dict(num_steps=256, delta=True),
                   dict(num_steps=4, delta=False)]
        table = decode_cuda.lookup_table(meta, device)
        runs = [(decode_cuda.decode_images(*args, **b1_geo, table=table),
                 decode_cuda.decode_images_plain(*args, **b1_geo))]
        for geo in b2_geos:
            runs.append((
                decode_cuda.decode_blocks(*args, **geo, emit_end=True,
                                          table=table),
                decode_cuda.decode_blocks_plain(*args, **geo, emit_end=True)))
        for (out, end), (pout, pend) in runs:
            err = max(int((out.int() - pout.int()).abs().max()),
                      int((end - pend).abs().max()))
            worst = max(worst, err)
            check(err == 0, f"phase A {name}: kernel differs from plain by "
                  f"{err}")
        if src is not None:
            check(np.array_equal(runs[1][0][0].cpu().numpy(),
                                 delta2d_blocks(src)),
                  f"phase A {name}: B2 differs from the source")
        print(f"phase A ok: {name} ({nb} blocks): B1 and B2 at 64 (delta2d),"
              f" 256 (delta), 4 == plain in bytes and end bits; table "
              f"{table.nbytes} B, T2 {'smem' if table.t2_in_smem else 'L1'}")
    return worst


def delta2d_blocks(blocks64: np.ndarray) -> np.ndarray:
    """(n, 64) symbols read as delta2d residuals of 8x8 blocks -> the
    blocks the in-kernel 2-D fold makes of them (row 0 summed along the
    row, then each row adds the one above, mod 256)."""
    sq = blocks64.astype(np.int64).reshape(-1, 8, 8)
    sq[:, 0] = np.cumsum(sq[:, 0], 1)
    return (np.cumsum(sq, 1) & 0xFF).astype(np.uint8).reshape(-1, 64)


def unaligned(x):
    """The same bytes one byte into a buffer: the kernels' byte-load path."""
    import torch

    buf = torch.empty(x.numel() + 1, dtype=torch.uint8, device=x.device)
    buf[1:] = x.view(-1)
    return buf[1:].view(x.shape)


def stream_error(got, want) -> int:
    """Max absolute difference of two (stream bytes, offsets, total) results
    of ``encode_stream`` (a length mismatch counts as the longer length)."""
    (code, offs, total), (pcode, poffs, ptotal) = got, want
    if code.numel() != pcode.numel() or offs.numel() != poffs.numel():
        return max(code.numel(), pcode.numel())
    err = abs(total - ptotal)
    for x, y in ((code, pcode), (offs, poffs)):
        if x.numel():
            err = max(err, int((x.long() - y.long()).abs().max()))
    return err


def phase_a_stream(device, cases) -> int:
    """``encode_stream`` against its plain version and the host encoder on
    each payload alone and with 1- and 17-symbol tails, from aligned and
    unaligned symbol buffers; returns the max absolute difference (must be
    0)."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import encode_cuda

    worst = 0
    for name, data in cases:
        body = data[: data.size // 64 * 64]
        for tail in (0, 1, 17):
            d = np.concatenate([body, body[:tail]]) if tail else data
            widths, codes = encode_cuda.canonical_table(d)
            tab = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(
                device)
            sym = torch.from_numpy(d).to(device)
            host = native.encode_symbols(d)
            plain = encode_cuda.encode_stream_plain(sym, tab)
            for src in (sym, unaligned(sym)):
                got = encode_cuda.encode_stream(src, tab)
                err = stream_error(got, plain)
                worst = max(worst, err)
                check(err == 0, f"phase A encode_stream {name} + {tail}: "
                      f"kernel differs from plain by {err}")
                check(np.array_equal(got[0].cpu().numpy(), host.code_bytes)
                      and np.array_equal(got[1].cpu().numpy().view(np.uint32),
                                         host.block_offsets),
                      f"phase A encode_stream {name} + {tail}: the stream "
                      "differs from the host encoder's")
        print(f"phase A ok: encode_stream {name}: {data.size} symbols "
              f"({data.size % 64} in the tail), and the whole blocks with 1- "
              "and 17-symbol tails: kernel == plain == host encoder from "
              "aligned and unaligned symbols")
    return worst


def phase_a_encode(device) -> tuple[int, int]:
    """``encode_stream`` (:func:`phase_a_stream`), then B3's row form
    against its plain version, every row word and count word, from aligned
    and unaligned symbol buffers; returns the max absolute difference of
    each (must be 0)."""
    from metalhuffman_tpu_torch.ops import encode_cuda

    cases = [("delta 2048x1536", delta_payload(synthetic(1, *FULL[1:]))),
             ("delta 1920x1080", delta_payload(synthetic(1, *HD[1:]))),
             *encoder_sets()]
    stream_worst = phase_a_stream(device, cases)
    worst = 0
    for name, data in cases:
        sym, tab, bits, wmax = stage_encode(data, device)
        plain = encode_cuda.encode_rows_plain(sym, tab, wmax=wmax).long()
        for src in (sym, unaligned(sym)):
            rows = encode_cuda.encode_rows(src, tab, wmax=wmax)
            err = int((rows.long() - plain).abs().max())
            worst = max(worst, err)
            check(err == 0, f"phase A B3 {name}: kernel differs from plain "
                  f"by {err}")
            check(np.array_equal(rows[:, wmax].cpu().numpy(), bits),
                  f"phase A B3 {name}: count words differ from the bit counts")
        print(f"phase A ok: B3 {name}: {sym.shape[0]} blocks, wmax {wmax}: "
              "kernel == plain from aligned and unaligned symbols, count "
              "words == bit counts")
    return stream_worst, worst


def phase_b(device) -> dict:
    """The video main path at full size; returns the launches it made."""
    from metalhuffman_tpu_torch import decode_video
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig

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

    reset_launches()
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
    counts = read_launches()
    expected = expect(decode_images=len(streams) + 1)
    check(counts == expected,
          f"phase B: kernel launches {counts}, expected {expected}")
    print(f"phase B launches: {counts}")
    return counts


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
    expected = expect()

    reset_launches()
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
    counts = read_launches()
    check(counts == expected,
          f"phase C: kernel launches {counts}, expected {expected}")
    print(f"phase C launches: {counts}")
    return counts


def phase_d(device) -> dict:
    """The device encode at full size: ``encode_symbols_hybrid`` on the card
    against the host encoder, with and without a tail, then the stream back
    through ``decode_video``; returns the launches it made, after checking
    them against the calls."""
    from metalhuffman_tpu_torch import decode_video, native
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.ops import encode_cuda

    t, h, w = FULL
    cases = []
    for name, frames in (("synthetic", synthetic(t, h, w)),
                         ("photo", photo_frames(h, w, t))):
        payload = delta_payload(frames)
        tailed = np.concatenate([payload, payload[:17]])
        cases.append((name, frames, payload, native.encode_symbols(payload),
                      tailed, native.encode_symbols(tailed)))

    reset_launches()
    for name, frames, payload, host, tailed, host_tailed in cases:
        t0 = time.perf_counter()
        stream = encode_cuda.encode_symbols_hybrid(payload, device=device)
        dt = time.perf_counter() - t0
        check(same_stream(stream, host),
              f"phase D {name}: the device-encoded stream differs from the "
              "host encoder's")
        check(same_stream(encode_cuda.encode_symbols_hybrid(
            tailed, device=device), host_tailed),
            f"phase D {name} + 17-symbol tail: the stream differs from the "
            "host encoder's")
        blob = fs.write_shared(stream, t, h, w,
                               source_crc32=zlib.crc32(frames.tobytes()))
        got = decode_video(blob, device)
        check(np.array_equal(got, frames),
              f"phase D {name}: decode_video of the device-encoded stream "
              "differs from the frames")
        print(f"phase D ok: encode_symbols_hybrid {name} 30x2048x1536 delta "
              f"({payload.size} symbols, {stream.code_bytes.size} code "
              f"bytes) == host encoder, and with a 17-symbol tail; "
              f"decode_video of it CRC-checked, equal to the frames; "
              f"encode call {dt:.3f} s")
    counts = read_launches()
    expected = expect(decode_images=len(cases), encode_stream=2 * len(cases))
    check(counts == expected,
          f"phase D: kernel launches {counts}, expected {expected}")
    print(f"phase D launches: {counts}")
    return counts


def wide_lut_stream(n_blocks: int):
    """A stream under a table of 128 secondary lookup tables (one 1-bit
    code, one 8-bit, 254 9-bit), too many for the ``lut`` variant's shared
    memory, and uniform random symbols, so most codes escape to T2."""
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import bitstream, container

    widths = np.full(256, 9, np.uint8)
    widths[0], widths[1] = 1, 8
    sym = np.random.default_rng(3).integers(0, 256, 64 * n_blocks).astype(
        np.uint8)
    packed, offs = bitstream.pack_bits(sym, native.canonical_codes(widths),
                                       widths)
    return container.EncodedStream(sym.size, widths, packed,
                                   offs[:-1:64].astype(np.uint32))


def probe_cases(device) -> list:
    """Phase E's decode inputs -> [(name, prep, lut tables, frames or None)]."""
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.probes import ablate_decode

    cases = []
    for content in ("photo", "synthetic"):
        for t, h, w in ((2, *FULL[1:]), (1, *HD[1:])):
            frames = (photo_frames(h, w, t) if content == "photo"
                      else synthetic(t, h, w))
            cases.append((f"{content} {t}x{w}x{h}", frames,
                          fs.encode_frames_shared(frames), (t, h, w)))
    # whole streams as one row of blocks: 1 frame of 8 x 8*nb pixels
    for name, stream in (("16-bit codes (encoder sets' longcodes)",
                          native.encode_symbols(encoder_sets()[0][1])),
                         ("128 T2 tables", wide_lut_stream(8192))):
        cases.append((name, None, stream,
                      (1, 8, 8 * stream.block_offsets.size)))
    return [(name, fs.prepare_shared(stream, *geo, device=device),
             ablate_decode.lut_tables(stream.widths, device), frames)
            for name, frames, stream, geo in cases]


def phase_e(device) -> tuple[dict, dict]:
    """The probes of B1 against their plain versions (and S1/S2 against the
    frames); returns (the launches each kernel made, after checking them;
    the max absolute difference per kernel, all 0)."""
    import torch

    from metalhuffman_tpu_torch.ops import decode_cuda
    from metalhuffman_tpu_torch.probes import ablate_decode, int16_rate, strips

    cases = probe_cases(device)
    rates = {v: int16_rate.make_input(RATE_SMALL, v, device)
             for v in int16_rate.VARIANTS}
    worst = dict.fromkeys(("decode_strips", "ablate_decode", "int16_rate"), 0)

    reset_launches()
    for name, p, lut, frames in cases:
        args = (p.words, p.offsets, p.symbols, p.bounds, p.adj)
        geo = dict(num_frames=p.num_frames, bh=p.bh, bw=p.bw)
        plain = decode_cuda.decode_images_plain(*args, **geo, delta=True)
        outs = {"S1 strips": strips.decode_strips(*args, **geo)}
        for v in ablate_decode.VARIANTS:
            outs[f"S2 {v}"] = ablate_decode.ablate_decode(
                *args, **geo, variant=v, lut=lut)
        for label, out in outs.items():
            want = (ablate_decode.xor_fold(plain, **geo)
                    if label == "S2 xorfold" else plain)
            # bytes: the xorfold words compared byte by byte
            err = int((out.view(torch.uint8).int()
                       - want.view(torch.uint8).int()).abs().max())
            kernel = "decode_strips" if label == "S1 strips" else "ablate_decode"
            worst[kernel] = max(worst[kernel], err)
            check(err == 0, f"phase E {name} {label}: kernel differs from "
                  f"plain by {err}")
            if frames is not None and label != "S2 xorfold":
                got = out[:, :p.height, :p.width].cpu().numpy()
                check(np.array_equal(got, frames),
                      f"phase E {name} {label}: differs from the frames")
        print(f"phase E ok: {name}: S1 and S2 {', '.join(ablate_decode.VARIANTS)}"
              f" == plain{' == frames' if frames is not None else ''} "
              f"({p.offsets.numel()} blocks, bw {p.bw}, {lut.num_t2} T2 "
              f"tables, {len(ablate_decode.pruned_terms(p.bounds, p.adj)[0])} "
              "compare terms)")
    for v, x in rates.items():
        out = int16_rate.int16_rate(x, v)
        err = int((out.long() - int16_rate.int16_rate_plain(x, v).long())
                  .abs().max())
        worst["int16_rate"] = max(worst["int16_rate"], err)
        check(err == 0, f"phase E S3 {v}: kernel differs from plain by {err}")
    print(f"phase E ok: S3 {', '.join(int16_rate.VARIANTS)} on {RATE_SMALL} "
          "elements == plain")
    counts = read_launches()
    expected = expect(decode_strips=len(cases),
                      ablate_decode=len(cases) * len(ablate_decode.VARIANTS),
                      int16_rate=len(rates))
    check(counts == expected,
          f"phase E: kernel launches {counts}, expected {expected}")
    print(f"phase E launches: {counts}")
    torch.cuda.synchronize()
    return counts, worst


def near_uniform(t: int, h: int, w: int, seed: int = 0) -> np.ndarray:
    """(T, H, W) i.i.d. random bytes, 16 of the 256 values twice as likely
    as the others: about 7.98 bits per symbol under codes of 7, 8 and 9
    bits. (Exactly uniform bytes get a complete 8-bit code, under which a
    flipped bit keeps every block's length and the end-bit check cannot see
    it.)"""
    rng = np.random.default_rng(seed)
    p = np.ones(256)
    p[rng.choice(256, 16, replace=False)] = 2
    return rng.choice(256, size=(t, h, w), p=p / p.sum()).astype(np.uint8)


def contrast_frames(h: int, w: int, t: int) -> np.ndarray:
    """(T, H, W) photo frames at T contrasts about mid-gray (0.55 to 1.42):
    each frame's deltas, and so its Huffman table, differ."""
    img = photo_frames(h, w, 1)[0].astype(np.float32)
    return np.stack([np.clip(128 + (img - 128) * (0.55 + 0.03 * i), 0, 255)
                     .astype(np.uint8) for i in range(t)])


def seek_flip(stream, lo_block: int, hi_block: int, seed: int,
              cfg) -> tuple[int, int]:
    """A code bit inside blocks [lo_block, hi_block) of an 8x8 stream whose
    flip the plain version's end-bit check flags -> (bit, block). Each try,
    from a seeded start, flips the bit in a copy of its block's bytes alone
    and decodes that block on the CPU."""
    from metalhuffman_tpu_torch.core import container
    from metalhuffman_tpu_torch.models.image_codec import decode_blocks_selection

    offs = stream.block_offsets.astype(np.int64)
    rng = np.random.default_rng(seed)
    for _ in range(64):
        b = int(rng.integers(lo_block, hi_block))
        bit = int(offs[b] + rng.integers(0, offs[b + 1] - offs[b]))
        lo = int(offs[b]) // 32 * 4  # the block's first word, in bytes
        code = stream.code_bytes[lo : int(offs[b + 1]) // 8 + 16].copy()
        code[bit // 8 - lo] ^= 128 >> (bit % 8)
        view = container.EncodedStream(
            128, stream.widths, code,
            (offs[b : b + 2] - 8 * lo).astype(np.uint32))
        _, err = decode_blocks_selection(view, [0], 8, 8, cfg, check=True,
                                         device="cpu")
        if err.any():
            return bit, b
    raise PhaseError("64 flipped bits, none flagged by the plain version")


def b1_against_plain(prep, cfg, emit_end: bool) -> int:
    """B1 on a staged batch against its plain version on the same CUDA
    tensors, bytes and (with ``emit_end``) end bits -> max abs difference.
    The kernel's launch is counted outside any phase's window."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    geo = dict(num_frames=prep.num_frames, bh=prep.bh, bw=prep.bw,
               delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d,
               emit_end=emit_end)
    got = decode_cuda.decode_images(*args, **geo, table=prep.table)
    want = decode_cuda.decode_images_plain(*args, **geo)
    if not emit_end:
        return int((got.int() - want.int()).abs().max())
    return max(int((got[0].int() - want[0].int()).abs().max()),
               int((got[1].long() - want[1].long()).abs().max()))


def phase_f(device) -> tuple[dict, dict, dict]:
    """Segmented MHV2, random access and MHTS at full size (F1, F2, F3);
    returns (the launches each kernel made, after checking them; the max
    absolute difference of B1 and B2 from their plain versions on F's
    inputs, all 0; F1's blob and F3's clip for :func:`stream_timings`)."""
    import torch

    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.image_codec import stage_selection
    from metalhuffman_tpu_torch.ops import decode_cuda

    _t, h, w = FULL
    # F1: 150 photo frames, 471,859,200 bytes: MHV2 segments of 136 and 14
    f1 = photo_frames(h, w, F1_FRAMES)
    t0 = time.perf_counter()
    blob1 = mt.encode_video(f1, CodecConfig(frame_crcs=True))
    enc1 = time.perf_counter() - t0
    segs1, *_ = fs.read_segmented(blob1)
    check([ft for _, ft in segs1] == [136, 14],
          f"F1: segments {[ft for _, ft in segs1]}, expected [136, 14]")
    print(f"phase F1: encode_video of {F1_FRAMES}x2048x1536 photo frames -> "
          f"MHV2 ({len(blob1)} B, segments [136, 14], FCRC) in {enc1:.2f} s")
    # F2: 137 near-uniform frames, no delta: segment 0 past 2^31 bits
    f2 = near_uniform(F2_FRAMES, h, w)
    cfg2 = CodecConfig(delta=False)
    blob2 = mt.encode_video(f2, cfg2)
    segs2, *_ = fs.read_segmented(blob2)
    s20 = segs2[0][0]
    per = (h // 8) * (w // 8)
    past = np.flatnonzero(s20.block_offsets >= np.uint32(1 << 31))
    first = int(past[0]) if past.size else None
    check([ft for _, ft in segs2] == [136, 1] and first is not None
          and first <= 86 * per,
          f"F2: segments {[ft for _, ft in segs2]}, first block offset past "
          f"2^31: {first}")
    print(f"phase F2: encode_video of {F2_FRAMES}x2048x1536 near-uniform "
          f"frames, no delta -> MHV2 ({len(blob2)} B, segments [136, 1]); "
          f"segment 0 is {8 * (s20.code_bytes.size - 2)} bits, {past.size} "
          f"block offsets past 2^31 from block {first} (frame "
          f"{None if first is None else first // per})")
    check(s20.block_offsets[120 * per] >= np.uint32(1 << 31),
          "F2: frame 120 starts below 2^31 bits")
    fbit, fblock = seek_flip(s20, 120 * per, 121 * per, 120, cfg2)
    bsegs = [(flip_bit(s20, fbit), 136), segs2[1]]
    # F3: an MHTS clip of 30 photo frames, one table each
    f3 = contrast_frames(h, w, F3_FRAMES)
    streams3 = fs.encode_frames(f3)
    blob3 = fs.write_stream(streams3, h, w, source_crc32s=[
        zlib.crc32(f.tobytes()) for f in f3])
    print(f"phase F3: MHTS of {F3_FRAMES}x2048x1536 photo frames "
          f"({len(blob3)} B, {len({s.widths.tobytes() for s in streams3})} "
          "distinct tables)")
    y0, x0, rh, rw = F_REGION
    expected = expect()

    reset_launches()
    got = mt.decode_video(blob1, device)  # CRC-checked
    expected["decode_images"] += 2
    check(np.array_equal(got, f1), "F1 decode_video: frames differ")
    del got
    got = fs.decode_frames_segmented(segs1, h, w, CodecConfig(), check=True,
                                     device=device)
    expected["decode_images"] += 2
    check(np.array_equal(got, f1), "F1 checked decode: frames differ")
    del got
    got, *_ = fs.decode_range(blob1, 130, 140, device=device)  # FCRC-checked
    expected["decode_images"] += 2
    check(np.array_equal(got, f1[130:140]), "F1 decode_range 130-140")
    for t in (135, 140):
        si, ft = (0, t) if t < 136 else (1, t - 136)
        got = fs.decode_frame(segs1[si][0], ft, h, w, device=device)
        expected["decode_images"] += 1
        check(np.array_equal(got, f1[t]), f"F1 decode_frame {t}")
    got = fs.decode_video_region(blob1, 134, 139, y0, x0, rh, rw, check=True,
                                 device=device)
    expected["decode_blocks"] += 2
    check(np.array_equal(got, f1[134:139, y0:y0 + rh, x0:x0 + rw]),
          "F1 decode_video_region 134-138")
    print("phase F1 ok: decode_video (CRC-checked), the checked decode, "
          "decode_range 130-140 (FCRC-checked, across the segments), "
          f"decode_frame 135 and 140, decode_video_region {rh}x{rw} at "
          f"({y0}, {x0}) over frames 134-138 with check: all equal to the "
          "frames")

    got = mt.decode_video(blob2, device)
    expected["decode_images"] += 2
    check(np.array_equal(got, f2), "F2 decode_video: frames differ")
    del got
    got = fs.decode_frames_segmented(segs2, h, w, cfg2, check=True,
                                     device=device)
    expected["decode_images"] += 2
    check(np.array_equal(got, f2), "F2 checked decode: frames differ")
    del got
    try:
        fs.decode_frames_segmented(bsegs, h, w, cfg2, check=True,
                                   device=device)
    except ValueError as e:
        check("segment 0" in str(e), f"F2 flipped checked decode: {e}")
        print(f"phase F2 ok: bit {fbit} flipped (block {fblock}, frame "
              f"{fblock // per}): the checked decode raises: {e}")
    else:
        raise PhaseError("F2: the checked decode of the flipped stream passed")
    expected["decode_images"] += 1  # segment 0 raises before segment 1
    got, *_ = fs.decode_range(blob2, 128, 137, device=device)
    expected["decode_images"] += 2
    check(np.array_equal(got, f2[128:137]), "F2 decode_range 128-137")
    print("phase F2 ok: decode_video, the checked decode (clean: no block "
          "flagged), decode_range 128-137: all equal to the frames")

    prep3 = fs.prepare_batch(streams3, h, w, device=device)
    got = fs.decode_batch(prep3).cpu().numpy()
    expected["decode_images"] += F3_FRAMES
    check(np.array_equal(got, f3), "F3 decode_batch: frames differ")
    for i, frame, err, crc in fs.iter_stream_frames(blob3, check=True,
                                                    device=device):
        check(not err.any() and np.array_equal(frame, f3[i])
              and zlib.crc32(frame.tobytes()) == crc,
              f"F3 iter_stream_frames(check=True): frame {i}")
    expected["decode_images"] += F3_FRAMES
    got, *_ = fs.decode_range(blob3, 10, 15, device=device)
    expected["decode_images"] += 5
    check(np.array_equal(got, f3[10:15]), "F3 decode_range 10-15")
    print(f"phase F3 ok: decode_batch ({F3_FRAMES} launches, one table "
          "each), iter_stream_frames(check=True) with the record CRCs, "
          "decode_range 10-15: all equal to the frames")
    counts = read_launches()
    check(counts == expected,
          f"phase F: kernel launches {counts}, expected {expected}")
    print(f"phase F launches: {counts}")

    # each kernel against its plain version on F's inputs (not counted)
    worst = {"decode_images": 0, "decode_blocks": 0}
    cfg = CodecConfig()
    for name, stream, ft, c in (("F1 segment 1", segs1[1][0], 14, cfg),
                                ("F2 segment 0", s20, 136, cfg2)):
        prep = fs.prepare_shared(stream, ft, h, w, c, device=device)
        for emit_end in (False, True):
            err = b1_against_plain(prep, c, emit_end)
            worst["decode_images"] = max(worst["decode_images"], err)
            check(err == 0, f"{name}: B1 (emit_end={emit_end}) differs from "
                  f"plain by {err}")
        del prep
        torch.cuda.empty_cache()
        print(f"phase F ok: B1 == plain on {name} ({ft} frames), with and "
              "without end bits")
    bprep = fs.prepare_shared(bsegs[0][0], 136, h, w, cfg2, device=device,
                              check=True)
    _, err = fs.decode_shared_step_checked(bprep, cfg2)
    ref = plain_mask(bprep, cfg2)
    check(np.array_equal(err, ref) and err[fblock]
          and np.flatnonzero(err).min() // per == 120,
          f"F2 flipped: kernel mask ({int(err.sum())} flagged) differs from "
          f"the plain version's ({int(ref.sum())}) or misses frame 120")
    print(f"phase F ok: F2 flipped segment 0: B1's mask == plain "
          f"({int(err.sum())} of {err.size} blocks flagged, from block "
          f"{np.flatnonzero(err).min()})")
    del bprep
    torch.cuda.empty_cache()
    bw = w // 8
    frame_sel = (np.arange(y0 // 8, (y0 + rh) // 8)[:, None] * bw
                 + np.arange(x0 // 8, (x0 + rw) // 8)[None, :]).ravel()
    for si, (stream, lo, hi) in enumerate(((segs1[0][0], 134, 136),
                                           (segs1[1][0], 0, 3))):
        sel = (frame_sel[None, :] + per * np.arange(lo, hi)[:, None]).ravel()
        staged, table = stage_selection(stream, sel, device=device)
        got = decode_cuda.decode_blocks(*staged, num_steps=64, delta=True,
                                        emit_end=True, table=table)
        want = decode_cuda.decode_blocks_plain(*staged, num_steps=64,
                                               delta=True, emit_end=True)
        err = max(int((got[0].int() - want[0].int()).abs().max()),
                  int((got[1].long() - want[1].long()).abs().max()))
        worst["decode_blocks"] = max(worst["decode_blocks"], err)
        check(err == 0, f"F1 region selection, segment {si}: B2 differs "
              f"from plain by {err}")
    for i, f in enumerate(prep3.frames):
        err = int((fs.decode_batch(dataclasses.replace(prep3, frames=(f,)))
                   .int() - decode_cuda.decode_images_plain(
                       f.words, f.offsets, f.symbols, f.bounds, f.adj,
                       num_frames=1, bh=f.bh, bw=f.bw, delta=True).int()
                   ).abs().max())
        worst["decode_images"] = max(worst["decode_images"], err)
        check(err == 0, f"F3 frame {i}: B1 differs from plain by {err}")
    print("phase F ok: B2 == plain on F1's region selections (bytes and end "
          f"bits); B1 == plain on each of F3's {F3_FRAMES} tables")
    torch.cuda.synchronize()
    return counts, worst, {"blob1": blob1, "f2 segment 0": s20, "f3": f3,
                           "streams3": streams3}


def stream_timings(device, card: str, ctx: dict) -> None:
    """Phase F's times: the MHV2 decode of F1 whole and each segment alone
    (host clock; each segment's staging, kernel and fetch apart, the kernel
    with CUDA events); the host build of each of F3's lookup tables; F3's
    MHTS decode (one launch per frame) against one MHTV launch of the same
    30 frames."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    _t, h, w = FULL
    cfg = CodecConfig()
    segs, total, *_ = fs.read_segmented(ctx["blob1"])

    def whole():
        return list(fs.iter_frames_segmented(segs, h, w, cfg, device=device))

    host_timed(f"MHV2 decode, whole ({total} frames, segments [136, 14], "
               "iter_frames_segmented)", lambda _: whole(), [None], card,
               total * h * w)
    alone = []
    for si, (stream, ft) in enumerate(segs):
        alone.append(host_timed(
            f"MHV2 segment {si} alone ({ft} frames, iter_frames_segmented)",
            lambda s: list(fs.iter_frames_segmented([s], h, w, cfg,
                                                    device=device)),
            [(stream, ft)], card, ft * h * w))
        words, stage, fetch = [], [], []
        for _ in range(HOST_ITERS):
            t0 = time.perf_counter()
            decode_cuda.prepare_stream(stream)
            words.append((time.perf_counter() - t0) * 1e3)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            prep = fs.prepare_shared(stream, ft, h, w, cfg, device=device)
            torch.cuda.synchronize()
            stage.append((time.perf_counter() - t0) * 1e3)
            raw = fs.decode_shared_step(prep, cfg, raw=True)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            raw.cpu().numpy()
            fetch.append((time.perf_counter() - t0) * 1e3)
        mid = HOST_ITERS // 2
        print(f"time MHV2 segment {si}: staging (prepare_shared, the bytes "
              f"swapped on the card) median {sorted(stage)[mid]:.4f} ms, "
              f"against {sorted(words)[mid]:.4f} ms for the host word view "
              f"alone (prepare_stream); fetch {sorted(fetch)[mid]:.4f} ms "
              f"({raw.numel()} B), host clock, on {card}")
        timed(f"B1 kernel MHV2 segment {si} ({ft} frames, decode_shared_step "
              "raw)", lambda p: fs.decode_shared_step(p, cfg, raw=True),
              [prep], card, ft * h * w)
        del prep, raw
    print(f"time MHV2 segments alone, summed: {sum(alone):.4f} ms, on {card}")
    cfg2 = CodecConfig(delta=False)
    prep = fs.prepare_shared(ctx["f2 segment 0"], 136, h, w, cfg2,
                             device=device)
    timed("B1 kernel F2 segment 0 (136 frames, offsets past 2^31, no delta)",
          lambda p: fs.decode_shared_step(p, cfg2, raw=True), [prep], card,
          136 * h * w)
    del prep

    streams = ctx["streams3"]
    builds = []
    for s in streams:
        meta = decode_cuda.canonical_meta(s.widths)
        t0 = time.perf_counter()
        decode_cuda._lookup_entries.__wrapped__(meta.bounds, meta.adj,
                                                meta.symbols.tobytes())
        builds.append((time.perf_counter() - t0) * 1e3)
    builds.sort()
    print(f"time lookup table host build (lookup_entries, uncached): median "
          f"{builds[len(builds) // 2]:.4f} ms over {len(builds)} tables (min "
          f"{builds[0]:.4f}, max {builds[-1]:.4f}), host clock, on {card}")

    def prepare_cold(_):
        decode_cuda._lookup_entries.cache_clear()
        return fs.prepare_batch(streams, h, w, device=device)

    n3 = len(streams) * h * w
    host_timed(f"MHTS prepare_batch {len(streams)} frames, tables built",
               prepare_cold, [None], card, n3)
    host_timed(f"MHTS prepare_batch {len(streams)} frames, tables cached",
               lambda _: fs.prepare_batch(streams, h, w, device=device),
               [None], card, n3)
    prep3 = fs.prepare_batch(streams, h, w, device=device)
    mhtv = fs.encode_frames_shared(ctx["f3"])
    prep_v = fs.prepare_shared(mhtv, len(streams), h, w, device=device)
    timed(f"MHTS decode_batch {len(streams)}x2048x1536 ({len(streams)} B1 "
          "launches, a table each)", fs.decode_batch, [prep3], card, n3)
    back_to_back("MHTS decode_batch", fs.decode_batch, [prep3], card, n3)
    timed(f"MHTV decode_shared_step {len(streams)}x2048x1536 (one B1 "
          "launch, one table)", lambda p: fs.decode_shared_step(p, cfg),
          [prep_v], card, n3)
    back_to_back("MHTV decode_shared_step",
                 lambda p: fs.decode_shared_step(p, cfg), [prep_v], card, n3)
    host_timed("MHTS decode_batch + fetch", lambda p: fs.decode_batch(p).cpu(),
               [prep3], card, n3)
    host_timed("MHTV decode_shared_step + fetch",
               lambda p: fs.decode_shared_step(p, cfg).cpu(), [prep_v], card,
               n3)


def depth_frames(h: int, w: int, t: int) -> np.ndarray:
    """(T, H, W) uint16 depth-like frames: the panned photo frames scaled
    to 12 bits, plus a slow gradient that does not pan (so motion
    compensation leaves small residuals that carry from the lo plane into
    the hi plane)."""
    grad = (np.arange(h, dtype=np.uint16)[:, None] // 4
            + np.arange(w, dtype=np.uint16)[None, :] // 2)
    return photo_frames(h, w, t).astype(np.uint16) * 16 + grad


def color_frames(h: int, w: int, t: int, c: int = 3) -> np.ndarray:
    """(T, H, W, C) uint8: the panned photo frames and C-1 copies shifted
    by 16 px down and 16 px right per channel (the last of four inverted)."""
    f = photo_frames(h, w, t)
    chans = [f] + [np.roll(f, (16 * k, 16 * k), axis=(1, 2))
                   for k in range(1, min(c, 3))]
    if c == 4:
        chans.append(255 - f)
    return np.stack(chans, axis=-1)


def flip_in_blob(blob: bytes, bit: int) -> bytes:
    """An MHVT blob whose MHTV inner has code bit ``bit`` flipped; the
    wrapper and both CRCs as they were."""
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig

    inner, keyint, crc, mvs, fcrcs, fl = temporal.unwrap(blob)
    stream, t, h, w, bd, delta = fs.read_shared(inner)
    inner = fs.write_shared(flip_bit(stream, bit), t, h, w,
                            CodecConfig(block_dim=bd, delta=delta),
                            source_crc32=fs.source_crc32(inner))
    return temporal.wrap(inner, keyint, crc, mvs, fcrcs, fl)


def iter_chunks(total: int, keyint: int, chunk: int) -> int:
    """The chunks ``iter_temporal_video`` makes of ``total`` frames with
    keyframe groups of ``keyint`` (the first group whole)."""
    n, base = 0, 0
    while base < total:
        end = min(base + chunk, total)
        if end < total:
            end = min(keyint - ((keyint - end) // keyint) * keyint, total)
        n, base = n + 1, end
    return n


def phase_g(device) -> tuple[dict, dict, dict]:
    """Temporal (MHVT), color (MHTC) and gray16 video at full size (G1-G6);
    returns (the launches each kernel made, after checking them; the max
    absolute difference of B1 and B2 from their plain versions on G's
    inputs, all 0; the blobs for :func:`temporal_timings`)."""
    import torch

    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import color
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.image_codec import stage_selection
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, (h, w) = G_FRAMES, FULL[1:]
    y0, x0, rh, rw = G_REGION
    k = G_KEYINT

    def encoded(label, fn, *args):
        t0 = time.perf_counter()
        blob = fn(*args)
        describe = (temporal.describe if blob[:4] == b"MHVT"
                    else color.describe)
        print(f"phase {label}: {len(blob)} B in "
              f"{time.perf_counter() - t0:.2f} s ({describe(blob)})")
        return blob

    size = f"{t}x{h}x{w}"
    g1 = photo_frames(h, w, t)
    blob1 = encoded(f"G1 gray MHVT {size}", mt.encode_video, g1,
                    CodecConfig(temporal=True, keyint=k, frame_crcs=True))
    blob2 = encoded(f"G2 MC MHVT {size}", mt.encode_video, g1,
                    CodecConfig(temporal=True, motion=True, keyint=k,
                                frame_crcs=True))
    g2s = photo_frames(*G_SMALL, t)
    blob2s = encoded(f"G2 MC MHVT {t}x{G_SMALL[0]}x{G_SMALL[1]}",
                     mt.encode_video, g2s,
                     CodecConfig(temporal=True, motion=True, keyint=k))
    mvs2 = temporal.unwrap(blob2)[3]
    check((mvs2[1:] != 0).any(), "G2: no motion vector found")
    g3 = color_frames(*G_COLOR, t)
    blob3 = encoded(f"G3 sub-green MHVT {t}x{G_COLOR[0]}x{G_COLOR[1]}x3",
                    temporal.encode_temporal_color_video, g3,
                    CodecConfig(temporal=True, keyint=k), color.CS_SUBGREEN)
    g3c = color_frames(*G_COLOR, G_SHORT, 4)
    blob3c = encoded(f"G3 MHTC {G_SHORT}x{G_COLOR[0]}x{G_COLOR[1]}x4",
                     mt.encode_color_video, g3c)
    g4 = depth_frames(h, w, t)
    blob4 = encoded(f"G4 u16 MC MHVT {size}",
                    temporal.encode_temporal_gray16_video, g4,
                    CodecConfig(temporal=True, motion=True, keyint=k))
    blob4i = encoded(f"G4 gray16 image {h}x{w}",
                     color.encode_gray16_to_bytes, g4[0])
    blob4v = encoded(f"G4 gray16 video {G_SHORT}x{h}x{w}",
                     color.encode_gray16_to_bytes, g4[:G_SHORT])
    f6 = photo_frames(h, w, F1_FRAMES)
    blob6 = encoded(f"G6 MHVT over MHV2 {F1_FRAMES}x{h}x{w}",
                    mt.encode_video, f6, CodecConfig(temporal=True, keyint=k))
    check(temporal.unwrap(blob6)[0][:4] == b"MHV2",
          "G6: the inner is not segmented")
    segs6 = [ft for _, ft in fs.read_segmented(temporal.unwrap(blob6)[0])[0]]
    # G5: a bit inside the region of G1's frame 10 (block row 96, columns
    # 96-159) whose flip the end-bit check flags, one outside (column 162)
    s1 = fs.read_shared(temporal.unwrap(blob1)[0])[0]
    per, bw = (h // 8) * (w // 8), w // 8
    row = 10 * per + (y0 + rh // 2) // 8 * bw
    bit_in, block_in = seek_flip(s1, row + x0 // 8, row + (x0 + rw) // 8, 5,
                                 CodecConfig())
    offs = s1.block_offsets.astype(np.int64)
    bit_out = int(offs[row + (x0 + rw) // 8 + 2]) + 3
    keyed = blob1[:4] + struct.pack("<H", k - 1) + blob1[6:]
    expected = expect()

    reset_launches()

    def equal(got, want, what):
        check(got.dtype == want.dtype and np.array_equal(got, want),
              f"{what}: differs from the source")

    got = mt.decode_video(blob1, device)
    equal(got, g1, "G1 decode_video")
    res = fs.decode_container_device(temporal.unwrap(blob1)[0],
                                     device=device).cpu().numpy()
    equal(got, temporal.temporal_decode(res, k), "G1 numpy temporal_decode")
    expected["decode_images"] += 2
    print("phase G1 ok: decode_video of the MHVT (B1, the group fold on the "
          "card, one fetch, outer CRC and FCRC) == the frames == numpy "
          "temporal_decode of the fetched residuals")
    for blob, frames, name in ((blob2, g1, size),
                               (blob2s, g2s, f"{t}x{G_SMALL[0]}x{G_SMALL[1]}")):
        inner, _k, _c, mvs, _f, _fl = temporal.unwrap(blob)
        got = mt.decode_video(blob, device)
        equal(got, frames, f"G2 decode_video {name}")
        res = fs.decode_container_device(inner, device=device).cpu().numpy()
        equal(got, temporal.temporal_decode_mc(res, k, mvs),
              f"G2 numpy temporal_decode_mc {name}")
        expected["decode_images"] += 2
        print(f"phase G2 ok: decode_video of the MC MHVT {name} (vectors "
              f"{sorted({tuple(v) for v in mvs.tolist()})}) == the frames == "
              "numpy temporal_decode_mc of the fetched residuals")
    equal(mt.decode_color_video(blob3, device), g3, "G3 decode_color_video")
    equal(temporal.decode_temporal_frame(blob3, 13, device), g3[13],
          "G3 decode_temporal_frame 13")
    equal(temporal.decode_temporal_video_region(blob3, 5, 13, y0, x0, rh, rw,
                                                True, device=device),
          g3[5:13, y0:y0 + rh, x0:x0 + rw], "G3 region")
    expected["decode_images"] += 2
    expected["decode_blocks"] += 1
    equal(mt.decode_color_video(blob3c, device), g3c, "G3 4-channel MHTC")
    equal(color.decode_color_frame(blob3c, 7, device), g3c[7],
          "G3 4-channel decode_color_frame 7")
    equal(color.decode_color_video_region(blob3c, 2, 9, y0, x0, rh, rw, True,
                                          device=device),
          g3c[2:9, y0:y0 + rh, x0:x0 + rw], "G3 4-channel region")
    expected["decode_images"] += 2
    expected["decode_blocks"] += 1
    print("phase G3 ok: sub-green MHVT (decode_color_video, "
          f"decode_temporal_frame 13, a checked {rh}x{rw} region over frames "
          "5-12) and 4-channel MHTC (decode_color_video, decode_color_frame "
          f"7, a checked {rh}x{rw} region over frames 2-8) == the frames")
    equal(mt.decode_video(blob4, device), g4, "G4 u16 MC MHVT")
    equal(color.decode_gray16_from_bytes(blob4i, device), g4[0],
          "G4 gray16 image")
    equal(color.decode_gray16_from_bytes(blob4v, device), g4[:G_SHORT],
          "G4 gray16 video")
    equal(color.decode_color_frame(blob4v, 3, device), g4[3],
          "G4 gray16 frame 3")
    expected["decode_images"] += 4
    print("phase G4 ok: the u16 MC MHVT (the lo-to-hi carry), a gray16 "
          "image, a gray16 video and its frame 3 == the frames")

    for blob, name, mc in ((blob1, "G1", False), (blob2, "G2", True)):
        equal(temporal.decode_temporal_range(blob, 5, 14, device), g1[5:14],
              f"G5 {name} decode_temporal_range 5-13")
        equal(temporal.decode_temporal_frame(blob, t - 1, device), g1[t - 1],
              f"G5 {name} decode_temporal_frame {t - 1}")
        chunks = list(temporal.iter_temporal_video(blob, device,
                                                   chunk_frames=10))
        check([b for b, _ in chunks] == [0, 16][: len(chunks)],
              f"G5 {name} iter chunks at {[b for b, _ in chunks]}")
        equal(np.concatenate([c for _, c in chunks]), g1,
              f"G5 {name} iter_temporal_video")
        equal(temporal.decode_temporal_video_region(
            blob, 9, 12, y0, x0, rh, rw, True, device=device),
            g1[9:12, y0:y0 + rh, x0:x0 + rw], f"G5 {name} checked region")
        # the range, the frame, the chunks; an MC region is a range
        expected["decode_images"] += 2 + iter_chunks(t, k, 10) + int(mc)
        expected["decode_blocks"] += 0 if mc else 1
    try:
        temporal.decode_temporal_video_region(
            flip_in_blob(blob1, bit_in), 9, 12, y0, x0, rh, rw, True,
            device=device)
    except ValueError as e:
        check("integrity" in str(e), f"G5 inside flip: {e}")
        print(f"phase G5 ok: a flipped bit inside the region (bit {bit_in}, "
              f"block {block_in}) raises: {e}")
    else:
        raise PhaseError("G5: a flip inside the region passed the check")
    equal(temporal.decode_temporal_video_region(
        flip_in_blob(blob1, bit_out), 9, 12, y0, x0, rh, rw, True,
        device=device), g1[9:12, y0:y0 + rh, x0:x0 + rw], "G5 outside flip")
    expected["decode_blocks"] += 2
    try:
        mt.decode_video(keyed, device)
    except ValueError as e:
        check("wrapper header" in str(e), f"G5 changed keyint: {e}")
        print(f"phase G5 ok: keyint {k} rewritten as {k - 1} raises: {e}")
    else:
        raise PhaseError("G5: a changed keyint decoded")
    expected["decode_images"] += 2  # the decode and the localizing decode
    print("phase G5 ok: G1 and G2 decode_temporal_range 5-13, "
          f"decode_temporal_frame {t - 1}, iter_temporal_video(chunk_frames="
          f"10) with its CRC chain, a checked {rh}x{rw} region over frames "
          "9-11:"
          " all equal to the frames; a flip outside the region passes")

    got = mt.decode_video(blob6, device)
    equal(got, f6, "G6 MHVT over MHV2")
    expected["decode_images"] += len(segs6)
    del got
    print(f"phase G6 ok: decode_video of the MHVT over an MHV2 of segments "
          f"{segs6} == the {F1_FRAMES} frames")
    counts = read_launches()
    check(counts == expected,
          f"phase G: kernel launches {counts}, expected {expected}")
    print(f"phase G launches: {counts}")

    # the kernels against their plain versions on G's inputs (not counted)
    worst = {"decode_images": 0, "decode_blocks": 0}
    for name, blob in (("G2 small residuals", blob2s),
                       ("G3 color planes", blob3)):
        planes = temporal._plane_inner(temporal.unwrap(blob)[0])[0]
        stream, ft, ph, pw, _bd, _d = fs.read_shared(planes)
        prep = fs.prepare_shared(stream, ft, ph, pw, device=device)
        err = b1_against_plain(prep, CodecConfig(), False)
        worst["decode_images"] = max(worst["decode_images"], err)
        check(err == 0, f"{name}: B1 differs from plain by {err}")
        del prep
    frame_sel = (np.arange(y0 // 8, (y0 + rh) // 8)[:, None] * bw
                 + np.arange(x0 // 8, (x0 + rw) // 8)[None, :]).ravel()
    sel = (frame_sel[None, :] + per * np.arange(8, 12)[:, None]).ravel()
    staged, table = stage_selection(s1, sel, device=device)
    got = decode_cuda.decode_blocks(*staged, num_steps=64, delta=True,
                                    emit_end=True, table=table)
    want = decode_cuda.decode_blocks_plain(*staged, num_steps=64, delta=True,
                                           emit_end=True)
    err = max(int((got[0].int() - want[0].int()).abs().max()),
              int((got[1].long() - want[1].long()).abs().max()))
    worst["decode_blocks"] = err
    check(err == 0, f"G1 region selection: B2 differs from plain by {err}")
    torch.cuda.synchronize()
    print(f"phase G ok: B1 == plain on G2's {G_SMALL[0]}x{G_SMALL[1]} "
          f"residuals and G3's {3 * t} color planes; B2 == plain on G1's "
          "region selection (bytes and end bits)")
    return counts, worst, {"G1": blob1, "G2": blob2,
                           f"G2 {G_SMALL[0]}x{G_SMALL[1]}": blob2s,
                           "G3": blob3, "G4": blob4}


def mc_split(res, keyint: int, mvs) -> tuple[float, float]:
    """One in-place motion-compensated fold of ``res`` as
    ``temporal_fold_mc`` runs it, with CUDA events around each gather-roll
    and each add -> (roll ms, add ms), summed."""
    import torch

    from metalhuffman_tpu_torch.models import temporal

    t, hh, ww = res.shape[:3]
    x = res.view(torch.int16) if res.dtype == torch.uint16 else res
    mv = np.asarray(mvs).astype(np.int64) % np.array([hh, ww])
    mv_dev = torch.from_numpy(mv).to(res.device)
    marks = {"roll": [], "add": []}

    def event():
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    for start, g, n in temporal._groups(t, keyint, None):
        grp = x[start : start + g * n].view((g, n) + tuple(x.shape[1:]))
        mvg = mv[start : start + g * n].reshape(g, n, 2)
        dvg = mv_dev[start : start + g * n].view(g, n, 2)
        for s in range(1, n):
            if mvg[:, s].any():
                e0 = event()
                pred = temporal.roll_groups(grp[:, s - 1], dvg[:, s, 0],
                                            dvg[:, s, 1])
                e1 = event()
                marks["roll"].append((e0, e1))
            else:
                pred = grp[:, s - 1]
            e1 = event()
            grp[:, s].add_(pred)
            marks["add"].append((e1, event()))
    torch.cuda.synchronize()
    return tuple(sum(a.elapsed_time(b) for a, b in marks[k])
                 for k in ("roll", "add"))


def temporal_timings(device, card: str, blobs: dict) -> None:
    """Phase G's times, for G1-G4: staging, B1, the plane fold, the
    temporal fold (CUDA events, in place on the decoded residuals; each
    fold beside its byte bound, the stack read once and written once), the
    fetch, the CRC and the whole ``decode_video`` call (host clock); the
    MHTV decode of the same residuals (``decode_video`` of the inner, with
    its fetch and CRC) as the yardstick; for the MC folds the gather-rolls
    and the adds apart."""
    import torch

    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import color
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig

    for label, blob in blobs.items():
        inner, k, _crc, mvs, _fc, fl = temporal.unwrap(blob)
        planes_blob, cinfo = temporal._plane_inner(inner)
        stream, n, h, w, bd, delta = fs.read_shared(planes_blob)
        cfg = CodecConfig(block_dim=bd, delta=delta)
        nb = n * h * w
        host_timed(f"{label} staging (prepare_shared, {n} planes {h}x{w})",
                   lambda s: fs.prepare_shared(s, n, h, w, cfg,
                                               device=device),
                   [stream], card, nb)
        prep = fs.prepare_shared(stream, n, h, w, cfg, device=device)
        b1_ms = timed(f"{label} B1 (decode_shared_step, cropped)",
                      lambda p: fs.decode_shared_step(p, cfg), [prep], card,
                      nb)
        planes = fs.decode_shared_step(prep, cfg)
        del prep
        res = planes
        if cinfo is not None:
            timed(f"{label} plane fold (fold_video_planes_torch)",
                  lambda x: color.fold_video_planes_torch(x, *cinfo),
                  [planes], card, nb, "folded")
            roofline(f"{label} plane fold", 2 * nb, 0)
            res = color.fold_video_planes_torch(planes, *cinfo)
        if mvs is None:
            fold_ms = timed(f"{label} group fold (temporal_fold, keyint {k})",
                            lambda x: temporal.temporal_fold(x, k, fl), [res],
                            card, nb, "folded")
        else:
            fold_ms = timed(f"{label} MC fold (temporal_fold_mc, keyint {k})",
                            lambda x: temporal.temporal_fold_mc(
                                x, k, mvs, fl), [res], card, nb, "folded")
            splits = [mc_split(res, k, mvs) for _ in range(HOST_ITERS)]
            rolls = sorted(r for r, _ in splits)
            adds = sorted(a for _, a in splits)
            mid = HOST_ITERS // 2
            print(f"time {label} MC fold split: gather-rolls median "
                  f"{rolls[mid]:.4f} ms, adds median {adds[mid]:.4f} ms over "
                  f"{HOST_ITERS} folds (CUDA events around each); the fold "
                  f"{fold_ms / b1_ms:.3f}x B1 on the same frames, on {card}")
        bms, _by = roofline(f"{label} temporal fold", 2 * nb, 0)
        print(f"{label} temporal fold: {100 * bms / fold_ms:.1f} % of its "
              "byte bound")
        host_timed(f"{label} fetch ({nb} B)", lambda x: x.cpu().numpy(),
                   [res], card, nb)
        frames = res.cpu().numpy()
        host_timed(f"{label} CRC-32 of the frames", temporal._crc, [frames],
                   card, nb)
        del planes, res, frames
        torch.cuda.empty_cache()
        host_timed(f"{label} decode_video, whole call",
                   lambda b: mt.decode_video(b, device), [blob], card, nb)
        host_timed(f"{label} yardstick: decode_video of the residual MHTV",
                   lambda b: mt.decode_video(b, device), [planes_blob], card,
                   nb)


def free_port() -> int:
    """A TCP port of this host that no one listens on now."""
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def skewed(n: int, seed: int) -> np.ndarray:
    """Symbols of 40 values at frequencies 0.82^i: odd-width codes, so the
    ranks' runs meet at any bit phase (the JAX package's sharded encoder
    tests' set)."""
    p = 0.82 ** np.arange(40)
    return np.random.default_rng(seed).choice(
        np.arange(40), size=n, p=p / p.sum()).astype(np.uint8)


def max_err(a, b) -> int:
    """Largest absolute difference of two equal-shaped tensors."""
    return int((a.long() - b.long()).abs().max()) if a.numel() else 0


def h_seams(device, frames3, streams3) -> tuple[dict, set]:
    """Phase H's seams: the local steps of worlds H_WORLDS, each rank in
    turn with no collective, assembled by the port's gather and splice
    code; every rank's kernel output held to its plain version, every
    assembly to the source. Returns (max absolute difference from the
    plain versions, by kernel; the bit phases the encode seams landed on)."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import blocks
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda
    from metalhuffman_tpu_torch.parallel import shard_decode, shard_encode

    _t, h, w = FULL
    t = H_DEPTH
    frames = photo_frames(h, w, t)
    worst = dict.fromkeys(("decode_images", "decode_blocks", "encode_stream"),
                          0)
    phases = set()
    payloads = [("photo delta + 37-symbol tail", np.concatenate(
        [delta_payload(frames), delta_payload(frames[:1])[:37]]))] + [
        (f"skewed set, seed {seed}", skewed(H_SKEWED, seed))
        for seed in H_SEEDS]
    for world in H_WORLDS:
        for cfg in (CodecConfig(), CodecConfig(block_dim=16)):
            kernel = "decode_images" if cfg.block_dim == 8 else "decode_blocks"
            stream = fs.encode_frames_shared(frames, cfg)
            units = t * (h // 8) if cfg.block_dim == 8 else \
                t * (h // 16) * (w // 16)
            per_unit = w // 8 if cfg.block_dim == 8 else 1
            parts = []
            for r in range(world):
                local, (lo, hi) = fs.decode_shared_local(
                    stream, t, h, w, cfg, rank=r, world=world, device=device)
                ins = shard_decode.shard_stream_inputs(
                    stream, lo * per_unit, hi * per_unit, cfg.block_size,
                    device=device)[:5]
                plain = (decode_cuda.decode_images_plain(
                    *ins, num_frames=1, bh=hi - lo, bw=per_unit,
                    delta=True)[0] if cfg.block_dim == 8 else
                    decode_cuda.decode_blocks_plain(
                        *ins, num_steps=cfg.block_size, delta=True))
                worst[kernel] = max(worst[kernel], max_err(local, plain))
                parts.append(local)
            got = fs.frames_from_shards(parts, t, h, w, cfg).cpu().numpy()
            check(np.array_equal(got, frames) and worst[kernel] == 0,
                  f"phase H seams, world {world}, {cfg.block_dim}x"
                  f"{cfg.block_dim}: {int((got != frames).sum())} bytes "
                  f"differ, {worst[kernel]} from plain")
        prep = fs.prepare_batch(streams3[:t], h, w, device=device)
        # a (1, world) grid: every rank a block range of every frame
        parts = [fs.decode_batch_local(prep, seq=(r, world))
                 for r in range(world)]
        blk = shard_decode.assemble_grid(parts, [list(range(world))])
        nb = (h // 8) * (w // 8)
        for i, f in enumerate(prep.frames):
            b0 = 0
            for r in range(world):
                lo, hi = shard_decode.block_range(r, world, nb)
                plain = decode_cuda.decode_blocks_plain(
                    f.words, f.offsets[lo:hi], f.symbols, f.bounds, f.adj,
                    num_steps=64, delta=True)
                worst["decode_blocks"] = max(worst["decode_blocks"], max_err(
                    parts[r][i, : hi - lo], plain))
        got = blocks.blocks_to_image_torch(blk[:, :nb], h, w).cpu().numpy()
        check(np.array_equal(got, frames3[:t]) and worst["decode_blocks"] == 0,
              f"phase H seams, world {world}: decode_batch_local differs")
        for name, data in payloads:
            widths, codes = encode_cuda.canonical_table(data)
            table = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(
                device)
            sym = torch.from_numpy(data).to(device)
            runs, offsets = [], []
            locs = [shard_encode.encode_stream_local(sym[slice(
                *shard_encode.symbol_range(r, world, data.size))], table)
                for r in range(world)]
            totals = [total for _, _, total in locs]
            bases = shard_encode.rank_bases(totals)
            phases.update(b & 7 for b in bases[1:])
            for r, ((stream, offs, total), base) in enumerate(zip(locs, bases)):
                lo, hi = shard_encode.symbol_range(r, world, data.size)
                p_stream, p_offs, p_total = encode_cuda.encode_stream_plain(
                    sym[lo:hi], table)
                worst["encode_stream"] = max(
                    worst["encode_stream"], max_err(stream, p_stream),
                    max_err(offs, p_offs), abs(total - p_total))
                runs.append(shard_encode.place_run(stream, total, base))
                offsets.append(shard_encode.rebase_offsets(offs, base))
            got = shard_encode.assemble_stream(runs, totals, offsets,
                                               data.size, widths)
            check(same_stream(got, native.encode_symbols(data))
                  and worst["encode_stream"] == 0,
                  f"phase H seams, world {world}, {name}: the spliced stream "
                  "differs from the host encoder's, or a rank's from plain")
        print(f"phase H ok: world {world}, each rank in turn: B1 (8x8) and "
              f"B2 (16x16) on {t}x{h}x{w} photo block ranges, B2 on {t} "
              f"frames of the MHTS clip, encode_stream on {len(payloads)} "
              "payloads; each == plain and assembled == the source")
    check(phases == set(range(8)), f"phase H seams: the encode seams "
          f"reached bit phases {sorted(phases)}, not all 8")
    return worst, phases


def phase_h(device, card: str, frames3, streams3) -> tuple[dict, dict, dict]:
    """Multi-GPU decode and encode (``metalhuffman_tpu_torch.parallel``)
    through a one-rank NCCL group at full size, then the seams
    (:func:`h_seams`) and the times; returns (the launches each kernel
    made before the times, after checking them; the max absolute
    difference of each kernel from its plain version; the times)."""
    import torch
    import torch.distributed as dist

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import blocks
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda
    from metalhuffman_tpu_torch.parallel import mesh, multihost, shard_decode, shard_encode

    t, h, w = FULL
    t0 = time.perf_counter()
    rank, world = multihost.initialize(f"tcp://127.0.0.1:{free_port()}", 1, 0,
                                       device=device)
    print(f"phase H: {dist.get_backend()} group of {world} on {device}, "
          f"rank {rank}, set up in {time.perf_counter() - t0:.3f} s")
    try:
        m = mesh.make_mesh(device=device)
        m2 = mesh.make_mesh_2d(device=device)
        synth = synthetic(t, h, w)
        cfg16 = CodecConfig(block_dim=16)
        stream8 = fs.encode_frames_shared(synth, CodecConfig())
        stream16 = fs.encode_frames_shared(synth, cfg16)
        payload = delta_payload(synth)
        tailed = np.concatenate([payload, payload[:17]])
        hosts = {n: native.encode_symbols(p)
                 for n, p in (("payload", payload), ("tailed", tailed))}
        prep16 = fs.prepare_shared(stream16, t, h, w, cfg16, device=device)
        args16 = (prep16.words, prep16.offsets, prep16.symbols, prep16.bounds,
                  prep16.adj)
        prep3 = fs.prepare_batch(streams3, h, w, device=device)
        body = torch.from_numpy(payload.reshape(-1, 64)).to(device)
        widths, codes = encode_cuda.canonical_table(payload)
        table = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(
            device)
        bits = encode_cuda.block_bits(payload.reshape(-1, 64), widths)
        wmax = int(bits.max()) // 32 + 2

        reset_launches()
        local, rng = fs.decode_shared_sharded(stream8, t, h, w, m,
                                              device=device)
        got = fs.gather_shared(local, t, h, w, m)
        single = fs.decode_frames_shared(stream8, t, h, w, device=device)
        check(rng == (0, t * h // 8) and torch.equal(got, single)
              and np.array_equal(got.cpu().numpy(), synth),
              "phase H decode_shared_sharded: differs from the frames or "
              "the single-device decode")
        out = shard_decode.decode_blocks_sharded(
            *args16, mesh=m, num_steps=256, table=prep16.table)
        single = decode_cuda.decode_blocks(*args16, num_steps=256, delta=True,
                                           table=prep16.table)
        check(torch.equal(out, single) and np.array_equal(
            blocks.blocks_to_image_torch(out.view(t, -1, 256), h, w, 16)
            .cpu().numpy(), synth),
            "phase H decode_blocks_sharded 16x16: differs")
        out = fs.decode_batch_sharded(prep3, m2)
        got = blocks.blocks_to_image_torch(out, h, w)
        check(torch.equal(got, fs.decode_batch(prep3))
              and np.array_equal(got.cpu().numpy(), frames3),
              "phase H decode_batch_sharded: differs from decode_batch or "
              "the frames")
        print(f"phase H ok: decode_shared_sharded + gather_shared (B1), "
              f"decode_blocks_sharded 16x16 (B2), decode_batch_sharded of "
              f"the {len(streams3)}-table MHTS clip (B2) at {t}x{h}x{w}: "
              "== the frames and the single-device decodes")
        for name, data in (("payload", payload), ("tailed", tailed)):
            hybrid = encode_cuda.encode_symbols_hybrid(data, device=device)
            got = multihost.encode_symbols_multihost(data, mesh=m,
                                                     device=device)
            check(same_stream(got, hosts[name]) and same_stream(got, hybrid),
                  f"phase H encode_symbols_sharded ({name}): the stream "
                  "differs from the host encoder's or the hybrid's")
        rows, totals = shard_encode.encode_rows_sharded(body, table, wmax=wmax,
                                                        mesh=m)
        check(totals.tolist() == [int(bits.astype(np.int64).sum())]
              and torch.equal(rows[:, wmax].cpu(),
                              torch.from_numpy(bits.view(np.int32))),
              "phase H encode_rows_sharded: totals differ from the block "
              "bits")
        print(f"phase H ok: encode_symbols_sharded (= "
              f"encode_symbols_multihost) ({payload.size} symbols, and "
              f"with a 17-symbol tail) == host encoder == "
              f"encode_symbols_hybrid; encode_rows_sharded "
              f"totals {totals.tolist()} == the block bits")
        seams, phases = h_seams(device, frames3, streams3)
        counts = read_launches()
        n_seam = sum(H_WORLDS)
        expected = expect(
            decode_images=2 + len(streams3) + n_seam,
            decode_blocks=2 + len(streams3) + n_seam + H_DEPTH * n_seam,
            encode_stream=4 + (1 + len(H_SEEDS)) * n_seam, encode_rows=1)
        check(counts == expected,
              f"phase H: kernel launches {counts}, expected {expected}")
        print(f"phase H launches: {counts}; encode seams at bit phases "
              f"{sorted(phases)}")
        errs = dict(seams, encode_rows=max_err(
            rows, encode_cuda.encode_rows_plain(body, table, wmax=wmax)))
        check(errs["encode_rows"] == 0, "phase H: B3's rows differ from plain")
        times = h_timings(device, card, m, m2, stream8, args16, prep16.table,
                          prep3, payload)
    finally:
        dist.destroy_process_group()
    return counts, errs, times


def h_timings(device, card: str, m, m2, stream8, args16, table16, prep3,
              payload) -> dict:
    """Phase H's times: each sharded call against its single-device call,
    and the gather, the cross-check and the splice apart."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.ops import decode_cuda, encode_cuda
    from metalhuffman_tpu_torch.parallel import multihost, shard_decode, shard_encode

    t, h, w = FULL
    size = t * h * w

    def shared_sharded(_):
        local, _r = fs.decode_shared_sharded(stream8, t, h, w, m,
                                             device=device)
        return fs.gather_shared(local, t, h, w, m)

    times = {
        "decode_shared_sharded+gather_shared": host_timed(
            "H decode_shared_sharded + gather_shared (stage, B1, gather)",
            shared_sharded, [0], card, size),
        "decode_frames_shared": host_timed(
            "H decode_frames_shared (stage, B1)", lambda _: (
                fs.decode_frames_shared(stream8, t, h, w, device=device)),
            [0], card, size),
        "decode_blocks_sharded 16x16": timed(
            "H decode_blocks_sharded 16x16 (B2, all-gather)", lambda _: (
                shard_decode.decode_blocks_sharded(
                    *args16, mesh=m, num_steps=256, table=table16)),
            [0], card, size),
        "decode_blocks 16x16": timed(
            "H decode_blocks 16x16 (B2)", lambda _: decode_cuda.decode_blocks(
                *args16, num_steps=256, delta=True, table=table16),
            [0], card, size),
        "decode_batch_sharded": timed(
            "H decode_batch_sharded MHTS (B2 x 30, all-gather)",
            lambda _: fs.decode_batch_sharded(prep3, m2), [0], card, size),
        "decode_batch": timed(
            "H decode_batch MHTS (B1 x 30)", lambda _: fs.decode_batch(prep3),
            [0], card, size),
    }
    for name, fn in (("encode_symbols_sharded",
                      shard_encode.encode_symbols_sharded),
                     ("encode_symbols_hybrid",
                      encode_cuda.encode_symbols_hybrid)):
        kw = {} if name == "encode_symbols_hybrid" else {"mesh": m}
        times[name] = host_timed(f"H {name}", lambda x, fn=fn, kw=kw: fn(
            x, device=device, **kw), [payload], card, payload.size)
    blk = torch.zeros((size // 64, 64), dtype=torch.uint8, device=device)
    times["gather_rows 94.4 MB"] = timed(
        "H gather_rows of the decoded batch (NCCL all_gather, 1 rank)",
        lambda x: shard_decode.gather_rows(x, x.shape[0]), [blk], card, size)
    sym = torch.from_numpy(payload).to(device)
    widths, codes = encode_cuda.canonical_table(payload)
    wt = torch.from_numpy(widths).to(device, torch.int64)
    times["cross-check"] = timed(
        "H cross-check (bincount x widths)", lambda x: (
            torch.bincount(x, minlength=256) * wt).sum(), [sym], card,
        payload.size, "symbols")
    table = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(device)
    stream, _o, total = encode_cuda.encode_stream(sym, table)
    code = torch.zeros_like(stream)

    def splice(base):
        shard_encode.splice_run(code, base,
                                shard_encode.place_run(stream, total, base))

    times["place_run+splice_run lead 0"] = timed(
        "H place_run + splice_run, lead 0", splice, [0], card, stream.numel(),
        "stream")
    times["place_run+splice_run lead 5"] = timed(
        "H place_run + splice_run, lead 5", splice, [5], card, stream.numel(),
        "stream")
    return times


def timed(label: str, fn, inputs, card: str, nbytes: int,
          unit: str = "decoded") -> float:
    """Median ms of ``fn`` over TIMED_ITERS calls cycling over ``inputs``,
    with CUDA events; prints it, as ``nbytes`` per call in GB/s ``unit``,
    beside the card."""
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
          f"{nbytes / med / 1e6:.3f} GB/s {unit}, on {card}")
    return med


def host_timed(label: str, fn, inputs, card: str, nbytes: int) -> float:
    """Median ms of ``fn`` over HOST_ITERS calls cycling over ``inputs``, on
    the host's clock, each call ended by a device synchronize; prints it, as
    ``nbytes`` per call in GB/s, beside the card."""
    import torch

    fn(inputs[0])  # warm up
    times = []
    for i in range(HOST_ITERS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(inputs[i % len(inputs)])
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    times.sort()
    med = times[len(times) // 2]
    print(f"time {label}: median {med:.4f} ms over {len(times)} calls "
          f"(min {times[0]:.4f}, max {times[-1]:.4f}), "
          f"{nbytes / med / 1e6:.3f} GB/s, host clock, on {card}")
    return med


def roofline(label: str, nbytes: int, n_ops: int) -> tuple[float, str]:
    """(least ms, what binds), printed with both terms: ``nbytes`` over the
    HBM rate, or ``n_ops`` integer operations over the INT32 rate."""
    by_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    by_ops = n_ops / INT32_OPS_PER_S * 1e3
    by = "bytes" if by_bytes >= by_ops else "operations"
    print(f"bound {label}: {max(by_bytes, by_ops):.4f} ms ({by}; bytes "
          f"{nbytes} -> {by_bytes:.4f} ms, operations {n_ops} -> "
          f"{by_ops:.4f} ms)")
    return max(by_bytes, by_ops), by


def bound(label: str, prep, n_symbols: int) -> tuple[float, str]:
    """(least ms, what binds) for a decode of a staged batch: every input
    byte read once and every output byte written once, or OPS_PER_SYMBOL
    integer operations per symbol."""
    nbytes = 4 * prep.words.numel() + 4 * prep.offsets.numel() + 256 + n_symbols
    return roofline(label, nbytes, n_symbols * OPS_PER_SYMBOL)


def staged_batches(device, cfg):
    """VARIANTS staged 30x2048x1536 batches under one config: frame-order
    rotations of the synthetic batch, so distinct bitstreams in distinct
    buffers."""
    from metalhuffman_tpu_torch.models import frame_stream as fs

    base = synthetic(*FULL)
    return base, [fs.prepare_shared(
        fs.encode_frames_shared(np.roll(base, v, axis=0), cfg), *FULL, cfg,
        device=device) for v in range(VARIANTS)]


def back_to_back(label: str, fn, inputs, card: str, nbytes: int) -> float:
    """Mean ms of TIMED_ITERS calls of ``fn`` queued back to back over
    ``inputs`` between two CUDA events: the host's launch work overlaps the
    device's, so the mean approaches the device time of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for i in range(TIMED_ITERS):
        fn(inputs[i % len(inputs)])
    end.record()
    end.synchronize()
    mean = start.elapsed_time(end) / TIMED_ITERS
    print(f"time {label} back-to-back: mean {mean:.4f} ms over "
          f"{TIMED_ITERS} queued calls, {nbytes / mean / 1e6:.3f} GB/s "
          f"decoded, on {card}")
    return mean


def report_shape(label: str, name: str, prep, num_steps: int = 64) -> None:
    """Print the grid of kernel ``name`` on a staged batch (1-D delta) and
    what ptxas gave the kernel."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    nb = prep.offsets.numel()
    s = decode_cuda.launch_shape(name, prep.words.numel(), nb, prep.table,
                                 num_steps=num_steps)
    threads = s["grid"] * 256
    print(f"grid {label}: {s['ctas_per_sm']} resident CUDA blocks of 256 per "
          f"SM, grid {s['grid']}, shared memory per CUDA block "
          f"{s['dyn_smem']} B table + {s['static_smem']} B static "
          f"({prep.table.num_t2} T2 tables of 32 entries); "
          f"{s['registers']} registers, {s['local_bytes']} B local "
          f"(spills) per thread; {nb / threads:.3f} blocks per thread, the "
          f"busiest {-(-nb // threads)}")


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
            emit_end=True, table=p.table)

    def b1_no_end(p):
        return decode_cuda.decode_images(
            *args(p), num_frames=t, bh=p.bh, bw=p.bw, delta=True,
            table=p.table)

    # the kernel against its plain version at the main path's own shape
    # (1,474,560 blocks, bit offsets near 4.1e8)
    worst = 0
    for v, p in enumerate(preps):
        err = int((b1(p).int() - b1_plain(p).int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"timed input {v}: kernel differs from plain by {err}")
    print(f"full-size check ok: B1 == plain on {VARIANTS} staged "
          f"30x2048x1536 inputs")
    report_shape("B1 30x2048x1536", "decode_images", preps[0])
    ms = timed("B1 kernel (decode_shared_step raw) 30x2048x1536", b1, preps,
               card, base.size)
    plain_ms = timed("B1 plain 30x2048x1536", b1_plain, preps, card, base.size)
    timed("B1 kernel without emit_end 30x2048x1536", b1_no_end, preps, card,
          base.size)
    timed("B1 kernel with emit_end 30x2048x1536", b1_end, preps, card,
          base.size)
    back_to_back("B1 kernel", b1, preps, card, base.size)
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
                                             delta=True, table=p.table)

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
        report_shape(f"B2 {bd}x{bd} 30x2048x1536", "decode_blocks", preps[0],
                     num_steps=bd * bd)
        ms = timed(f"B2 kernel {bd}x{bd} 30x2048x1536", b2, preps, card,
                   base.size)
        back_to_back(f"B2 kernel {bd}x{bd}", b2, preps, card, base.size)
        plain_ms = timed(f"B2 plain {bd}x{bd} 30x2048x1536", b2_plain, preps,
                         card, base.size)
        bms, by = bound(f"B2 {bd}x{bd} 30x2048x1536", preps[0], base.size)
        if bd == 16:  # the kernels line carries the 16x16 batch
            entries["decode_blocks"] = dict(max_abs_err=worst, ms=ms,
                                            plain_ms=plain_ms, bound_ms=bms,
                                            bound_by=by)
        del preps
    return entries


#: the steps of one ``encode_symbols_hybrid`` call, as :func:`hybrid_steps`
#: takes them
HYBRID_STEPS = (
    "symbols host-to-device copy",
    "histogram (torch.bincount) and its counts back",
    "canonical table (host) and the table up",
    "count pass",
    "scan (torch.cumsum int64) and the total back",
    "pack pass (zeroed stream, offsets, launch)",
    "stream device-to-host copy",
    "offsets device-to-host copy",
)


def hybrid_steps(data: np.ndarray, device) -> list:
    """The steps of ``encode_symbols_hybrid(data)``, each ended by a device
    synchronize, on the host's clock -> ms per entry of HYBRID_STEPS."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import encode_cuda

    sync = torch.cuda.synchronize
    marks = [time.perf_counter()]
    sym = torch.from_numpy(data).to(device)
    sync()
    marks.append(time.perf_counter())
    freqs = torch.bincount(sym, minlength=256).cpu().numpy()
    marks.append(time.perf_counter())
    widths = native.code_lengths(freqs)
    tab = torch.from_numpy(encode_cuda.code_table(
        widths, native.canonical_codes(widths))).to(device)
    sync()
    marks.append(time.perf_counter())
    bits = encode_cuda._count_pass(sym, tab)
    sync()
    marks.append(time.perf_counter())
    incl = torch.cumsum(bits, 0, dtype=torch.int64)
    total = int(incl[-1])
    marks.append(time.perf_counter())
    code, offsets = encode_cuda._pack_pass(sym, tab, incl, (total + 7) // 8 + 2)
    sync()
    marks.append(time.perf_counter())
    code.cpu()
    marks.append(time.perf_counter())
    offsets.cpu()
    marks.append(time.perf_counter())
    return [1e3 * (t1 - t0) for t0, t1 in zip(marks, marks[1:])]


def rows_hybrid(data: np.ndarray, device):
    """The device encode as it ran before ``encode_stream`` (the row form),
    for a payload of whole blocks: host table and bit counts, B3's rows on
    the card, the rows back, the host row merge -> (code bytes, offsets)."""
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import encode_cuda

    sym, tab, bits, wmax = stage_encode(data, device)
    rows = encode_cuda.encode_rows(sym, tab, wmax=wmax)
    rows = rows[:, :wmax].contiguous().cpu().numpy().view(np.uint32)
    code, offsets, _ = native.merge_rows(rows, bits)
    return code, offsets


def encode_timings(device, card: str) -> tuple[dict, dict]:
    """On the 30x2048x1536 synthetic payload: ``encode_stream`` (the whole
    wrapper, each pass and the scan) and B3's row form, each against its
    plain version with CUDA events, after holding each equal to its plain
    version on every staged input; on the host's clock the host encoder, the
    whole ``encode_symbols_hybrid`` call and each of its steps, and the
    row-form path it replaced. Returns the two kernels' JSON entries
    (launches left 0)."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.ops import encode_cuda

    payload = delta_payload(synthetic(*FULL))
    n = payload.size
    check(n % 64 == 0, "timed payload: not whole blocks")
    # distinct inputs in distinct buffers: the payload rolled by whole
    # blocks (one table, one wmax, one stream size, the blocks in another
    # order)
    payloads = [np.roll(payload, 64 * 4096 * v) for v in range(VARIANTS)]

    widths, codes = encode_cuda.canonical_table(payload)
    tab = torch.from_numpy(encode_cuda.code_table(widths, codes)).to(device)
    syms = [torch.from_numpy(p).to(device) for p in payloads]
    hosts = [native.encode_symbols(p) for p in payloads]
    nbytes = hosts[0].code_bytes.size
    check(all(h.code_bytes.size == nbytes and np.array_equal(h.widths, widths)
              for h in hosts), "timed encode inputs: the table or size differs")
    worst = 0
    for v, (sym, host) in enumerate(zip(syms, hosts)):
        got = encode_cuda.encode_stream(sym, tab)
        err = stream_error(got, encode_cuda.encode_stream_plain(sym, tab))
        worst = max(worst, err)
        check(err == 0, f"timed encode_stream input {v}: kernel differs from "
              f"plain by {err}")
        check(np.array_equal(got[0].cpu().numpy(), host.code_bytes)
              and np.array_equal(got[1].cpu().numpy().view(np.uint32),
                                 host.block_offsets),
              f"timed encode_stream input {v}: differs from the host encoder")
    print(f"full-size check ok: encode_stream == plain == host encoder on "
          f"{VARIANTS} staged 30x2048x1536 payloads ({n // 64} blocks, "
          f"{nbytes} stream bytes)")
    ms = timed("encode_stream (count pass, scan, total back, pack pass) "
               "30x2048x1536", lambda s: encode_cuda.encode_stream(s, tab),
               syms, card, n, "encoded")
    count_ms = timed("encode_stream count pass 30x2048x1536",
                     lambda s: encode_cuda._count_pass(s, tab), syms, card, n,
                     "encoded")
    bits = [encode_cuda._count_pass(s, tab) for s in syms]
    timed("encode_stream scan (torch.cumsum int64) 30x2048x1536",
          lambda b: torch.cumsum(b, 0, dtype=torch.int64), bits, card, n,
          "encoded")
    incls = [torch.cumsum(b, 0, dtype=torch.int64) for b in bits]
    pack_ms = timed("encode_stream pack pass (zeroed stream and launch) "
                    "30x2048x1536",
                    lambda a: encode_cuda._pack_pass(a[0], tab, a[1], nbytes),
                    list(zip(syms, incls)), card, n, "encoded")
    print(f"encode_stream count + pack passes: {count_ms + pack_ms:.4f} ms")
    plain_ms = timed("encode_stream plain 30x2048x1536",
                     lambda s: encode_cuda.encode_stream_plain(s, tab), syms,
                     card, n, "encoded")
    # symbols in, the stream and the complete blocks' offsets out, the table
    bms, by = roofline("encode_stream 30x2048x1536",
                       n + nbytes + 4 * (n // 64) + 1024,
                       n * ENCODE_OPS_PER_SYMBOL)
    stream_entry = dict(max_abs_err=worst, ms=ms, plain_ms=plain_ms,
                        bound_ms=bms, bound_by=by,
                        passes={"count": count_ms, "pack": pack_ms})
    del syms, bits, incls

    staged = [stage_encode(p, device) for p in payloads]
    wmax = staged[0][3]
    check(all(st[3] == wmax for st in staged), "timed inputs: wmax differs")

    def b3(st):
        return encode_cuda.encode_rows(st[0], st[1], wmax=st[3])

    def b3_plain(st):
        return encode_cuda.encode_rows_plain(st[0], st[1], wmax=st[3])

    worst = 0
    for v, st in enumerate(staged):
        rows = b3(st)
        err = int((rows.long() - b3_plain(st).long()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"timed B3 input {v}: kernel differs from plain by "
              f"{err}")
        check(np.array_equal(rows[:, wmax].cpu().numpy(), st[2]),
              f"timed B3 input {v}: count words differ from the bit counts")
    nb = staged[0][0].shape[0]
    print(f"full-size check ok: B3 == plain on {VARIANTS} staged "
          f"30x2048x1536 payloads ({nb} blocks, wmax {wmax})")
    b3_ms = timed("B3 kernel encode_rows 30x2048x1536", b3, staged, card, n,
                  "encoded")
    b3_plain_ms = timed("B3 plain 30x2048x1536", b3_plain, staged, card, n,
                        "encoded")
    # symbols in, the 1 KB table in, rows out
    b3_bms, b3_by = roofline("B3 30x2048x1536", n + 1024 + 4 * nb * (wmax + 1),
                             n * ENCODE_OPS_PER_SYMBOL)
    del staged

    # the host encoder, the whole call and its steps; the row-form path
    host_ms = host_timed("host MT encode (native.encode_symbols) 30x2048x1536",
                         native.encode_symbols, payloads, card, n)
    whole_ms = host_timed(
        "whole encode_symbols_hybrid (encode_stream) 30x2048x1536",
        lambda p: encode_cuda.encode_symbols_hybrid(p, device=device),
        payloads, card, n)
    hybrid_steps(payloads[0], device)  # warm up
    steps = np.median([hybrid_steps(payloads[i % VARIANTS], device)
                       for i in range(HOST_ITERS)], axis=0)
    for name, step_ms in zip(HYBRID_STEPS, steps):
        print(f"time hybrid step: {name} 30x2048x1536: median {step_ms:.4f} "
              f"ms over {HOST_ITERS} calls, host clock, on {card}")
    print(f"  (the steps sum to {steps.sum():.4f} ms; the stream back moves "
          f"{nbytes} bytes: {nbytes / steps[6] / 1e6:.3f} GB/s)")
    # the two large copies from and into page-locked host buffers, which
    # the path does not use (pageable numpy arrays in, numpy arrays out)
    pinned_in = torch.from_numpy(payload).pin_memory()
    host_timed("symbols host-to-device copy from a page-locked buffer (not "
               "on the path) 30x2048x1536",
               lambda x: x.to(device, non_blocking=True), [pinned_in], card, n)
    code_dev = encode_cuda.encode_stream(pinned_in.to(device), tab)[0]
    pinned_out = torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)
    host_timed("stream device-to-host copy into a page-locked buffer (not on "
               "the path) 30x2048x1536",
               lambda c: pinned_out.copy_(c, non_blocking=True), [code_dev],
               card, nbytes)
    del pinned_in, pinned_out, code_dev
    code, offsets = rows_hybrid(payload, device)
    check(np.array_equal(code, hosts[0].code_bytes)
          and np.array_equal(offsets, hosts[0].block_offsets),
          "the row-form encode differs from the host encoder")
    rows_ms = host_timed(
        "whole row-form encode (host table and bit counts, B3, rows back, "
        "row merge; the path before encode_stream) 30x2048x1536",
        lambda p: rows_hybrid(p, device), payloads, card, n)
    host_timed("row-form step: per-block bit counts (host) 30x2048x1536",
               lambda p: encode_cuda.block_bits(p.reshape(-1, 64), widths),
               payloads, card, n)
    print(f"hybrid encode: {whole_ms / host_ms:.3f}x the host encoder's time, "
          f"{rows_ms / whole_ms:.3f}x faster than the row form, on {card}")
    return stream_entry, dict(max_abs_err=worst, ms=b3_ms,
                              plain_ms=b3_plain_ms, bound_ms=b3_bms,
                              bound_by=b3_by)


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


def probe_batches(frames: np.ndarray, device):
    """VARIANTS staged batches of the 30x2048x1536 ``frames`` in frame-order
    rotations (one table, distinct bitstreams) -> (preps, the table's lut)."""
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.probes import ablate_decode

    preps, widths = [], None
    for v in range(VARIANTS):
        stream = fs.encode_frames_shared(np.roll(frames, v, axis=0))
        if widths is None:
            widths = stream.widths
        check(np.array_equal(stream.widths, widths),
              "timed probe inputs: the table differs between rotations")
        preps.append(fs.prepare_shared(stream, *FULL, device=device))
    return preps, ablate_decode.lut_tables(widths, device)


def probe_timings(device, card: str) -> dict:
    """Times of B1, S1 and every S2 variant in interleaved rounds on 4 staged
    30x2048x1536 photo batches and 4 synthetic ones, after holding each
    equal to the plain version on every input; of every S3 variant and the
    int32 plain chain on 2^22 elements; the S3 kernels' SASS opcodes.
    Returns the probes' JSON entries (launches left 0)."""
    import torch

    from metalhuffman_tpu_torch.ops import decode_cuda
    from metalhuffman_tpu_torch.probes import (ablate_decode, int16_rate,
                                               measure_interleaved, median,
                                               strips)

    entries = {}
    t, h, w = FULL
    for content, frames in (("photo", photo_frames(h, w, t)),
                            ("synthetic", synthetic(t, h, w))):
        preps, lut = probe_batches(frames, device)

        def args(i):
            p = preps[i]
            return ((p.words, p.offsets, p.symbols, p.bounds, p.adj),
                    dict(num_frames=t, bh=p.bh, bw=p.bw))

        def b1_plain(p):
            return decode_cuda.decode_images_plain(
                p.words, p.offsets, p.symbols, p.bounds, p.adj,
                num_frames=t, bh=p.bh, bw=p.bw, delta=True)

        def variant(v):
            def run(i):
                a, g = args(i)
                return ablate_decode.ablate_decode(*a, **g, variant=v, lut=lut)
            return run

        def b1(i):
            a, g = args(i)
            return decode_cuda.decode_images(*a, **g, delta=True,
                                             table=preps[i].table)

        fns = {"B1": b1,
               "S1 strips": lambda i: strips.decode_strips(*args(i)[0],
                                                           **args(i)[1]),
               **{f"S2 {v}": variant(v) for v in ablate_decode.VARIANTS}}
        for i, p in enumerate(preps):
            plain = b1_plain(p)
            for label, fn in fns.items():
                want = (ablate_decode.xor_fold(plain, **args(i)[1])
                        if label == "S2 xorfold" else plain)
                check(torch.equal(fn(i), want), f"timed {content} input {i}: "
                      f"{label} differs from the plain version")
        report_shape(f"B1 {content} 30x2048x1536", "decode_images", preps[0])
        print(f"full-size check ok: B1, S1, S2 {', '.join(ablate_decode.VARIANTS)}"
              f" == plain on {VARIANTS} staged {content} 30x2048x1536 inputs "
              f"({lut.num_t2} T2 tables, "
              f"{len(ablate_decode.pruned_terms(preps[0].bounds, preps[0].adj)[0])}"
              " compare terms)")
        times = measure_interleaved(fns, len(preps))
        bms, by = bound(f"B1 {content} 30x2048x1536", preps[0], frames.size)
        for label, ms in times.items():
            med = median(ms)
            print(f"time {label} {content} 30x2048x1536: median {med:.4f} ms "
                  f"of {len(ms)} interleaved rounds (min {ms[0]:.4f}, max "
                  f"{ms[-1]:.4f}), {frames.size / med / 1e6:.3f} GB/s decoded, "
                  f"{100 * bms / med:.1f} % of the bound, on {card}")
        if content == "photo":
            plain_ms = timed("S1/S2 plain (B1's) photo 30x2048x1536",
                             b1_plain, preps, card, frames.size)
            common = dict(max_abs_err=0, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by)
            entries["decode_strips"] = dict(ms=median(times["S1 strips"]),
                                            **common)
            entries["ablate_decode"] = dict(
                ms=median(times["S2 base"]), **common,
                variants={v: median(times[f"S2 {v}"])
                          for v in ablate_decode.VARIANTS})
        del preps, lut

    n = int16_rate.ELEMENTS
    xs = {v: int16_rate.make_input(n, v, device) for v in int16_rate.VARIANTS}
    for v, x in xs.items():
        check(torch.equal(int16_rate.int16_rate(x, v),
                          int16_rate.int16_rate_plain(x, v)),
              f"timed S3 {v}: kernel differs from plain")
    print(f"full-size check ok: S3 {', '.join(xs)} == plain on {n} elements")
    times = {v: median(ms) for v, ms in measure_interleaved(
        {v: (lambda i, v=v: int16_rate.int16_rate(xs[v], v)) for v in xs},
        1).items()}
    bounds = {}
    for v, ms in times.items():
        nbytes = 2 * n * xs[v].element_size()  # elements in, results out
        bounds[v] = roofline(f"S3 {v} {n} elements", nbytes,
                             int16_rate.ops(n, v))
        print(f"time S3 {v} {n} elements: median {ms:.4f} ms, "
              f"{int16_rate.ops(n, v) / ms / 1e9:.3f} T ops/s, "
              f"{100 * bounds[v][0] / ms:.1f} % of the bound, on {card}")
    print(f"S3 per-element speedup over i32: i16x2 "
          f"{times['i32'] / times['i16x2']:.3f}x, i16 "
          f"{times['i32'] / times['i16']:.3f}x")
    plain_ms = timed(f"S3 plain i32 {n} elements",
                     lambda x: int16_rate.int16_rate_plain(x, "i32"),
                     [xs["i32"]], card, n, "elements")
    for kernel, counts in int16_rate.sass_opcodes().items():
        print(f"SASS {kernel}: " + ", ".join(
            f"{op} {k}" for op, k in counts.most_common()))
    entries["int16_rate"] = dict(max_abs_err=0, ms=times["i32"],
                                 plain_ms=plain_ms, bound_ms=bounds["i32"][0],
                                 bound_by=bounds["i32"][1], variants=times)
    return entries


def ab(baseline: Path, device, card: str) -> None:
    """B1 against ``baseline``, another commit's ``decode_images.cu``, in
    one process: the baseline built under another name, both held
    byte-equal on the staged batches of ``timings``, then timed in
    AB_ROUNDS rounds of baseline, current, current, baseline. A baseline
    whose entry point takes the interval table (bounds, adj, symbols, with
    or without the end pointer) gets its own arguments, one that takes the
    lookup table gets the current ones (and the split, 11, where it takes
    one as ``k1``). Both launch straight through ctypes
    into preallocated outputs, so no host work differs beyond that."""
    import ctypes
    import re

    import torch

    from metalhuffman_tpu_torch import _build
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    nvcc = _build.find_nvcc()
    check(nvcc is not None, "A/B: nvcc not found")
    path = _build.hashed_path("libmht_ab_decode_images", _build.NVCC_FLAGS,
                              (baseline,))
    if not path.exists():
        _build.compile_all([([nvcc, *_build.NVCC_FLAGS, str(baseline)], path)])
    entry = re.search(r"mht_decode_images\(([^)]*)\)", baseline.read_text(),
                      re.S)
    check(entry is not None, f"A/B: {baseline} has no mht_decode_images")
    takes_table = re.search(r"\btable\b", entry.group(1)) is not None
    takes_end = re.search(r"\bend\b", entry.group(1)) is not None
    takes_k1 = re.search(r"\bk1\b", entry.group(1)) is not None
    fns = {"baseline": ctypes.CDLL(str(path)).mht_decode_images,
           "current": _build.lib("decode_images").mht_decode_images}
    p_, i64, int_ = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
    # words, n_words, offsets, n_blocks, bh, bw, bounds, adj, symbols, mode,
    # out, [end,] stream
    interval = [p_, i64, p_, i64, i64, i64, *_build._TABLE, p_, int_, p_,
                *([p_] if takes_end else []), p_]
    lut_args = list(_build._ARGTYPES["decode_images"])
    if takes_k1:  # words .. table, table_entries, k1, t2_smem, ...
        lut_args.insert(8, int_)
    fns["baseline"].argtypes = lut_args if takes_table else interval
    fns["baseline"].restype = ctypes.c_int
    frames, preps = staged_batches(device, CodecConfig())
    outs = {k: torch.empty(FULL, dtype=torch.uint8, device=device)
            for k in fns}
    stream = torch.cuda.current_stream().cuda_stream

    def launcher(which):
        lut = which == "current" or takes_table

        def launch(p):
            geo = (p.words.data_ptr(), p.words.numel(), p.offsets.data_ptr(),
                   p.offsets.numel(), p.bh, p.bw)
            if lut:
                k1 = ((decode_cuda.LUT_K1,)
                      if takes_k1 and which == "baseline" else ())
                tab = (p.table.entries.data_ptr(), p.table.entries.numel(),
                       *k1, int(p.table.t2_in_smem), 1,
                       outs[which].data_ptr(), None)
            else:
                tab = ((ctypes.c_uint32 * 16)(*p.bounds),
                       (ctypes.c_int32 * 16)(*p.adj), p.symbols.data_ptr(), 1,
                       outs[which].data_ptr(), *([None] if takes_end else []))
            err = fns[which](*geo, *tab, stream)
            check(err == 0, f"A/B {which}: CUDA error {err}")
        return launch

    launch = {k: launcher(k) for k in fns}
    for p in preps:
        launch["baseline"](p)
        launch["current"](p)
        check(torch.equal(outs["baseline"], outs["current"]),
              "A/B: the two kernels write different bytes")
    print(f"A/B: baseline == current on {VARIANTS} staged 30x2048x1536 "
          f"batches (baseline on the "
          f"{'lookup' if takes_table else 'interval'} table"
          f"{' with its split' if takes_k1 else ''}, "
          f"{'with' if takes_end else 'without'} the end pointer)")
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
    card = probes.card()
    print(card)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}")
    t_start = time.perf_counter()
    build()

    device = torch.device("cuda", 0)
    if argv:  # the A/B alone: no phases and no result line
        ab(Path(argv[1]), device, card)
        return 0
    from metalhuffman_tpu_torch.ops import decode_cuda

    t, h, w = FULL
    reset_launches()
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
    lut_err = phase_a_tables(device)
    max_err, b2_err = max(max_err, lut_err), max(b2_err, lut_err)
    paths = dict(decode_cuda.path_launches)
    check(all(paths.values()), f"phase A: a path of B1 or B2 was never "
          f"launched: {paths}")
    print(f"phase A launches by path: {paths}")
    stream_err, b3_err = phase_a_encode(device)
    launches = dict.fromkeys(KERNELS, 0)
    for phase in (phase_b, phase_c, phase_d):
        for name, count in phase(device).items():
            launches[name] += count
    counts, errs = phase_e(device)
    for name, count in counts.items():
        launches[name] += count
    counts, f_errs, f_ctx = phase_f(device)
    for name, count in counts.items():
        launches[name] += count
    counts, g_errs, g_blobs = phase_g(device)
    for name, count in counts.items():
        launches[name] += count
    h_counts, h_errs, h_times = phase_h(device, card, f_ctx["f3"],
                                        f_ctx["streams3"])
    for name, count in h_counts.items():
        launches[name] += count
    entries = timings(device, card)
    entries["encode_stream"], entries["encode_rows"] = encode_timings(
        device, card)
    image_timings(device, card)
    entries.update(probe_timings(device, card))
    stream_timings(device, card, f_ctx)
    del f_ctx
    temporal_timings(device, card, g_blobs)
    del g_blobs
    max_err = max(max_err, f_errs["decode_images"], g_errs["decode_images"],
                  h_errs["decode_images"])
    b2_err = max(b2_err, f_errs["decode_blocks"], g_errs["decode_blocks"],
                 h_errs["decode_blocks"])
    errs.update(decode_images=max_err, decode_blocks=b2_err,
                encode_stream=max(stream_err, h_errs["encode_stream"]),
                encode_rows=max(b3_err, h_errs["encode_rows"]))
    for name, err in errs.items():
        entries[name]["max_abs_err"] = max(err, entries[name]["max_abs_err"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print("phase H " + json.dumps({"card": card, "launches": h_counts,
                                   "ms": h_times}))
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
