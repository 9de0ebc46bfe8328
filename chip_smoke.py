#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port once on one GPU and check it end to end.

Run from the root of the checkout on a machine with an NVIDIA Hopper card and
the CUDA toolkit (nvcc) and g++:

    python3 chip_smoke.py

Phases (any failure exits nonzero and prints no result):

1. Build the nine CUDA kernel libraries from ``metalhuffman_tpu_torch/csrc``
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
   against its plain version, tolerance 0: S1 (``decode_strips``) in both
   forms (one-shot and prefetching) and every S2 variant (``ablate_decode``:
   the interval-body family and the b1 family on B1's lookup table) on
   2x2048x1536 and 1x1920x1080 photo and synthetic frames (also against the
   frames), on the 16-bit-code table of the encoder tests as one row of
   262,143 blocks (an odd bw) and on a table of 128 secondary lookup tables
   (the ``lut`` variant's T2 read through L1); every S3 variant
   (``int16_rate``) on 2^16 elements.
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
   G8: 60 panned 2048x1536 photo frames as MC MHVT with a keyframe every 30
   (``mc8.range``'s deployment) through ``frame_stream.decode_range_parsed``
   for [0, 1), [29, 31), [30, 38), [52, 60) and [59, 60), each equal to the
   frames and launching B1, the fold kernel (none for a span of one frame
   from the keyframe) and C1 once each, counted in ``temporal.seek_frames``;
   a byte inverted in lead frame 40's code raises on [52, 60).
   Every fold of a CUDA tensor is one launch of the fold kernel
   (``temporal_fold``), and every temporal range with per-frame CRCs one
   launch of C1. Then G7: the fold kernel against its plain version
   (``temporal.fold_plain``) on every case of the CPU tests (uint8, uint8 x
   3, uint16; keyint 1, 3, 8, fewer frames than keyint, short first and
   last groups; zero, negative and oversized vectors; spans split across
   tables), each call one launch a table; B1 against its plain version on
   G2's 768x1366 residuals and G3's color planes, B2 on G1's region
   selection.
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
10. Phase I, the CLI (``metalhuffman_tpu_torch.cli.main``) in this
   process with ``--device cuda:0``, on files in a temporary directory at
   full size: the bridge photo through ``encode``, ``info``, ``decode`` to
   PNG and ``.gray``, ``roundtrip`` at 8x8 (B1) and 16x16 (B2), ``encode
   --best``, ``--color --subgreen`` on 3 shifted copies, ``--gray16`` on
   the photo x16 plus a gradient, ``inspect --block 0``; the 30x2048x1536
   synthetic frames as ``.npy`` through ``encode-video`` and
   ``decode-video`` (whole, ``--check``, ``--frames 10 20``, ``--frame 29``,
   a 512x512 ``--region`` of frames 5-9 on B2) and ``verify``; an MHTS
   with ``--check``; ``--temporal --motion --best-fast`` of 30 panned photo
   frames, whole and ``--frame 13``; F1's MHV2 through ``decode-video
   --streaming`` and ``verify --streaming``; one flipped bit in its segment
   1 refused by ``--check`` and zeroed by ``--check --salvage`` (the mask
   from B1's plain version); ``bench --precoder delta2d``; then one
   subprocess ``python3 -m metalhuffman_tpu_torch roundtrip`` with no
   ``--device``. Every output equals its source; one ``phase I`` JSON line
   holds each command's host-clock seconds, the bench's GB/s and spread
   and the launches.
11. Phase J, the example and script twins (``examples/*_torch.py``,
   ``scripts/*_torch.py``) with ``--device cuda:0``. In this process, by
   their ``main``: ``quickstart_torch`` (the 512x512 ``image1`` frame,
   MHT1, ``ImageCodec``, an MHTV of two 16x16 frames), ``video_pipeline_torch``
   (6 panned 2048x1536 photo frames: delta2d MHTV, ``StreamingDecoder``,
   ``decode_frame``, the checked decode, ``encode_video_best`` with motion,
   a 256x256 region of frames 2-5 on B2), ``color_pipeline_torch`` (the
   photo as a color image, a 4-frame color video and a frame of it, a
   gray16 depth map), ``streaming_pipeline_torch`` (24 panned 2048x1536
   photo frames through ``StreamingEncoder``, their streamed decode, a
   sub-green color capture, streamed MHVT serving and a resumed MHVT
   capture whose open keyframe group decodes on the card), each decoded
   array held equal to its source again here; ``video_pipeline_torch``
   also extracts frames 1-5 and splices them before the clip;
   ``perf_matrix_torch`` at full geometry with ``--frames 8 --iters
   10 --variants 2`` (B1 at 2048x1536 and 1920x1080, synthetic and photo,
   delta2d, and the MHVT decode with the gray, motion, color, u16 and
   color-with-motion folds), its table printed; ``scaling_report_torch``
   at world 1 (one NCCL rank, started as a subprocess by the report). In
   subprocesses: ``multihost_decode_torch`` as one NCCL rank, and
   ``streaming_gate_torch`` at its defaults (each CLI command a process of
   its own: its eight stages write every container with ``encode-video
   --streaming``, then ``resegment`` and ``--append``). One ``phase J``
   JSON line holds each twin's host-clock seconds, the perf matrix's rows
   and the launches; the subprocesses' launches are not counted.
12. Phase K, the streaming writers, in-place append and container surgery
   (``models.stream_writer``, ``models.surgery``) at 2048x1536. K1: F1's
   150 photo frames pushed 7 at a time into ``StreamingEncoder`` (FCRC,
   segments [136, 14]) equal ``write_segmented(encode_frames_segmented(
   ...))`` byte for byte; ``decode_video`` and the checked segmented
   decode (B1) equal the frames; a capture of frames 0-136 closed and
   appended with 136-150 equals the one-shot file; 30 frames at 16x16
   stream and decode on B2. K2: G2's 30 frames as motion-compensated MHVT
   (keyint 8, FCRC, segments of 15): a capture of 0-15 appended with 15-30
   (its open keyframe group 8-15 decoded by B1 and folded on the card)
   equals the one-shot capture, and ``decode_temporal_video`` equals the
   frames. K3, on K1's and K2's files: ``extract_video`` 40-110 (no
   decode; its combined CRC equals ``zlib.crc32`` of the frames) and
   120-150 (across the segments); the MHVT extract 11-27, whose start re-
   keys frames 11-15 on the card (``info["reencoded_frames"] == 5``);
   ``concat_videos`` of the MHV2 extract and a 20-frame MHTV equal to
   ``concat_videos_streamed``; ``resegment_video_streamed`` of K1 at 16
   frames a segment through the checked decode. K4: G3's sub-green
   30x1080x1920x3 into ``ColorStreamingEncoder`` and F3's 30-table clip into
   ``MHTSStreamingEncoder``, 4 frames a push. Every output decodes on the
   card to its source. Then B1 against its plain version on K2's segment 0
   and B2 on the 16x16 stream (not counted). Its times, on the host's
   clock, median of 3: each streamed encode against the batch writer of
   the same frames, each append (the MHVT append's open-group decode and
   fold apart, with CUDA events), each surgery call; one ``phase K`` JSON
   line holds them with the launches.
   Every kernel's launch count is set to 0 just before phases B, C, D, E,
   F, G, H, I, J, K, M and N and must match the decodes, encodes and probes
   each made.
13. Phase L, the benchmark's entry: ``bench_torch.py -v --device cuda:0``
   as a process of its own at its defaults (30x2048x1536, 25 calls a
   repetition, 4 rotations) in nine runs: ``--mode video`` synthetic,
   ``--content photo`` and ``--precoder delta2d``; ``--mode single``;
   ``--mode encode``; ``--mode temporal`` plain, and at 8 frames
   ``--motion``, ``--inner color`` and ``--inner u16``. Each must exit 0 with exactly one stdout
   line, a JSON object of ``bench.py``'s six keys naming the mode's metric,
   a value above 0 and 3 or more repetitions, and its launch line (each
   process counts from 0) must show the kernels of its path launched and
   no other: B1 for video, single and temporal, ``encode_rows`` and
   ``encode_stream`` for encode. Then ``--mode video --frames 8 --trace
   DIR`` must write ``DIR/trace.json`` with host events; its CUDA kernel events and
   B1's among them are counted (none when CUPTI cannot trace the card).
   One ``phase L`` JSON line holds each run's line, seconds and launches;
   the processes' launches add to the kernels line's.
14. Phase M, the host C++ decoder (``device="native"``, the JAX package's
   ``backend="native"``) on the card's machine, after phase L: the
   30x2048x1536 synthetic and photo MHTV batches of phases A and B, the
   photo as MHT1 at 8x8 and 16x16, phase F's F1 (150 frames of MHV2)
   through ``decode_range`` 130-140 and a checked 512x512 region of frames
   134-138, G1's and G2's MHVT (8 frames, the MC one with motion), and the
   136 frames of phase F's F2 segment 0, with blocks past 2^31 bits; each
   decoded on ``native`` and on the card (B1, or B2 at 16x16 and for the
   region), each equal to its source and the two to each other. A checked
   decode on ``native`` must be refused by the library and by
   ``decode-video --check [--streaming] --device native``. Then the native
   decode of the synthetic batch (``decode_frames_shared``, and
   ``native.decode_blocks`` alone) on the host's clock, median of 5, beside
   B1's queued calls with CUDA events, as GB/s and the factor between them,
   with the CPU model, ``os.cpu_count()``, the decode's thread count and the
   card. One ``phase M`` JSON line holds them with the launches.
15. Phase N, the block sizes the containers record beyond 2, 4, 8 and 16
   (1x1 to 255x255; B2 decodes a block's last 1-3 symbols as a short
   group). B2 against its plain version, bytes and end bits (tolerance 0),
   and the blocks against the source: one synthetic 2048x1536 frame at
   block sizes 1, 3, 5, 6, 12 and 32 with 1-D delta and none, at 12 and 32
   with delta2d through the torch post-pass, and a 510x255 frame of two
   255x255 blocks (the plain version loops once per 4 symbols). Then the
   user path at full size: the 30x2048x1536 synthetic and panned photo
   frames through ``encode_video`` at 3x3, 12x12 (with per-frame CRCs) and
   32x32, each decoded by ``decode_video`` on the card and on ``native``,
   both equal to the frames; ``decode_range`` 5-13 of the 12x12 photo
   video, checked against its per-frame CRCs; ``decode_image`` of the photo
   at 3x3 and 32x32 and a checked 512x512 ``decode_region`` at each. Then
   B2 alone on the synthetic batch at 3x3, 12x12 and 32x32, held to its
   plain version there first: its grid, the median of 12 single calls and
   the mean of 12 queued calls with CUDA events, its plain version's
   median of 3, and the byte bound. One ``phase N`` JSON line holds them
   with the card, the launches and the host-clock decode times.
16. Phase O, C1 (``csrc/frame_crc.cu``), the per-frame CRC-32 a range
   request computes on the card before its fetch: ``crc_cuda.frame_crcs``
   against ``zlib.crc32`` of every frame, on the first 1 to 8 of 8 panned
   2048x1536 photo frames, on stacks of 1, 3 and 8 frames of 1, 15, 16,
   17, 4095, 2880 and 3072 bytes, and on stacks starting 1, 2, 4 and 8
   bytes past an aligned address (loads of 1, 2, 4 and 8 bytes). Then its
   time on the 8 bridge frames: one call between CUDA events and the card's
   time queued behind a spin (median of 3 rounds), beside its byte bound,
   and zlib's on the host. One ``phase O`` JSON line holds them. (Phases
   F, G, K, M and N launch C1 too: each ``decode_range`` on the card of a
   container with per-frame CRCs, once a request, once a frame of MHTS,
   and each temporal range of an MHVT with them.)
17. Times, with CUDA events over distinct staged inputs: B1 with and without
   end bits, B2 at 16x16 and 4x4, each against its plain version on the
   30x2048x1536 batch, each with its grid (resident CUDA blocks per SM,
   shared memory per CUDA block) and its registers and spills, and B1 and
   B2 queued back to back; on that batch's payload ``encode_stream`` (each
   pass alone, the scan, the whole wrapper) and B3's row form, each against
   its plain version, and on the host's clock each step of the hybrid
   encode, the whole call, the host encoder and the row-form path it
   replaced (host bit counts, B3, rows back, row merge); one ``decode_image`` of
   the photo at 8x8 and 16x16; B1, both forms of S1 and every S2 variant
   in interleaved rounds on 4 staged 30x2048x1536 photo batches and 4
   synthetic ones (one table each), each held equal to its plain version
   there first, each with its CUDA blocks per SM and registers (S2 ``base``
   is B1's interval body before its redesign, ``b1`` its body now, the
   yardstick of the b1 family, its median printed against B1's min-max);
   B1's host time per enqueued call through its wrapper and through its C
   entry alone; every S3 variant and its plain version on 2^22 elements, and the
   SASS opcodes of the S3 kernels and of S2's b1 family; phase F's: the MHV2 decode of F1 whole and each segment
   alone (host clock; staging, B1 and fetch apart), the host build of each
   of F3's lookup tables, and F3's MHTS decode (a launch per frame) against
   one MHTV launch of the same 30 frames; phase G's, for G1-G4: staging,
   B1, the plane fold, the fold kernel and its plain version (beside the
   fold's byte bound), the fetch, the CRC and the whole ``decode_video``
   call, the MHTV decode of the same residuals as the yardstick; then the
   fold kernel at 30x2048x1536 with keyint 8 and an 8 px pan (queued back
   to back, queued behind a spin of the card for its own time, and as the
   group fold), its bound, the plain fold and the host time of a call.

The last two lines are a JSON object describing the kernels and the result
line ``{"ok": true, "device": {...}}``; the ``phase H``, ``phase I``,
``phase J``, ``phase K``, ``phase L``, ``phase M``, ``phase N`` and
``phase O`` lines come before them.

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
from metalhuffman_tpu_torch.bench import encode_payload
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
G8_FRAMES = 60  # phase G8: a seek's clip, two keyframe groups of a second
G8_KEYINT = 30
#: G8's requests [a, b): one frame at a keyframe, across the boundary, a
#: group's head, its tail, its last frame
G8_RANGES = ((0, 1), (29, 31), (30, 38), (52, 60), (59, 60))
G8_LEAD = 40  # G8: the lead frame whose code byte is inverted
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
    # no Pallas kernel: the JAX package folds with lax.scan
    "temporal_fold": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/temporal_fold.cu",
        "replaces": "metalhuffman_tpu/models/temporal.py:472",
    },
    # no Pallas kernel: the JAX package checks a range's frames with zlib
    "frame_crc": {
        "route": "cuda",
        "source": "metalhuffman_tpu_torch/csrc/frame_crc.cu",
        "replaces": "metalhuffman_tpu/models/frame_stream.py:229",
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
    from metalhuffman_tpu_torch.ops import (crc_cuda, decode_cuda, encode_cuda,
                                            fold_cuda)
    from metalhuffman_tpu_torch.probes import ablate_decode, int16_rate, strips

    return (decode_cuda.launches, encode_cuda.launches, strips.launches,
            ablate_decode.launches, int16_rate.launches, fold_cuda.launches,
            crc_cuda.launches)


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
        args = (prep.words, prep.offsets, prep.code)
        geo = dict(num_frames=t, bh=prep.bh, bw=prep.bw,
                   delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d)
        plain = decode_cuda.decode_images_plain(*args, **geo)
        kern = decode_cuda.decode_images(*args, **geo)
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
    payload = encode_payload(frames)
    total_bits = int(stream.widths.astype(np.int64)[payload].sum())
    prep = fs.prepare_shared(stream, t, h, w, device=device)
    args = (prep.words, prep.offsets, prep.code)
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


def b2_case(device, phase: str, frame: np.ndarray, bd: int, kw: dict) -> int:
    """B2 against its plain version on one frame at block size ``bd`` under
    config ``kw``, bytes and end bits (tolerance 0), the end bits on their
    targets and the blocks equal to the frame (delta2d off 8x8 through the
    torch post-pass); returns the max absolute difference."""
    import torch

    from metalhuffman_tpu_torch.core import blocks, delta as delta_mod
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda

    h, w = frame.shape
    cfg = CodecConfig(block_dim=bd, **kw)
    name = f"B2 {bd}x{bd} " + ("delta2d" if cfg.delta2d else
                               "delta" if cfg.delta else "none")
    stream = fs.encode_frames_shared(frame[None], cfg)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words).to(device),
            torch.from_numpy(offsets).to(device),
            decode_cuda.stage_code(stream.widths, device))
    in_kernel_d2 = cfg.delta2d and bd == 8
    geo = dict(num_steps=bd * bd, delta=cfg.delta and not cfg.delta2d,
               delta2d=in_kernel_d2, emit_end=True)
    out, end = decode_cuda.decode_blocks(*args, **geo)
    pout, pend = decode_cuda.decode_blocks_plain(*args, **geo)
    err = max(int((out.int() - pout.int()).abs().max()),
              int((end - pend).abs().max()))
    check(err == 0, f"{phase} {name}: kernel differs from plain by {err}")
    targets = torch.from_numpy(
        decode_cuda.block_end_targets(stream.block_offsets, None))
    check(not decode_cuda.check_block_ends(end.cpu(), targets).any(),
          f"{phase} {name}: end bits miss their targets")
    if cfg.delta2d and not in_kernel_d2:
        out = delta_mod.delta2d_decode_blocks(out, bd)
    got = blocks.blocks_to_image_torch(out, h, w, bd)
    check(np.array_equal(got.cpu().numpy(), frame),
          f"{phase} {name}: the blocks differ from the source frame")
    err = max(err, b2_feed_edges(phase, name, *args, geo))
    print(f"{phase} ok: {name} {w}x{h}: kernel == plain == source, "
          f"{end.numel()} end bits on target")
    return err


def shifted(words, lead: int):
    """``words`` ``lead`` u32 words into a buffer of their own, so 4*lead
    bytes past a 16-byte boundary (the CUDA allocator's blocks start on
    one), as an MHTS batch's later frames are."""
    import torch

    buf = torch.zeros(words.numel() + lead, dtype=torch.int32,
                      device=words.device)
    buf[lead:] = words
    return buf[lead:]


def b2_feed_edges(phase: str, name: str, words, offsets, code, geo) -> int:
    """B2 against its plain version, bytes and end bits, where its read-ahead
    feed hands lanes to the L1 refill: the words 0-3 u32 past a 16-byte
    boundary (the first unit starts before word 0; the stream's last block
    ends inside the buffer's last 16 bytes, its units passing the pad words
    at some of the four), the offsets reversed and repeated (a region
    selection's) and 5 offsets past the end (malformed: the refill clamps
    them); returns the max absolute difference."""
    import torch

    from metalhuffman_tpu_torch.ops import decode_cuda

    bits = 32 * words.numel()
    past = np.array([bits - 40, bits - 1, bits, bits + 12345, (1 << 32) - 1],
                    np.int64).astype(np.uint32).view(np.int32)
    sets = {"as staged": offsets,
            "reversed and repeated": torch.cat(
                [offsets.flip(0), offsets[::7], offsets[:33]]),
            "past the end": torch.cat(
                [offsets[-40:], torch.from_numpy(past).to(offsets.device)])}
    err = 0
    for label, offs in sets.items():
        pout, pend = decode_cuda.decode_blocks_plain(words, offs, code, **geo)
        for lead in range(4):
            out, end = decode_cuda.decode_blocks(shifted(words, lead), offs,
                                                 code, **geo)
            e = max(int((out.int() - pout.int()).abs().max()),
                    int((end - pend).abs().max()))
            check(e == 0, f"{phase} {name}, offsets {label}, words {lead} "
                  f"u32 past 16 bytes: kernel differs from plain by {e}")
            err = max(err, e)
    return err


#: phase A's streams of 16-bit codes: (symbols a block, blocks), the first
#: the 30x2048x1536 batch at 16x16
A_WIDEST = ((256, 368_640), (9, 1 << 20), (1024, 1 << 16))


def phase_a_widest(device) -> int:
    """B2 on a stream of 16-bit codes alone, the widest a group can take (64
    bits): random symbols under the all-16-bit table (256 codes of 16 bits,
    each symbol its own canonical code), 30x1536x2048 at 16x16 and a 3x3 and
    a 32x32 block size, against its plain version (bytes and end bits) and
    the symbols, and through :func:`b2_feed_edges`; returns the max absolute
    difference."""
    import torch

    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.core import bitstream
    from metalhuffman_tpu_torch.ops import decode_cuda

    rng = np.random.default_rng(24)
    widths = np.full(256, 16, np.uint8)
    codes = native.canonical_codes(widths)
    code = decode_cuda.stage_code(widths, device)
    worst = 0
    for steps, n_blocks in A_WIDEST:
        syms = rng.integers(0, 256, (n_blocks, steps), dtype=np.uint8)
        data = codes[syms].astype(">u2").view(np.uint8).ravel()
        words = torch.from_numpy(bitstream.bytes_to_be_words(
            data, pad_words=decode_cuda.PAD_WORDS).view(np.int32)).to(device)
        offsets = torch.from_numpy(
            (np.arange(n_blocks, dtype=np.uint32) * np.uint32(16 * steps))
            .view(np.int32)).to(device)
        geo = dict(num_steps=steps, delta=False, emit_end=True)
        out, end = decode_cuda.decode_blocks(words, offsets, code, **geo)
        pout, pend = decode_cuda.decode_blocks_plain(words, offsets, code,
                                                     **geo)
        err = max(int((out.int() - pout.int()).abs().max()),
                  int((end - pend).abs().max()))
        check(err == 0, f"phase A all-16-bit stream, {steps} symbols a "
              f"block: kernel differs from plain by {err}")
        check(np.array_equal(out.cpu().numpy(), syms),
              f"phase A all-16-bit stream, {steps} symbols a block: the "
              "blocks differ from the symbols")
        err = max(err, b2_feed_edges("phase A", f"all-16-bit stream {steps}",
                                     words, offsets, code, geo))
        worst = max(worst, err)
        print(f"phase A ok: a stream of {n_blocks} blocks of {steps} 16-bit "
              f"codes: B2 == plain == the symbols, and with its words 0-3 "
              f"u32 off 16 bytes, offsets reversed and repeated and past the "
              f"end")
    return worst


def phase_a_blocks(device) -> int:
    """B2 against its plain version on one synthetic 2048x1536 frame at the
    block sizes 2, 4, 8 and 16; returns the max absolute byte or end-bit
    difference."""
    frame = synthetic_frame(FULL[1], FULL[2])
    cases = [(bd, {"delta": d}) for bd in (2, 4, 8, 16) for d in (True, False)]
    cases += [(8, {"delta2d": True}), (16, {"delta2d": True})]
    return max(b2_case(device, "phase A", frame, bd, kw) for bd, kw in cases)


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
        nb = offsets.size
        args = (torch.from_numpy(words).to(device),
                torch.from_numpy(offsets).to(device),
                decode_cuda.stage_code(widths, device))
        b1_geo = dict(num_frames=1, bh=1, bw=nb, delta=True, emit_end=True)
        b2_geos = [dict(num_steps=64, delta=False, delta2d=True),
                   dict(num_steps=256, delta=True),
                   dict(num_steps=4, delta=False)]
        runs = [(decode_cuda.decode_images(*args, **b1_geo),
                 decode_cuda.decode_images_plain(*args, **b1_geo))]
        for geo in b2_geos:
            runs.append((
                decode_cuda.decode_blocks(*args, **geo, emit_end=True),
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
              f"{args[2].nbytes} B, T2 "
              f"{'smem' if args[2].t2_in_smem else 'L1'}")
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

    cases = [("delta 2048x1536", encode_payload(synthetic(1, *FULL[1:]))),
             ("delta 1920x1080", encode_payload(synthetic(1, *HD[1:]))),
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

    args = (prep.words, prep.offsets, prep.code)
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
        payload = encode_payload(frames)
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


def probe_tables(widths, device) -> dict:
    """The tables the S2 variants take beyond the staged stream's code (B1's
    11/5 table): the ``lut`` variant's 8/8 table and ``b1_esc32``'s u32
    one."""
    from metalhuffman_tpu_torch.probes import ablate_decode

    return dict(lut=ablate_decode.lut_tables(widths, device),
                table32=ablate_decode.esc32_table(widths, device))


def probe_cases(device) -> list:
    """Phase E's decode inputs -> [(name, prep, S2's tables, frames or
    None)]."""
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
    out = []
    for name, frames, stream, geo in cases:
        prep = fs.prepare_shared(stream, *geo, device=device)
        out.append((name, prep, probe_tables(stream.widths, device),
                    frames))
    return out


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
    for name, p, tabs, frames in cases:
        args = (p.words, p.offsets, p.code)
        geo = dict(num_frames=p.num_frames, bh=p.bh, bw=p.bw)
        plain = decode_cuda.decode_images_plain(*args, **geo, delta=True)
        outs = {f"S1 {form}": strips.decode_strips(
            *args, **geo, prefetch=prefetch)
            for form, prefetch in strips.FORMS.items()}
        for v in ablate_decode.VARIANTS:
            outs[f"S2 {v}"] = ablate_decode.ablate_decode(
                *args, **geo, variant=v, **tabs)
        for label, out in outs.items():
            want = (ablate_decode.xor_fold(plain, **geo)
                    if label == "S2 xorfold" else plain)
            # bytes: the xorfold words compared byte by byte
            err = int((out.view(torch.uint8).int()
                       - want.view(torch.uint8).int()).abs().max())
            kernel = ("decode_strips" if label.startswith("S1")
                      else "ablate_decode")
            worst[kernel] = max(worst[kernel], err)
            check(err == 0, f"phase E {name} {label}: kernel differs from "
                  f"plain by {err}")
            if frames is not None and label != "S2 xorfold":
                got = out[:, :p.height, :p.width].cpu().numpy()
                check(np.array_equal(got, frames),
                      f"phase E {name} {label}: differs from the frames")
        print(f"phase E ok: {name}: S1 {', '.join(strips.FORMS)} and S2 "
              f"{', '.join(ablate_decode.VARIANTS)}"
              f" == plain{' == frames' if frames is not None else ''} "
              f"({p.offsets.numel()} blocks, bw {p.bw}, T2 tables "
              f"{tabs['lut'].num_t2} at 8/8, {p.code.num_t2} at 11/5, "
              f"{len(ablate_decode.pruned_terms(p.code.bounds,
                                                p.code.adj)[0])} "
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
    expected = expect(decode_strips=len(cases) * len(strips.FORMS),
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

    args = (prep.words, prep.offsets, prep.code)
    geo = dict(num_frames=prep.num_frames, bh=prep.bh, bw=prep.bw,
               delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d,
               emit_end=emit_end)
    got = decode_cuda.decode_images(*args, **geo)
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
    expected["frame_crc"] += 1  # the CRC-32s of the ten frames, on the card
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
    expected["frame_crc"] += 5  # each record's CRC-32, a frame at a time
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
        staged = stage_selection(stream, sel, device=device)
        got = decode_cuda.decode_blocks(*staged, num_steps=64, delta=True,
                                        emit_end=True)
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
                       f.words, f.offsets, f.code,
                       num_frames=1, bh=f.bh, bw=f.bw, delta=True).int()
                   ).abs().max())
        worst["decode_images"] = max(worst["decode_images"], err)
        check(err == 0, f"F3 frame {i}: B1 differs from plain by {err}")
    print("phase F ok: B2 == plain on F1's region selections (bytes and end "
          f"bits); B1 == plain on each of F3's {F3_FRAMES} tables")
    torch.cuda.synchronize()
    return counts, worst, {"blob1": blob1, "f2 segment 0": s20, "f2": f2,
                           "f3": f3, "streams3": streams3}


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


def flip_in_blob(blob: bytes, bit: int, n: int = 1) -> bytes:
    """An MHVT blob whose MHTV inner has code bits [bit, bit + n) flipped;
    the wrapper and both CRCs as they were."""
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig

    inner, keyint, crc, mvs, fcrcs, fl = temporal.unwrap(blob)
    stream, t, h, w, bd, delta = fs.read_shared(inner)
    for b in range(bit, bit + n):
        stream = flip_bit(stream, b)
    inner = fs.write_shared(stream, t, h, w,
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
    g8 = photo_frames(h, w, G8_FRAMES)
    blob8 = encoded(f"G8 MC MHVT {G8_FRAMES}x{h}x{w} keyint {G8_KEYINT}",
                    mt.encode_video, g8,
                    CodecConfig(temporal=True, motion=True, keyint=G8_KEYINT,
                                frame_crcs=True))
    check(temporal.unwrap(blob8)[0][:4] == b"MHTV",
          "G8: the inner is not one MHTV")
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
    expected["temporal_fold"] += 1
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
        expected["temporal_fold"] += 1
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
    expected["temporal_fold"] += 2  # the video and frame 13; the region
    # of a container without motion folds on the host
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
    expected["temporal_fold"] += 1
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
        # the range, the frame, the chunks; an MC region is a range; each
        # checks its frames with C1 on the card
        expected["decode_images"] += 2 + iter_chunks(t, k, 10) + int(mc)
        expected["decode_blocks"] += 0 if mc else 1
        expected["temporal_fold"] += 2 + iter_chunks(t, k, 10) + int(mc)
        expected["frame_crc"] += 2 + iter_chunks(t, k, 10) + int(mc)
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
    expected["temporal_fold"] += 1  # the fold before the CRC fails
    print("phase G5 ok: G1 and G2 decode_temporal_range 5-13, "
          f"decode_temporal_frame {t - 1}, iter_temporal_video(chunk_frames="
          f"10) with its CRC chain, a checked {rh}x{rw} region over frames "
          "9-11:"
          " all equal to the frames; a flip outside the region passes")

    got = mt.decode_video(blob6, device)
    equal(got, f6, "G6 MHVT over MHV2")
    expected["decode_images"] += len(segs6)
    expected["temporal_fold"] += 1
    del got
    print(f"phase G6 ok: decode_video of the MHVT over an MHV2 of segments "
          f"{segs6} == the {F1_FRAMES} frames")
    for name, n in seek_requests(device, blob8, g8).items():
        expected[name] += n
    del g8, blob8
    counts = read_launches()
    check(counts == expected,
          f"phase G: kernel launches {counts}, expected {expected}")
    print(f"phase G launches: {counts}")

    # the kernels against their plain versions on G's inputs (not counted)
    worst = {"decode_images": 0, "decode_blocks": 0,
             "temporal_fold": fold_cases(device)}
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
    staged = stage_selection(s1, sel, device=device)
    got = decode_cuda.decode_blocks(*staged, num_steps=64, delta=True,
                                    emit_end=True)
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


def seek_requests(device, blob: bytes, frames: np.ndarray) -> dict:
    """Phase G8: G8's requests through the port's one random access
    (``frame_stream.parse_range_container``, ``decode_range_parsed``) on an
    MC MHVT with a keyframe every G8_KEYINT frames, the ``mc8.range``
    deployment: each equal to the source frames, each launching B1 once,
    the fold kernel once (not at all for a span of one frame from the
    keyframe) and C1 once, the frames of the seek counted in
    ``temporal.seek_frames``, the handle's code and offsets and the fetched
    frames in page-locked memory; then a byte inverted in the code of lead
    frame G8_LEAD must raise. Returns the launches it made."""
    import torch

    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal

    k = G8_KEYINT
    parsed = fs.parse_range_container(blob)
    seek0 = dict(temporal.seek_frames)
    made = dict.fromkeys(KERNELS, 0)

    def request(p, a, b):
        before = read_launches()
        t0 = time.perf_counter()
        try:
            return fs.decode_range_parsed(p, a, b, device=device)[0]
        finally:
            dt = time.perf_counter() - t0
            grew = {n: c - before[n] for n, c in read_launches().items()
                    if c != before[n]}
            want = {"decode_images": 1, "frame_crc": 1}
            if b - k * (a // k) > 1:
                want["temporal_fold"] = 1
            check(grew == want, f"phase G8 [{a}, {b}): launches {grew}, "
                  f"expected {want}")
            for n, c in grew.items():
                made[n] += c
            print(f"phase G8 [{a}, {b}): {b - k * (a // k)} frames decoded "
                  f"and folded from keyframe {k * (a // k)}, {dt * 1e3:.3f} "
                  f"ms host clock, launches {grew}")

    lead = 0
    for a, b in G8_RANGES:
        got = request(parsed, a, b)
        check(got.dtype == frames.dtype and np.array_equal(got, frames[a:b]),
              f"phase G8 [{a}, {b}): differs from the source")
        lead += a - k * (a // k)
    # the handle's code and offsets went to page-locked memory at its first
    # card decode, and the frames come back in it
    segs = parsed[1][5][1][0]
    check(all(torch.from_numpy(s.code_bytes).is_pinned()
              and torch.from_numpy(s.block_offsets.view(np.uint8)).is_pinned()
              for s, _ in segs) and torch.from_numpy(got).is_pinned(),
          "phase G8: the handle's code and offsets or the fetched frames "
          "are not in page-locked memory")
    asked = sum(b - a for a, b in G8_RANGES)
    check(temporal.seek_frames == {"asked": seek0["asked"] + asked,
                                   "lead": seek0["lead"] + lead},
          f"phase G8: seek_frames {temporal.seek_frames}, from {seek0}")
    inner = temporal.unwrap(blob)[0]
    stream, _t, h, w, _bd, _d = fs.read_shared(inner)
    per = (h // 8) * (w // 8)
    bit = int(stream.block_offsets[G8_LEAD * per + per // 2]) // 8 * 8
    bad = fs.parse_range_container(flip_in_blob(blob, bit, 8))
    a, b = G8_RANGES[3]
    try:
        request(bad, a, b)
    except ValueError as e:
        check("CRC-32" in str(e), f"phase G8 inverted byte: {e}")
        print(f"phase G8 ok: a byte inverted in lead frame {G8_LEAD}'s code "
              f"(byte {bit // 8}) raises on [{a}, {b}): {e}")
    else:
        raise PhaseError("G8: a seek through a corrupt lead frame passed")
    print(f"phase G8 ok: {G8_FRAMES}x{h}x{w} MC MHVT, keyint {k}: "
          f"decode_range_parsed {list(G8_RANGES)} == the frames, B1, the "
          f"fold kernel and C1 once each a request (no fold for a span of "
          f"one frame), the handle's code and the frames page-locked; "
          f"seek_frames asked {asked}, lead {lead}")
    return made


#: phase G7: the fold kernel's cases, those the CPU tests hold its host
#: side to (``tests/test_torch_fold_cuda.py``): (keyint, first_len, frames)
#: with keyint 1, a short last group, fewer frames than keyint, a short
#: first and last group, a first group of one frame
G7_GROUPINGS = ((1, None, 6), (3, None, 10), (8, None, 5), (8, 3, 20),
                (3, 1, 8))
#: (H, W) whose uint8, uint8 x 3 and uint16 rows select every instance of
#: the kernel: rows of 130/390/260 bytes take 2/2/4-byte accesses, 128/384/
#: 256 16, 131/393/262 1/1/2, 132/396/264 4/4/8, 136/408/272 8/8/16, each
#: with the previous frame in shared memory; rows past two buffers of it
#: (over 116,224 bytes) read it from device memory: 116,240/348,720/232,480
#: bytes with 16-byte accesses, 58,113 (shared) and 174,339/116,226 with 1
#: and 2
G7_SIZES = ((67, 130), (64, 128), (67, 131), (64, 132), (64, 136),
            (3, 116240), (2, 58113))
#: (keyint, first_len, frames) that split across tables (256 frames and 128
#: groups a table): a group past 256 frames, 130 groups, both with a group
#: after, whole groups past 256 frames
G7_SPLITS = ((300, None, 300), (2, None, 260), (300, 5, 320), (8, 3, 300))


def fold_vectors(kind: str, t: int, h: int, w: int, rng) -> np.ndarray:
    """Phase G7's (T, 2) vectors: zero, negative, or past the frame's size
    of both signs."""
    if kind == "zero":
        return np.zeros((t, 2), np.int16)
    if kind == "negative":
        return -rng.integers(1, 6, (t, 2)).astype(np.int16)
    mvs = np.stack([rng.integers(-5 * h, 5 * h, t),
                    rng.integers(-5 * w, 5 * w, t)], 1)
    mvs[1] = (h + 2, -w - 3)
    return mvs.astype(np.int16)


def fold_err(a, b) -> int:
    """Largest absolute difference of two folded stacks (uint16 ones read
    through an int16 view, as torch has no uint16 arithmetic)."""
    import torch

    if a.dtype == torch.uint16:
        a, b = (v.view(torch.int16).int() & 0xFFFF for v in (a, b))
    return max_err(a, b)


def fold_cases(device) -> int:
    """Phase G7: the fold kernel against its plain version
    (``temporal.fold_plain``, on the card) on every case of G7_GROUPINGS
    and G7_SIZES, for uint8, uint8 x 3 and uint16 frames under zero,
    negative and oversized vectors (the group fold for the zero ones), and
    the frames of G7_SPLITS, which split across tables; each call must
    launch the kernel once (no time where no group has two frames; once a
    table when split). Returns the largest difference, 0."""
    import torch

    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.ops import fold_cuda

    rng = np.random.default_rng(20)
    worst, n = 0, 0

    def run(label, fold, x, want_launches):
        nonlocal worst, n
        y = x.clone()
        before = fold_cuda.launches["temporal_fold"]
        fold(x, True)
        grew = fold_cuda.launches["temporal_fold"] - before
        fold(y, False)
        err = fold_err(x, y)
        worst, n = max(worst, err), n + 1
        check(err == 0 and grew == want_launches,
              f"phase G7 {label}: the kernel differs from plain by {err}, "
              f"{grew} launches for {want_launches}")

    for h, w in G7_SIZES:
        for kind in ("u8", "color", "u16"):
            dtype = np.uint16 if kind == "u16" else np.uint8
            pixel = (3,) if kind == "color" else ()
            for keyint, fl, t in G7_GROUPINGS:
                res = rng.integers(0, np.iinfo(dtype).max + 1,
                                   (t, h, w, *pixel)).astype(dtype)
                want = int(any(g >= 2 for _, _, g in
                               temporal._groups(t, keyint, fl)))
                for vec in ("zero", "negative", "oversized"):
                    mvs = fold_vectors(vec, t, h, w, rng)
                    label = (f"{kind} {t}x{h}x{w} keyint {keyint} first_len "
                             f"{fl} {vec}")

                    def mc(x, kernel, mvs=mvs, keyint=keyint, fl=fl):
                        if kernel:
                            temporal.temporal_fold_mc(x, keyint, mvs, fl)
                        else:
                            temporal.fold_plain(x, keyint, mvs, fl)

                    run(label, mc, torch.from_numpy(res).to(device), want)
                    if vec == "zero":
                        def group(x, kernel, keyint=keyint, fl=fl):
                            if kernel:
                                temporal.temporal_fold(x, keyint, fl)
                            else:
                                temporal.fold_plain(x, keyint, None, fl)

                        run(label + " group fold", group,
                            torch.from_numpy(res).to(device), want)
    h, w = G7_SIZES[0]
    for kind in ("u8", "u16"):
        dtype = np.uint16 if kind == "u16" else np.uint8
        for keyint, fl, t in G7_SPLITS:
            res = rng.integers(0, np.iinfo(dtype).max + 1, (t, h, w)).astype(
                dtype)
            mvs = fold_vectors("oversized", t, h, w, rng)
            tables = len(fold_cuda.fold_tables(
                temporal._groups(t, keyint, fl),
                mvs.astype(np.int64) % np.array([h, w]), h, 1))

            def split(x, kernel, mvs=mvs, keyint=keyint, fl=fl):
                if kernel:
                    temporal.temporal_fold_mc(x, keyint, mvs, fl)
                else:
                    temporal.fold_plain(x, keyint, mvs, fl)

            run(f"{kind} {t}x{h}x{w} keyint {keyint} first_len {fl}, "
                f"{tables} tables", split, torch.from_numpy(res).to(device),
                tables)
    torch.cuda.synchronize()
    print(f"phase G7 ok: the fold kernel == fold_plain on the card in {n} "
          "cases (uint8, uint8 x 3, uint16; keyint 1, 3, 8, fewer frames "
          "than keyint, short first and last groups; zero, negative and "
          "oversized vectors; every access width, rows in shared and in "
          "device memory; spans split across tables), each call one launch "
          "a table")
    return worst


def temporal_timings(device, card: str, blobs: dict) -> dict:
    """Phase G's times, for G1-G4: staging, B1, the plane fold, the
    temporal fold (the kernel and its plain version, CUDA events, in place
    on the decoded residuals; beside the fold's byte bound, the stack read
    once and written once), the fetch, the CRC and the whole
    ``decode_video`` call (host clock); the MHTV decode of the same
    residuals (``decode_video`` of the inner, with its fetch and CRC) as
    the yardstick. Then :func:`fold_timings`; returns its entry of the
    kernels line."""
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
            fold_ms = timed(f"{label} group fold kernel (temporal_fold, "
                            f"keyint {k})",
                            lambda x: temporal.temporal_fold(x, k, fl), [res],
                            card, nb, "folded")
        else:
            fold_ms = timed(f"{label} MC fold kernel (temporal_fold_mc, "
                            f"keyint {k})",
                            lambda x: temporal.temporal_fold_mc(
                                x, k, mvs, fl), [res], card, nb, "folded")
        plain_ms = timed(f"{label} plain fold (fold_plain, keyint {k})",
                         lambda x: temporal.fold_plain(x, k, mvs, fl), [res],
                         card, nb, "folded", iters=HOST_ITERS)
        bms, _by = roofline(f"{label} temporal fold",
                            fold_bytes(res, k, fl), 0)
        print(f"{label} temporal fold: kernel {100 * bms / fold_ms:.1f} % of "
              f"its byte bound, {fold_ms / b1_ms:.3f}x B1 on the same "
              f"frames; plain {plain_ms / fold_ms:.1f}x the kernel")
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
    return fold_timings(device, card)


def fold_bytes(res, keyint: int, first_len) -> int:
    """The bytes the fold kernel moves on the stack ``res``: every frame of
    a group of two or more read, each but the group's keyframe written (a
    group of one frame is left alone)."""
    from metalhuffman_tpu_torch.models import temporal

    frames = sum(g * (2 * n - 1) for _, g, n in
                 temporal._groups(res.shape[0], keyint, first_len) if n >= 2)
    return frames * res[0].numel() * res.element_size()


FOLD_PAN = (8, 8)  #: the 8 px pan of :func:`fold_timings`, (dy, dx) a frame
SPIN_CYCLES = 200_000_000  #: ~0.1 s of the card's clock, for behind_spin
SPIN_CALLS = 50


def behind_spin(label: str, fn, x, card: str, nbytes: int) -> float:
    """Mean ms of SPIN_CALLS calls of ``fn(x)`` queued behind a spin of the
    card (``torch.cuda._sleep``), between two CUDA events: the host
    enqueues every call while the card spins, so no call waits for the
    host and the mean is the card's time of one call."""
    import torch

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(SPIN_CALLS):
        fn(x)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    end.synchronize()
    mean = start.elapsed_time(end) / SPIN_CALLS
    print(f"time {label} queued behind a spin: mean {mean:.4f} ms over "
          f"{SPIN_CALLS} calls, {nbytes / mean / 1e6:.3f} GB/s, on {card} "
          f"(the host enqueued them in {host_ms:.2f} ms)")
    return mean


def fold_timings(device, card: str) -> dict:
    """The fold kernel at the benchmark's shape: 30x2048x1536 uint8
    residuals, keyint 8, an 8 px pan a frame. Held byte-equal to the plain
    fold, then the kernel (CUDA events: queued back to back, and queued
    behind a spin of the card, so the host has enqueued every call before
    the first starts and the mean is the card's time), its byte bound (the
    bytes it moves: every frame read, each non-key frame written; beside
    it the stack read and written whole, as the benchmark's
    ``fold_least_s`` counts), the plain fold (``fold_plain``: per slot a gather and an add,
    ATen) and the host time of one ``temporal_fold_mc`` call (checks,
    tables, the launch) -> the kernels line's entry, with the card's
    time."""
    import torch

    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.ops import fold_cuda

    t, h, w = FULL
    rng = np.random.default_rng(21)
    res = torch.from_numpy(rng.integers(0, 256, (t, h, w)).astype(
        np.uint8)).to(device)
    mvs = np.zeros((t, 2), np.int16)
    mvs[1:] = FOLD_PAN
    nb = res.numel()
    x, y = res.clone(), res.clone()
    temporal.temporal_fold_mc(x, G_KEYINT, mvs)
    temporal.fold_plain(y, G_KEYINT, mvs)
    err = fold_err(x, y)
    check(err == 0, f"fold timings: the kernel differs from plain by {err}")
    label = f"fold {t}x{w}x{h} keyint {G_KEYINT} pan {FOLD_PAN}"

    def kernel(z):
        return temporal.temporal_fold_mc(z, G_KEYINT, mvs)

    back_to_back(f"{label} kernel", kernel, [x], card, nb)
    ms = behind_spin(f"{label} kernel", kernel, x, card, nb)
    group_ms = behind_spin(f"{label} kernel, zero vectors (the group fold)",
                           lambda z: temporal.temporal_fold(z, G_KEYINT), x,
                           card, nb)
    plain_ms = timed(f"{label} plain", lambda z: temporal.fold_plain(
        z, G_KEYINT, mvs), [y], card, nb, "folded", iters=HOST_ITERS)
    bms, by = roofline(label, fold_bytes(x, G_KEYINT, None), 0)
    whole_ms, _ = roofline(f"{label}, the stack read and written whole",
                           2 * nb, 0)
    torch.cuda.synchronize()
    before = fold_cuda.launches["temporal_fold"]
    t0 = time.perf_counter()
    for _ in range(TIMED_ITERS):
        kernel(x)
    host_us = (time.perf_counter() - t0) / TIMED_ITERS * 1e6
    torch.cuda.synchronize()
    check(fold_cuda.launches["temporal_fold"] - before == TIMED_ITERS,
          "fold timings: a call made other than one launch")
    print(f"{label}: kernel {ms:.4f} ms on the card ({100 * bms / ms:.1f} % "
          f"of the {bms:.4f} ms bound, {100 * whole_ms / ms:.1f} % of "
          f"{whole_ms:.4f} ms), group fold {group_ms:.4f} ms, plain "
          f"{plain_ms:.4f} ms ({plain_ms / ms:.1f}x), host {host_us:.1f} us "
          f"a call enqueued, on {card}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=bms,
                bound_by=by)


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
        [encode_payload(frames), encode_payload(frames[:1])[:37]]))] + [
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
                    device=device)
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
                    f.words, f.offsets[lo:hi], f.code,
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
        payload = encode_payload(synth)
        tailed = np.concatenate([payload, payload[:17]])
        hosts = {n: native.encode_symbols(p)
                 for n, p in (("payload", payload), ("tailed", tailed))}
        prep16 = fs.prepare_shared(stream16, t, h, w, cfg16, device=device)
        args16 = (prep16.words, prep16.offsets, prep16.code)
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
            *args16, mesh=m, num_steps=256)
        single = decode_cuda.decode_blocks(*args16, num_steps=256, delta=True)
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
        times = h_timings(device, card, m, m2, stream8, args16, prep3,
                          payload)
    finally:
        dist.destroy_process_group()
    return counts, errs, times


def h_timings(device, card: str, m, m2, stream8, args16, prep3,
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
                    *args16, mesh=m, num_steps=256)),
            [0], card, size),
        "decode_blocks 16x16": timed(
            "H decode_blocks 16x16 (B2)", lambda _: decode_cuda.decode_blocks(
                *args16, num_steps=256, delta=True),
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


I_REGION = (512, 512, 512, 512)  # (y0, x0, rh, rw) of phase I's region
I_FRAME = 13  # the temporal --frame of phase I
I_ITERS = 10  # the bench's calls per repetition (its CLI default)


def run_cli(label: str, argv: list, times: dict) -> str:
    """``cli.main(argv)`` in this process, its stdout captured -> the
    stdout; the host-clock seconds go to ``times[label]``. A SystemExit or a
    nonzero return is a phase failure."""
    import contextlib
    import io

    from metalhuffman_tpu_torch import cli

    buf = io.StringIO()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf):
            rc = cli.main([str(a) for a in argv])
    except SystemExit as e:
        raise PhaseError(f"phase I {label}: exited with {e.code!r}") from None
    times[label] = time.perf_counter() - t0
    check(rc == 0, f"phase I {label}: returned {rc}")
    out = buf.getvalue().strip()
    print(f"phase I {label}: {times[label]:.3f} s; "
          f"{out.splitlines()[-1] if out else ''}")
    return out


def cli_refuses(label: str, argv: list, times: dict) -> str:
    """``cli.main(argv)`` must exit nonzero -> its message."""
    from metalhuffman_tpu_torch import cli

    t0 = time.perf_counter()
    try:
        cli.main([str(a) for a in argv])
    except SystemExit as e:
        times[label] = time.perf_counter() - t0
        check(e.code not in (0, None), f"phase I {label}: exit {e.code!r}")
        print(f"phase I {label}: {times[label]:.3f} s; refused: {e.code}")
        return str(e.code)
    raise PhaseError(f"phase I {label}: the corrupt stream decoded")


def phase_i(device, blob1: bytes) -> tuple[dict, dict, dict]:
    """The CLI (``metalhuffman_tpu_torch.cli.main``) on files in a temporary
    directory, ``--device`` ``device``, at full size: the photo (encode,
    info, decode to PNG and .gray, roundtrip at 8 and 16, --best, color
    sub-green, gray16, inspect), a 30x2048x1536 synthetic video (MHTV: whole,
    --check, --frames, --frame, --region, verify; MHTS --check; MHVT
    --temporal --motion --best-fast of panned photo frames, whole,
    --frame, --check and verify), F1's 150-frame MHV2 (``blob1``; --streaming, verify
    --streaming, a flipped bit in segment 1 refused by --check and zeroed
    by --check --salvage), ``bench`` and one subprocess with no --device.
    Returns (the launches each kernel made, after checking them; each
    command's host-clock seconds; the bench's numbers)."""
    import contextlib
    import io
    import subprocess
    import tempfile

    import torch

    from metalhuffman_tpu_torch import bench
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.ops import decode_cuda
    from metalhuffman_tpu_torch.utils import fixtures, imageio

    t, h, w = FULL
    dev = ["--device", str(device)]
    times: dict = {}
    img = photo()[:h, :w]
    rgb = np.stack([img, np.roll(img, 7, axis=1), np.roll(img, 13, axis=0)],
                   axis=-1)
    g16 = (img.astype(np.uint16) * 16
           + (np.arange(w, dtype=np.uint16) % 16)[None, :])
    video = synthetic(t, h, w)
    pan = photo_frames(h, w, t)
    f1 = photo_frames(h, w, F1_FRAMES)
    segs1, *_ = fs.read_segmented(blob1)
    cfg8 = CodecConfig()
    # the flipped bit: inside segment 1, one the end-bit check flags
    s1, ft1 = segs1[1]
    per = (h // 8) * (w // 8)
    fbit, fblock = seek_flip(s1, 0, ft1 * per, 1, cfg8)
    bad_segs = [segs1[0], (flip_bit(s1, fbit), ft1), *segs1[2:]]
    bad_blob = fs.write_segmented(bad_segs, h, w, cfg8,
                                  source_crc32=fs.source_crc32(blob1),
                                  frame_crcs=fs.read_frame_crcs(blob1))
    with tempfile.TemporaryDirectory(prefix="mht_phase_i_") as tmp:
        d = Path(tmp)
        src = fixtures.PHOTO
        if (h, w) != (1536, 2048):  # a shrunken rehearsal: the crop
            src = d / "photo.png"
            imageio.save_grayscale(img, src)
        imageio.save_color(rgb, d / "rgb.png")
        np.save(d / "g16.npy", g16)
        np.save(d / "video.npy", video)
        np.save(d / "pan.npy", pan)
        (d / "f1.mhv2").write_bytes(blob1)
        (d / "bad.mhv2").write_bytes(bad_blob)
        del bad_blob

        def same(label, got, want):
            check(got.shape == want.shape and np.array_equal(got, want),
                  f"phase I {label}: the output differs from its source")

        reset_launches()
        # the photo
        run_cli("encode", ["encode", src, d / "p.mht"], times)
        run_cli("info", ["info", d / "p.mht"], times)
        run_cli("decode png", ["decode", d / "p.mht", d / "p.png", *dev],
                times)
        same("decode png", imageio.load_grayscale(d / "p.png"), img)
        run_cli("decode gray", ["decode", d / "p.mht", d / "p.gray", *dev],
                times)
        same("decode gray", imageio.load_raw_gray(d / "p.gray"), img)
        for bd in (8, 16):
            run_cli(f"roundtrip {bd}x{bd}", ["roundtrip", src, "--block-dim",
                                             bd, *dev], times)
        run_cli("encode --best", ["encode", src, d / "b.mht", "--best"],
                times)
        run_cli("decode --best", ["decode", d / "b.mht", d / "b.png", *dev],
                times)
        same("decode --best", imageio.load_grayscale(d / "b.png"), img)
        run_cli("encode --color --subgreen",
                ["encode", d / "rgb.png", d / "c.mhtc", "--color",
                 "--subgreen"], times)
        run_cli("decode color", ["decode", d / "c.mhtc", d / "c.png", *dev],
                times)
        same("decode color", imageio.load_color(d / "c.png"), rgb)
        run_cli("encode --gray16", ["encode", d / "g16.npy", d / "g.mhtc",
                                    "--gray16"], times)
        run_cli("decode gray16", ["decode", d / "g.mhtc", d / "g.npy", *dev],
                times)
        same("decode gray16", np.load(d / "g.npy"), g16)
        out = run_cli("inspect", ["inspect", d / "p.mht", "--block", "0"],
                      times)
        check(out.count("\n  [") == 64, "phase I inspect: not 64 symbols")
        # the video
        run_cli("encode-video", ["encode-video", d / "video.npy",
                                 d / "v.mhtv"], times)
        run_cli("decode-video", ["decode-video", d / "v.mhtv", d / "v.npy",
                                 *dev], times)
        same("decode-video", np.load(d / "v.npy"), video)
        run_cli("decode-video --check", ["decode-video", d / "v.mhtv",
                                         d / "vc.npy", "--check", *dev],
                times)
        same("decode-video --check", np.load(d / "vc.npy"), video)
        run_cli("decode-video --frames 10 20",
                ["decode-video", d / "v.mhtv", d / "vr.npy", "--frames", 10,
                 20, *dev], times)
        same("decode-video --frames", np.load(d / "vr.npy"), video[10:20])
        run_cli("decode-video --frame 29",
                ["decode-video", d / "v.mhtv", d / "v29.npy", "--frame", 29,
                 *dev], times)
        same("decode-video --frame", np.load(d / "v29.npy"), video[29])
        y0, x0, rh, rw = I_REGION
        run_cli("decode-video --region",
                ["decode-video", d / "v.mhtv", d / "reg.npy", "--region", y0,
                 x0, rh, rw, "--frames", 5, 9, *dev], times)
        same("decode-video --region", np.load(d / "reg.npy"),
             video[5:9, y0 : y0 + rh, x0 : x0 + rw])
        run_cli("verify", ["verify", d / "v.mhtv", *dev], times)
        # per-frame tables and temporal video
        run_cli("encode-video --per-frame-tables",
                ["encode-video", d / "video.npy", d / "s.mhts",
                 "--per-frame-tables"], times)
        run_cli("decode-video MHTS --check",
                ["decode-video", d / "s.mhts", d / "s.npy", "--check", *dev],
                times)
        same("decode-video MHTS", np.load(d / "s.npy"), video)
        run_cli("encode-video --temporal --motion --best-fast",
                ["encode-video", d / "pan.npy", d / "t.mhvt", "--temporal",
                 "--motion", "--best-fast"], times)
        run_cli("decode-video MHVT", ["decode-video", d / "t.mhvt",
                                      d / "t.npy", *dev], times)
        same("decode-video MHVT", np.load(d / "t.npy"), pan)
        run_cli(f"decode-video MHVT --frame {I_FRAME}",
                ["decode-video", d / "t.mhvt", d / "t13.npy", "--frame",
                 I_FRAME, *dev], times)
        same("decode-video MHVT --frame", np.load(d / "t13.npy"),
             pan[I_FRAME])
        run_cli("decode-video MHVT --check",
                ["decode-video", d / "t.mhvt", d / "tc.npy", "--check",
                 *dev], times)
        same("decode-video MHVT --check", np.load(d / "tc.npy"), pan)
        out = run_cli("verify MHVT", ["verify", d / "t.mhvt", *dev], times)
        check(any(ln.split()[:3] == ["temporal", "CRC-32", "ok"]
                  for ln in out.splitlines()),
              "phase I verify MHVT: the temporal CRC-32 was not checked")
        # streaming decode of F1's MHV2
        run_cli("decode-video --streaming",
                ["decode-video", d / "f1.mhv2", d / "f1.npy", "--streaming",
                 *dev], times)
        same("decode-video --streaming", np.load(d / "f1.npy",
                                                 mmap_mode="r"), f1)
        (d / "f1.npy").unlink()
        run_cli("verify --streaming", ["verify", d / "f1.mhv2",
                                       "--streaming", *dev], times)
        # salvage
        msg = cli_refuses("decode-video --check (flipped bit)",
                          ["decode-video", d / "bad.mhv2", d / "x.npy",
                           "--check", *dev], times)
        check(msg.startswith("stream integrity check failed in segment 1"),
              f"phase I --check: {msg}")
        run_cli("decode-video --check --salvage",
                ["decode-video", d / "bad.mhv2", d / "sv.npy", "--check",
                 "--salvage", *dev], times)
        salvaged = np.load(d / "sv.npy", mmap_mode="r")
        # bench
        buf = io.StringIO()
        with contextlib.redirect_stderr(buf):
            out = run_cli("bench", ["bench", "--frames", t, "--height", h,
                                    "--width", w, "--precoder", "delta2d",
                                    "--iters", I_ITERS, *dev], times)
        print("\n".join(f"phase I bench: {ln}"
                        for ln in buf.getvalue().splitlines()))
        gbps, _unit, rest = out.splitlines()[-1].split(" ", 2)
        spread = float(rest.split("spread ")[1].split("%")[0])
        counts = read_launches()
        # the mask the salvage must zero, from B1's plain version (no launch)
        prep = fs.prepare_shared(bad_segs[1][0], ft1, h, w, cfg8,
                                 device=device, check=True)
        _, end = decode_cuda.decode_images_plain(
            prep.words, prep.offsets, prep.code,
            num_frames=ft1, bh=prep.bh, bw=prep.bw, delta=True,
            emit_end=True)
        err = decode_cuda.check_block_ends(end, prep.end_targets).cpu().numpy()
        del prep, end
        check(bool(err[fblock]), "phase I: the plain version does not flag "
              "the flipped block")
        want = f1.copy()
        base = segs1[0][1]
        want[base : base + ft1] = fs.salvage_blocks(
            want[base : base + ft1], err, 8)[0]
        same("decode-video --check --salvage", salvaged, want)
        print(f"phase I salvage: {int(err.sum())} block(s) flagged in "
              f"segment 1 (flipped bit {fbit} in block {fblock}), zeroed; "
              f"the rest == the frames")
        del salvaged, want
        # one subprocess, no --device: the default must reach the card
        argv = [sys.executable, "-m", "metalhuffman_tpu_torch", "roundtrip",
                str(src)]
        if torch.device(device).type == "cpu":
            argv += ["--device", "cpu"]  # the CPU rehearsal
        t0 = time.perf_counter()
        proc = subprocess.run(argv, cwd=Path(__file__).resolve().parent,
                              capture_output=True, text=True, timeout=300)
        times["subprocess roundtrip"] = time.perf_counter() - t0
        check(proc.returncode == 0,
              f"phase I subprocess: exit {proc.returncode}: {proc.stderr}")
        print(f"phase I subprocess roundtrip (no --device): "
              f"{times['subprocess roundtrip']:.3f} s; "
              f"{proc.stdout.strip()}")
    # bench: each rotation checked, a warm-up round, the timed reps, the
    # same-input reps and the per-call latencies
    v = min(bench.VARIANTS, t)
    n_bench = v + v + bench.REPS * I_ITERS + 3 * I_ITERS + 3 * v
    expected = expect(
        decode_images=(2 + 1 + 1 + 1)  # decodes: png, gray, best, color, u16
        + 1  # roundtrip 8x8
        + 5  # video: whole, --check, --frames, --frame, verify
        + t  # MHTS --check: a launch per frame
        + 4  # MHVT: whole, --frame, --check, verify
        + 2 * len(segs1)  # --streaming, verify --streaming
        + 2 + len(segs1)  # --check (refused in segment 1), --salvage
        + n_bench,
        decode_blocks=1 + 1,  # roundtrip 16x16, --region
        temporal_fold=4)  # MHVT: whole, --frame, --check, verify
    check(counts == expected,
          f"phase I: kernel launches {counts}, expected {expected}")
    print(f"phase I launches: {counts}")
    return counts, times, {"gbps": float(gbps), "spread_pct": spread,
                           "precoder": "delta2d", "frames": t}


ROOT = Path(__file__).resolve().parent
#: phase J's twins, by label: the script and its arguments after --device
J_TWINS = {
    "quickstart": ("examples/quickstart_torch.py", []),
    "video_pipeline": ("examples/video_pipeline_torch.py", []),
    "color_pipeline": ("examples/color_pipeline_torch.py", []),
    "streaming_pipeline": ("examples/streaming_pipeline_torch.py", []),
    "perf_matrix": ("scripts/perf_matrix_torch.py",
                    ["--frames", 8, "--iters", 10, "--variants", 2]),
    "scaling_report": ("examples/scaling_report_torch.py", ["--world", 1]),
    "multihost_decode": ("examples/multihost_decode_torch.py",
                         ["--world-size", 1, "--rank", 0]),
    "streaming_gate": ("scripts/streaming_gate_torch.py", []),
}
J_TIMEOUT = 900  # seconds for one twin's subprocess


def run_twin(label: str, device, times: dict, extra=()):
    """Phase J: twin ``label``'s ``main`` in this process (``runpy``), with
    ``--device device`` -> what it returns; the host-clock seconds go to
    ``times[label]``. A SystemExit is a phase failure."""
    import runpy

    path, args = J_TWINS[label]
    argv = ["--device", str(device), *map(str, args), *extra]
    t0 = time.perf_counter()
    try:
        out = runpy.run_path(str(ROOT / path))["main"](argv)
    except SystemExit as e:
        raise PhaseError(f"phase J {label}: exited with {e.code!r}") from None
    times[label] = time.perf_counter() - t0
    print(f"phase J {label}: {times[label]:.3f} s")
    return out


def run_twin_process(label: str, device, times: dict, extra=()) -> str:
    """Phase J: twin ``label`` as a subprocess with ``--device device`` ->
    its stdout; a nonzero exit or ``J_TIMEOUT`` is a phase failure."""
    import subprocess

    path, args = J_TWINS[label]
    argv = [sys.executable, str(ROOT / path), "--device", str(device),
            *map(str, args), *extra]
    t0 = time.perf_counter()
    proc = subprocess.run(argv, cwd=ROOT, capture_output=True, text=True,
                          timeout=J_TIMEOUT)
    times[label] = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase J {label}: exit {proc.returncode}:\n"
          f"{proc.stdout[-4000:]}\n{proc.stderr[-4000:]}")
    print(f"phase J {label} (subprocess): {times[label]:.3f} s")
    print("\n".join(f"  {ln}" for ln in proc.stdout.strip().splitlines()))
    return proc.stdout


def j_expected(perf_args: dict) -> dict:
    """Phase J's launches in this process. The examples: quickstart B1 3
    (decode_image, decode_step, decode_video); video_pipeline B1 9
    (decode_video, the streaming decoder, decode_frame, the checked decode,
    the temporal decode_video and frame, the extract's MHTV and the
    concat's two segments) and B2 1 (the region); color_pipeline B1 4
    (image, video, frame, gray16); streaming_pipeline B1 14 (4 MHV2
    segments, the color video's 2, 3 temporal chunks, the append's open
    keyframe group, the resumed capture's 4 segments). The perf matrix: 5
    ``run_video`` rows, each its rotations checked, a warm-up round,
    ``bench.REPS`` timed and 3 same-input repetitions of ``iters`` calls
    and 3 latencies per rotation; 5 MHVT rows, each its rotations checked,
    a warm-up round of the fold-less and the folded call per rotation,
    ``bench.REPS`` timed and 3 fold-less repetitions of ``iters`` calls.
    The fold kernel: video_pipeline 2 (the temporal decode_video and
    frame), streaming_pipeline 5 (3 temporal chunks, the append's open
    group, the resumed capture's decode), each MHVT row's checked and
    folded warm-up calls and its timed ones (none at one frame)."""
    from metalhuffman_tpu_torch import bench

    v = max(1, min(perf_args["variants"], perf_args["frames"]))
    iters = perf_args["iters"]
    video = v + v + bench.REPS * iters + 3 * iters + 3 * v
    mhvt = v + 2 * v + bench.REPS * iters + 3 * iters
    # one frame is a group of one: its fold has nothing to launch
    folds = (v + v + bench.REPS * iters) * (perf_args["frames"] > 1)
    return expect(decode_images=3 + 9 + 4 + 14 + 5 * video + 5 * mhvt,
                  decode_blocks=1, temporal_fold=2 + 5 + 5 * folds)


def phase_j(device) -> tuple[dict, dict, list, dict]:
    """The example and script twins on ``device`` (see the module
    docstring). Returns (the launches each kernel made in this process,
    after checking them; each twin's host-clock seconds; the perf matrix's
    rows; the scaling report's numbers at world 1)."""
    times: dict = {}
    reset_launches()
    for label in ("quickstart", "video_pipeline", "color_pipeline",
                  "streaming_pipeline"):
        out = run_twin(label, device, times)
        for name, (got, want) in out["decoded"].items():
            check(got.shape == want.shape and got.dtype == want.dtype
                  and np.array_equal(got, want),
                  f"phase J {label} {name}: the output differs from its "
                  f"source")
        print(f"phase J {label} ok: {len(out['decoded'])} decoded arrays == "
              f"their sources ({', '.join(out['decoded'])}); blobs "
              + ", ".join(f"{k} {len(b)} B" for k, b in out["blobs"].items()))
    rows = run_twin("perf_matrix", device, times)
    check(len(rows) == 11 and all(r[3] > 0 for r in rows),
          f"phase J perf_matrix: rows {rows}")
    counts = read_launches()
    perf = J_TWINS["perf_matrix"][1]
    expected = j_expected({k.strip("-"): v for k, v in zip(perf[::2],
                                                           perf[1::2])})
    check(counts == expected,
          f"phase J: kernel launches {counts}, expected {expected}")
    print(f"phase J launches: {counts}")
    report = run_twin("scaling_report", device, times)
    check([r["world"] for r in report] == [1] and report[0]["bit_exact"]
          and report[0]["byte_identical"],
          f"phase J scaling_report: {report}")
    port = free_port()
    out = run_twin_process("multihost_decode", device, times,
                           ["--init-method", f"tcp://127.0.0.1:{port}"])
    check("[p0] encode byte-identical across 1 processes" in out,
          "phase J multihost_decode: no encode line")
    out = run_twin_process("streaming_gate", device, times)
    check(out.strip().splitlines()[-1].startswith(
        "STREAMING GATE: ALL PASS"), "phase J streaming_gate: no ALL PASS")
    return counts, times, [list(r) for r in rows], report[0]


K_CHUNK = 7  # phase K: frames per push of the 2048x1536 captures
K_SPLIT = 136  # K1: frames captured before the append (segment 0 whole)
K_SEGMENT = 15  # K2: frames per MHV2 segment of the MHVT capture
K_RESEGMENT = 16  # K3: frames per segment of the resegmented K1 file
K_EXTRACT = (40, 110)  # K3: the MHV2 extract, no decode
K_EXTRACT_ACROSS = (120, 150)  # K3: an MHV2 extract across K1's segments
K_MHVT_EXTRACT = (11, 27)  # K3: a mid-group start (its group is 8-15)
K_CONCAT_TAIL = 20  # K3: frames of the MHTV spliced after the extract
K_COLOR_CHUNK = 4  # K4: frames per push of the color and MHTS captures
K_REPS = 3  # host-clock repetitions of each encode, append and surgery call


def push_all(writer, frames, chunk: int):
    """Push ``frames`` into the streaming ``writer`` ``chunk`` at a time and
    close it -> its stats."""
    with writer as enc:
        for a in range(0, len(frames), chunk):
            enc.push(frames[a : a + chunk])
    return enc.stats


def host_reps(label: str, fn, times: dict):
    """``fn()`` K_REPS times on the host's clock, each ended by a device
    synchronize; the median seconds go to ``times[label]`` -> the last
    call's result."""
    import torch

    secs = []
    for _ in range(K_REPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        secs.append(time.perf_counter() - t0)
    secs.sort()
    times[label] = secs[len(secs) // 2]
    print(f"time phase K {label}: median {times[label]:.4f} s of {K_REPS} "
          f"(min {secs[0]:.4f}, max {secs[-1]:.4f}), host clock")
    return out


class DecodeSpans:
    """Times every call of the named module functions while active: CUDA
    events on the current stream around each call (the device time of the
    work it queued) and the host clock. Phase K wraps the temporal append's
    ``frame_stream.decode_range`` and ``temporal.fold_planes`` with it to
    split the append into the open group's decode and the encode."""

    def __init__(self, targets):
        self.targets = targets
        self.events: list = []
        self.host_s = 0.0
        self.saved: list = []

    def __enter__(self):
        import torch

        self.events, self.host_s = [], 0.0

        def timed_call(real):
            def call(*a, **k):
                start = torch.cuda.Event(enable_timing=True)
                end = torch.cuda.Event(enable_timing=True)
                t0 = time.perf_counter()
                start.record()
                out = real(*a, **k)
                end.record()
                self.host_s += time.perf_counter() - t0
                self.events.append((start, end))
                return out
            return call

        for module, name in self.targets:
            real = getattr(module, name)
            self.saved.append((module, name, real))
            setattr(module, name, timed_call(real))
        return self

    def __exit__(self, *exc):
        while self.saved:
            module, name, real = self.saved.pop()
            setattr(module, name, real)

    def device_ms(self) -> float:
        import torch

        torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phase_k(device) -> tuple[dict, dict, dict]:
    """The streaming writers, in-place append and container surgery at
    2048x1536 (K1-K4, see the module docstring); returns (the launches
    each kernel made, after checking them; the max absolute difference of
    B1 and B2 from their plain versions on K's inputs, all 0; the
    host-clock seconds of each encode, append and surgery call, the
    appends' decode apart, and of the whole phase)."""
    import tempfile

    import torch

    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch.models import color, surgery, temporal
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.stream_writer import (
        ColorStreamingEncoder, MHTSStreamingEncoder, StreamingEncoder,
        TemporalStreamingEncoder)
    from metalhuffman_tpu_torch.ops import decode_cuda

    _t, h, w = FULL
    times: dict = {}
    expected = expect()
    t_phase = time.perf_counter()
    f1 = photo_frames(h, w, F1_FRAMES)
    g2 = photo_frames(h, w, G_FRAMES)
    f3 = contrast_frames(h, w, F3_FRAMES)
    g3 = color_frames(*G_COLOR, G_FRAMES)
    reset_launches()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_k_") as tmp:
        tmp = Path(tmp)
        # K1: the long gray capture, its batch twin, the append, 16x16
        cfg1 = CodecConfig(frame_crcs=True)
        k1 = tmp / "k1.mhv2"
        stats = host_reps("K1 streamed encode", lambda: push_all(
            StreamingEncoder(k1, h, w, cfg1, frame_crcs=True), f1, K_CHUNK),
            times)
        blob1 = k1.read_bytes()
        batch = host_reps("K1 batch writer", lambda: fs.write_segmented(
            fs.encode_frames_segmented(f1, cfg1), h, w, cfg1,
            source_crc32=zlib.crc32(f1), frame_crcs=fs.compute_frame_crcs(
                f1)), times)
        check(blob1 == batch, "K1: the streamed file differs from "
              "write_segmented(encode_frames_segmented(...))")
        del batch
        segs1, *_ = fs.read_segmented(blob1)
        check([ft for _, ft in segs1] == [136, 14]
              and (stats.total_frames, stats.num_segments) == (F1_FRAMES, 2),
              f"K1: segments {[ft for _, ft in segs1]}, stats {stats}")
        got = mt.decode_video(blob1, device)  # CRC-checked
        expected["decode_images"] += 2
        check(np.array_equal(got, f1), "K1 decode_video: frames differ")
        del got
        base = 0
        for si, frames, err in fs.iter_frames_segmented_checked(
                segs1, h, w, device=device):
            check(not err.any() and np.array_equal(
                frames, f1[base : base + len(frames)]),
                f"K1 checked segment {si}: flagged or differs")
            base += len(frames)
        expected["decode_images"] += 2
        cap = tmp / "k1_cap.mhv2"
        push_all(StreamingEncoder(cap, h, w, cfg1, frame_crcs=True),
                 f1[:K_SPLIT], K_CHUNK)
        first = cap.read_bytes()

        def append_k1():
            cap.write_bytes(first)
            return push_all(StreamingEncoder(cap, h, w, cfg1, append=True),
                            f1[K_SPLIT:], K_CHUNK)

        stats = host_reps("K1 append", append_k1, times)
        check(cap.read_bytes() == blob1 and stats.total_frames == F1_FRAMES,
              "K1: the append of frames 136-150 differs from the one-shot "
              "capture")
        print(f"phase K1 ok: {F1_FRAMES}x{h}x{w} pushed {K_CHUNK} at a time "
              f"-> MHV2 [136, 14] ({len(blob1)} B) == write_segmented("
              "encode_frames_segmented(...)); decode_video and the checked "
              "segmented decode == the frames; capture 0-136 + append "
              "136-150 == the one-shot file")
        cfg16 = CodecConfig(block_dim=16)
        k16 = tmp / "k16.mhv2"
        f16 = f1[:G_FRAMES]
        host_reps("K1 16x16 streamed encode", lambda: push_all(
            StreamingEncoder(k16, h, w, cfg16), f16, K_CHUNK), times)
        blob16 = k16.read_bytes()
        batch = host_reps("K1 16x16 batch writer", lambda: fs.write_segmented(
            fs.encode_frames_segmented(f16, cfg16), h, w, cfg16,
            source_crc32=zlib.crc32(f16)), times)
        check(blob16 == batch, "K1 16x16: the streamed file differs from "
              "the batch writer's")
        got = mt.decode_video(blob16, device)
        expected["decode_blocks"] += 1
        check(np.array_equal(got, f16), "K1 16x16 decode_video (B2)")
        print(f"phase K1 ok: {G_FRAMES}x{h}x{w} 16x16 streamed MHV2 "
              f"({len(blob16)} B) == the batch writer's, decoded on B2")

        # K2: the resumed MHVT capture, its open group decoded on the card
        cfg2 = CodecConfig(temporal=True, motion=True, keyint=G_KEYINT,
                           frame_crcs=True)
        k2 = tmp / "k2.mhvt"

        def temporal_writer(path, append=False):
            return TemporalStreamingEncoder(
                path, h, w, cfg2, max_segment_frames=K_SEGMENT,
                frame_crcs=not append, append=append, device=device)

        host_reps("K2 streamed encode", lambda: push_all(
            temporal_writer(k2), g2, K_CHUNK), times)
        blob2 = k2.read_bytes()
        host_reps("K2 batch encode_video", lambda: mt.encode_video(g2, cfg2),
                  times)
        cap2 = tmp / "k2_cap.mhvt"
        push_all(temporal_writer(cap2), g2[:K_SEGMENT], K_CHUNK)
        first2 = cap2.read_bytes()
        splits = []

        def append_k2():
            cap2.write_bytes(first2)
            spans = DecodeSpans([(fs, "decode_range"),
                                 (temporal, "fold_planes")])
            t0 = time.perf_counter()
            with spans:
                out = push_all(temporal_writer(cap2, append=True),
                               g2[K_SEGMENT:], K_CHUNK)
            total = time.perf_counter() - t0
            splits.append((spans.device_ms(), spans.host_s,
                           total - spans.host_s))
            return out

        host_reps("K2 append", append_k2, times)
        expected["decode_images"] += K_REPS  # the open group, one segment
        expected["temporal_fold"] += K_REPS  # its fold
        check(cap2.read_bytes() == blob2, "K2: capture 0-15 + append 15-30 "
              "differs from the one-shot MHVT capture")
        splits.sort()
        dev_ms, dec_s, enc_s = splits[len(splits) // 2]
        times["K2 append: open group decode, device ms"] = dev_ms
        times["K2 append: open group decode, host s"] = dec_s
        times["K2 append: the rest (encode, CRCs, writes), host s"] = enc_s
        print(f"time phase K K2 append split (median by device time): the "
              f"open group's decode and fold {dev_ms:.4f} ms on the card "
              f"(CUDA events), {dec_s:.4f} s host; the rest {enc_s:.4f} s")
        got = temporal.decode_temporal_video(blob2, device)
        expected["decode_images"] += 2
        expected["temporal_fold"] += 1
        check(np.array_equal(got, g2), "K2 decode_temporal_video")
        print(f"phase K2 ok: MC MHVT {G_FRAMES}x{h}x{w}, keyint {G_KEYINT}, "
              f"FCRC, segments of {K_SEGMENT}: capture 0-15 + append 15-30 "
              f"(open group 8-15 decoded and folded on {device}) == the "
              f"one-shot capture ({len(blob2)} B); decode_temporal_video == "
              "the frames")

        # K3: surgery on K1's and K2's files
        a, b = K_EXTRACT
        ext = host_reps("K3 extract MHV2 40-110",
                        lambda: surgery.extract_video(blob1, a, b), times)
        check(fs.source_crc32(ext) == zlib.crc32(f1[a:b]),
              "K3 extract: the combined CRC differs from zlib.crc32")
        got = mt.decode_video(ext, device)
        expected["decode_images"] += 1
        check(np.array_equal(got, f1[a:b]), "K3 extract 40-110")
        a2, b2 = K_EXTRACT_ACROSS
        ext2 = surgery.extract_video(blob1, a2, b2)
        got = mt.decode_video(ext2, device)
        expected["decode_images"] += 2
        check(np.array_equal(got, f1[a2:b2]) and fs.source_crc32(ext2)
              == zlib.crc32(f1[a2:b2]), "K3 extract 120-150")
        info: dict = {}
        ma, mb = K_MHVT_EXTRACT
        mext = host_reps(
            "K3 extract MHVT 11-27 (mid-group)",
            lambda: surgery.extract_video(blob2, ma, mb, info, device=device),
            times)
        expected["decode_images"] += 2 * K_REPS  # planes 8-16: 2 segments
        expected["temporal_fold"] += K_REPS  # the group 8-16, folded
        expected["frame_crc"] += K_REPS  # frames 11-15 checked on the card
        check(info == {"reencoded_frames": 5},
              f"K3 MHVT extract: info {info}")
        got = temporal.decode_temporal_video(mext, device)
        expected["decode_images"] += 2
        expected["temporal_fold"] += 1
        check(np.array_equal(got, g2[ma:mb]), "K3 MHVT extract 11-27")
        tail = mt.encode_video(f3[:K_CONCAT_TAIL])
        check(tail[:4] == fs.SHARED_MAGIC, "K3: the tail is no MHTV")
        cat = host_reps("K3 concat_videos", lambda: surgery.concat_videos(
            [ext, tail]), times)
        pe, pt, pc = tmp / "ext.mhtv", tmp / "tail.mhtv", tmp / "cat.mhv2"
        pe.write_bytes(ext)
        pt.write_bytes(tail)
        host_reps("K3 concat_videos_streamed",
                  lambda: surgery.concat_videos_streamed([pe, pt], pc), times)
        check(pc.read_bytes() == cat, "K3: concat_videos_streamed differs "
              "from concat_videos")
        got = mt.decode_video(cat, device)
        expected["decode_images"] += 2
        check(np.array_equal(got, np.concatenate([f1[a:b],
                                                  f3[:K_CONCAT_TAIL]])),
              "K3 concat")
        pr = tmp / "k1_reseg.mhv2"
        host_reps("K3 resegment_video_streamed",
                  lambda: surgery.resegment_video_streamed(k1, pr,
                                                           K_RESEGMENT),
                  times)
        rblob = pr.read_bytes()
        rsegs, *_ = fs.read_segmented(rblob)
        check([ft for _, ft in rsegs] == [16] * 8 + [8, 14]
              and fs.source_crc32(rblob) == fs.source_crc32(blob1)
              and np.array_equal(fs.read_frame_crcs(rblob),
                                 fs.read_frame_crcs(blob1)),
              f"K3 resegment: segments {[ft for _, ft in rsegs]}")
        got = fs.decode_frames_segmented(rsegs, h, w, CodecConfig(),
                                         check=True, device=device)
        expected["decode_images"] += len(rsegs)
        check(np.array_equal(got, f1), "K3 resegmented: checked decode")
        del got, rblob
        print(f"phase K3 ok: extract 40-110 (CRC combined == zlib.crc32) and "
              f"120-150 of K1, MHVT extract 11-27 ({info}), concat with a "
              f"{K_CONCAT_TAIL}-frame MHTV == its streamed form, resegment "
              f"of K1 at {K_RESEGMENT} (10 segments, checked decode): all "
              "decode on the card to their sources")

        # K4: color and MHTS captures
        k4c = tmp / "k4.mhtc"
        host_reps("K4 sub-green streamed encode", lambda: push_all(
            ColorStreamingEncoder(k4c, *G_COLOR, channels=3,
                                  colorspace=color.CS_SUBGREEN), g3,
            K_COLOR_CHUNK), times)
        host_reps("K4 sub-green batch writer",
                  lambda: color.encode_color_video_to_bytes(
                      g3, colorspace=color.CS_SUBGREEN), times)
        got = color.decode_color_video_from_bytes(k4c.read_bytes(), device)
        expected["decode_images"] += 1
        check(np.array_equal(got, g3), "K4 sub-green: decode differs")
        k4s = tmp / "k4.mhts"
        host_reps("K4 MHTS streamed encode", lambda: push_all(
            MHTSStreamingEncoder(k4s, h, w), f3, K_COLOR_CHUNK), times)
        batch = host_reps("K4 MHTS batch writer", lambda: fs.write_stream(
            fs.encode_frames(f3), h, w,
            source_crc32s=[zlib.crc32(f) for f in f3]), times)
        blob4 = k4s.read_bytes()
        check(blob4 == batch, "K4 MHTS: the streamed file differs from "
              "write_stream(encode_frames(...))")
        got, *_ = fs.decode_range(blob4, 0, F3_FRAMES, device=device)
        expected["decode_images"] += F3_FRAMES
        expected["frame_crc"] += F3_FRAMES  # each record's CRC-32
        check(np.array_equal(got, f3), "K4 MHTS: decode differs")
        print(f"phase K4 ok: sub-green {G_FRAMES}x{G_COLOR[0]}x{G_COLOR[1]}"
              f"x3 and the {F3_FRAMES}-table MHTS pushed {K_COLOR_CHUNK} at a "
              "time decode on the card to their sources; the MHTS file == "
              "write_stream(encode_frames(...))")
        counts = read_launches()
        check(counts == expected,
              f"phase K: kernel launches {counts}, expected {expected}")
        print(f"phase K launches: {counts}")

        # each kernel against its plain version on K's inputs (not counted)
        worst = {"decode_images": 0, "decode_blocks": 0}
        inner, *_ = temporal.unwrap(blob2)
        seg0, ft0 = fs.read_segmented(inner)[0][0]
        prep = fs.prepare_shared(seg0, ft0, h, w, CodecConfig(),
                                 device=device)
        for emit_end in (False, True):
            err = b1_against_plain(prep, CodecConfig(), emit_end)
            worst["decode_images"] = max(worst["decode_images"], err)
            check(err == 0, f"K2 segment 0: B1 (emit_end={emit_end}) "
                  f"differs from plain by {err}")
        stream16, t16 = fs.read_segmented(blob16)[0][0]
        prep = fs.prepare_shared(stream16, t16, h, w, cfg16, device=device)
        args = (prep.words, prep.offsets, prep.code)
        geo = dict(num_steps=256, delta=True, emit_end=True)
        out, end = decode_cuda.decode_blocks(*args, **geo)
        pout, pend = decode_cuda.decode_blocks_plain(*args, **geo)
        err = max(int((out.int() - pout.int()).abs().max()),
                  int((end - pend).abs().max()))
        worst["decode_blocks"] = err
        check(err == 0, f"K1 16x16: B2 differs from plain by {err}")
        del prep, out, pout
        torch.cuda.empty_cache()
        print("phase K ok: B1 == plain on K2's segment 0 (with and without "
              "end bits), B2 == plain on the 16x16 stream (bytes and end "
              "bits)")
    times["phase K, whole"] = time.perf_counter() - t_phase
    return counts, worst, times


_B1 = ("decode_images",)
_MHVT = ("decode_images", "temporal_fold")
L_SHORT = ["--frames", "8"]  # the fold chains' and the trace's depth
#: phase L: ``bench_torch.py``'s runs, by label -> (its arguments besides
#: ``-v --device``, the metric its line must name, the kernels its path
#: must launch; every other kernel must launch no time). The fold chains
#: of ``run_temporal_ext`` run at 8 frames, as phase J's perf matrix does,
#: to hold the phase near 150 s.
L_RUNS = {
    "video": (["--mode", "video"], "decode_throughput", _B1),
    "video photo": (["--mode", "video", "--content", "photo"],
                    "decode_throughput", _B1),
    "video delta2d": (["--mode", "video", "--precoder", "delta2d"],
                      "decode_throughput", _B1),
    "single": (["--mode", "single"], "decode_throughput", _B1),
    "encode": (["--mode", "encode"], "encode_throughput",
               ("encode_rows", "encode_stream")),
    "temporal": (["--mode", "temporal"], "temporal_decode_throughput",
                 _MHVT),
    "temporal motion": (["--mode", "temporal", "--motion", *L_SHORT],
                        "temporal_mc_decode_throughput", _MHVT),
    "temporal color": (["--mode", "temporal", "--inner", "color", *L_SHORT],
                       "temporal_color_decode_throughput", _MHVT),
    "temporal u16": (["--mode", "temporal", "--inner", "u16", *L_SHORT],
                     "temporal_u16_decode_throughput", _MHVT),
}
L_TRACED = "video"  # the run made once more with --trace, at 8 frames
L_TIMEOUT = 300  # seconds for one bench_torch.py process
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "reps", "spread_pct")


def run_bench(label: str, device, card: str,
              extra=()) -> tuple[dict, dict, float]:
    """Phase L: ``bench_torch.py -v --device device`` with run ``label``'s
    arguments as a process of its own (its session killed after
    ``L_TIMEOUT``) -> (its JSON line, its launch counts, its host-clock
    seconds), after checking the line, the metric and the launches."""
    import os
    import signal
    import subprocess

    args, metric, path = L_RUNS[label]
    argv = [sys.executable, str(ROOT / "bench_torch.py"), "-v", "--device",
            str(device), *args, *extra]
    t0 = time.perf_counter()
    proc = subprocess.Popen(argv, cwd=ROOT, stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True,
                            start_new_session=True)
    try:
        out, err = proc.communicate(timeout=L_TIMEOUT)
    except subprocess.TimeoutExpired:
        os.killpg(proc.pid, signal.SIGKILL)  # the supervisor and its child
        proc.communicate()
        raise PhaseError(f"phase L {label}: past {L_TIMEOUT} s") from None
    wall = time.perf_counter() - t0
    check(proc.returncode == 0, f"phase L {label}: exit {proc.returncode}:"
          f"\n{out[-4000:]}\n{err[-4000:]}")
    lines = out.strip().splitlines()
    check(len(lines) == 1, f"phase L {label}: {len(lines)} stdout lines")
    line = json.loads(lines[0])
    check(tuple(line) == BENCH_KEYS and line["metric"] == metric
          and line["unit"] == "GB/s" and line["value"] > 0
          and line["reps"] >= 3, f"phase L {label}: line {line}")
    found = [ln for ln in err.splitlines() if ln.startswith("launches ")]
    check(len(found) == 1, f"phase L {label}: no launch line:\n{err[-4000:]}")
    counts = json.loads(found[0][len("launches "):])
    check(all((counts[k] > 0) == (k in path) for k in counts),
          f"phase L {label}: launches {counts}, the path's {path}")
    print(f"phase L {label}: {wall:.3f} s; {lines[0]}; launches {counts}; "
          f"on {card}")
    print("\n".join(f"  {ln}" for ln in err.strip().splitlines()
                    if not ln.startswith("launches ")))
    return line, counts, wall


def trace_events(path: Path) -> dict:
    """A Chrome trace's host events, CUDA kernel events and B1's kernel
    events, counted."""
    events = json.loads(path.read_text()).get("traceEvents", [])
    kernels = [e for e in events if e.get("cat") == "kernel"]
    return {"host": sum(e.get("cat") in ("cpu_op", "cuda_runtime",
                                         "python_function",
                                         "user_annotation")
                        for e in events),
            "kernels": len(kernels),
            "b1": sum("decode_images_kernel" in e.get("name", "")
                      for e in kernels)}


def phase_l(device, card: str) -> tuple[dict, dict]:
    """``bench_torch.py``, the benchmark's entry, in every mode on
    ``device`` (see the module docstring) -> (the launches its processes
    reported, summed; each run's line, seconds and launches, and the traced
    run's event counts)."""
    import tempfile

    total = dict.fromkeys(KERNELS, 0)
    runs = {}
    for label in L_RUNS:
        line, counts, wall = run_bench(label, device, card)
        runs[label] = {"line": line, "s": wall, "launches": counts}
        for name, n in counts.items():
            total[name] += n
    with tempfile.TemporaryDirectory(prefix="mht_bench_trace_") as where:
        _, counts, wall = run_bench(L_TRACED, device, card,
                                    [*L_SHORT, "--trace", where])
        for name, n in counts.items():
            total[name] += n
        path = Path(where) / "trace.json"
        check(path.is_file(), "phase L trace: no trace.json")
        events = trace_events(path)
    check(events["host"] > 0, f"phase L trace: no host events: {events}")
    if not events["kernels"]:
        print("phase L trace: the profiler recorded no CUDA kernel "
              "(CUPTI did not trace the card)")
    print(f"phase L trace: {events['host']} host events, "
          f"{events['kernels']} CUDA kernel events, {events['b1']} of B1; "
          f"{wall:.3f} s; on {card}")
    return total, {"runs": runs, "trace": {**events, "s": wall}}


M_FRAMES = 8  #: phase M: frames of its G1 and G2 MHVT clips
M_RANGE = (130, 140)  #: phase M: F1's decode_range, across its segments
M_REGION_FRAMES = (134, 139)  #: phase M: the frames of F1's region decode


def cpu_model() -> str:
    """The host CPU as ``/proc/cpuinfo`` names its first processor: the
    model name, or where that is missing or "unknown", the vendor, family,
    model and clock."""
    import platform

    fields = {}
    try:
        for line in Path("/proc/cpuinfo").read_text().splitlines():
            if not line.strip():
                break
            key, _, value = line.partition(":")
            fields[key.strip()] = value.strip()
    except OSError:
        pass
    name = fields.get("model name", "")
    if name and name.lower() != "unknown":
        return name
    parts = [fields.get("vendor_id", platform.machine())]
    if "cpu family" in fields:
        parts.append(f"family {fields['cpu family']} model "
                     f"{fields.get('model', '?')}")
    if "cpu MHz" in fields:
        parts.append(f"{fields['cpu MHz']} MHz")
    return " ".join(parts)


def phase_m(device, card: str, f_ctx: dict) -> tuple[dict, dict]:
    """The host C++ decoder (``device="native"``) on the card's machine
    (see the module docstring), on its own inputs and on phase F's (F1's
    blob, F2's frames and segment 0, from ``f_ctx``) -> (the launches each
    kernel made, after checking them; the phase's numbers for its ``phase
    M`` line)."""
    import os
    import tempfile

    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch import cli, native
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models import temporal
    from metalhuffman_tpu_torch.models.config import CodecConfig

    t_phase = time.perf_counter()
    t, h, w = FULL
    nat = native.NATIVE
    threads = os.cpu_count()  # n_threads=0: std::thread's hardware count
    host = {"cpu": cpu_model(), "cpu_count": os.cpu_count(),
            "usable_cpus": len(os.sched_getaffinity(0)),
            "decode_threads": threads}
    print(f"phase M host: {host['cpu']}; os.cpu_count() {host['cpu_count']}"
          f", {host['usable_cpus']} usable; the native decode runs "
          f"{threads} threads; card {card}")
    expected = expect()
    times = {}

    def both(label, fn, want, kernel, n):
        """``fn(d)`` on ``native`` and on the card: each must equal
        ``want``, and the two each other; the card's call launches
        ``kernel`` ``n`` times."""
        t0 = time.perf_counter()
        got = fn(nat)
        dn = time.perf_counter() - t0
        t0 = time.perf_counter()
        card_out = fn(device)
        dc = time.perf_counter() - t0
        expected[kernel] += n
        check(got.dtype == want.dtype and got.shape == want.shape
              and np.array_equal(got, want),
              f"phase M {label}: the native decode differs from the source")
        check(np.array_equal(got, card_out),
              f"phase M {label}: the native decode differs from the card's")
        times[label] = {"native_s": dn, "card_s": dc}
        print(f"phase M {label}: native == source == {kernel} on the card "
              f"({dn:.3f} s native, {dc:.3f} s card, host clock)")

    t0 = time.perf_counter()
    synth = synthetic(t, h, w)
    photo30 = photo_frames(h, w, t)
    blob_s, blob_p = mt.encode_video(synth), mt.encode_video(photo30)
    img = photo30[0]
    mht8 = mt.encode_image(img)
    mht16 = mt.encode_image(img, CodecConfig(block_dim=16))
    f1 = photo_frames(h, w, F1_FRAMES)
    blob1 = f_ctx["blob1"]
    g = photo_frames(h, w, M_FRAMES)
    mhvt1 = mt.encode_video(g, CodecConfig(temporal=True, keyint=G_KEYINT,
                                           frame_crcs=True))
    mhvt2 = mt.encode_video(g, CodecConfig(temporal=True, motion=True,
                                           keyint=G_KEYINT, frame_crcs=True))
    check((temporal.unwrap(mhvt2)[3][1:] != 0).any(),
          "phase M G2: no motion vector found")
    print(f"phase M inputs encoded in {time.perf_counter() - t0:.2f} s")

    reset_launches()
    size = f"{t}x{w}x{h}"
    both(f"A/B synthetic {size} MHTV",
         lambda d: mt.decode_video(blob_s, d), synth, "decode_images", 1)
    both(f"A/B photo {size} MHTV",
         lambda d: mt.decode_video(blob_p, d), photo30, "decode_images", 1)
    both("MHT1 photo 8x8", lambda d: mt.decode_image(mht8, d), img,
         "decode_images", 1)
    both("MHT1 photo 16x16", lambda d: mt.decode_image(mht16, d), img,
         "decode_blocks", 1)
    a, b = M_RANGE
    both(f"F1 MHV2 decode_range {a}-{b}",
         lambda d: fs.decode_range(blob1, a, b, device=d)[0], f1[a:b],
         "decode_images", 2)
    expected["frame_crc"] += 1  # the card's range checks its FCRC there
    y0, x0, rh, rw = F_REGION
    a, b = M_REGION_FRAMES
    both(f"F1 MHV2 {rh}x{rw} region of frames {a}-{b - 1} (checked)",
         lambda d: fs.decode_video_region(blob1, a, b, y0, x0, rh, rw,
                                          check=True, device=d),
         f1[a:b, y0:y0 + rh, x0:x0 + rw], "decode_blocks", 2)
    del f1
    both(f"G1 MHVT {M_FRAMES}x{w}x{h}", lambda d: mt.decode_video(mhvt1, d),
         g, "decode_images", 1)
    both(f"G2 MC MHVT {M_FRAMES}x{w}x{h}",
         lambda d: mt.decode_video(mhvt2, d), g, "decode_images", 1)
    expected["temporal_fold"] += 2  # the two MHVT folds on the card
    s20 = f_ctx["f2 segment 0"]
    t20 = s20.block_offsets.size // ((h // 8) * (w // 8))
    past = int((s20.block_offsets >= np.uint32(1 << 31)).sum())
    check(past > 0, "phase M F2: no block offset past 2^31")
    both(f"F2 MHV2 segment 0, {t20} frames, {past} blocks past 2^31 bits",
         lambda d: fs.decode_frames_shared(
             s20, t20, h, w, CodecConfig(delta=False), device=d
         ).cpu().numpy(), f_ctx["f2"][:t20], "decode_images", 1)
    counts = read_launches()
    check(counts == expected,
          f"phase M: kernel launches {counts}, expected {expected}")
    print(f"phase M launches: {counts}")

    # --check on native is refused, in the library and on the CLI
    segs, *_ = fs.read_segmented(blob1)
    try:
        fs.decode_frames_segmented(segs, h, w, check=True, device=nat)
    except ValueError as e:
        print(f"phase M refused: checked decode on native: {e}")
    else:
        raise PhaseError("phase M: a checked decode ran on native")
    with tempfile.TemporaryDirectory(prefix="mht_phase_m_") as where:
        path = Path(where) / "f1.mhv2"
        path.write_bytes(blob1)
        for flags in ([], ["--streaming"]):
            argv = ["decode-video", str(path), str(Path(where) / "o.npy"),
                    "--check", *flags, "--device", nat]
            try:
                cli.main(argv)
            except SystemExit as e:
                check(e.code == cli.NATIVE_CHECK_REFUSAL,
                      f"phase M: decode-video --check {flags} on native "
                      f"exited with {e.code!r}")
                print(f"phase M refused: decode-video --check {flags} "
                      f"--device native: {e.code}")
            else:
                raise PhaseError("phase M: decode-video --check ran on "
                                 "native")
    del segs

    # the timed batch: the native decode on the host clock beside B1's
    # queued calls with CUDA events, on the 30x2048x1536 synthetic batch
    cfg = CodecConfig()
    stream = fs.read_shared(blob_s)[0]
    nbytes = synth.size
    whole = host_timed(f"M native decode_frames_shared {size} synthetic",
                       lambda s: fs.decode_frames_shared(s, t, h, w, cfg,
                                                         device=nat),
                       [stream], card, nbytes)
    blocks_only = host_timed("M native.decode_blocks alone",
                             native.decode_blocks, [stream], card, nbytes)
    _base, preps = staged_batches(device, cfg)
    b1_ms = back_to_back("M B1 queued", lambda p: fs.decode_shared_step(
        p, cfg, raw=True), preps, card, nbytes)
    del preps
    numbers = {
        "native_ms": whole, "native_gbps": nbytes / whole / 1e6,
        "native_blocks_ms": blocks_only,
        "native_blocks_gbps": nbytes / blocks_only / 1e6,
        "b1_queued_ms": b1_ms, "b1_gbps": nbytes / b1_ms / 1e6,
        "factor": whole / b1_ms}
    print(f"time M: the native decode of {size} synthetic frames "
          f"{numbers['native_gbps']:.3f} GB/s ({threads} threads on "
          f"{host['cpu']}; decode_blocks alone "
          f"{numbers['native_blocks_gbps']:.3f}), B1 queued "
          f"{numbers['b1_gbps']:.3f} GB/s on {card}: the host decoder takes "
          f"{numbers['factor']:.1f}x B1's time")
    numbers["phase_s"] = time.perf_counter() - t_phase
    print(f"phase M: {numbers['phase_s']:.1f} s in all")
    return counts, {"card": card, **host, **numbers, "s": times}


N_DIMS = (1, 3, 5, 6, 12, 32)  #: phase N: B2 against its plain version
N_DELTA2D = (12, 32)  #: phase N: delta2d through the torch post-pass
N_WIDE = (255, 510)  #: phase N: a frame of two 255x255 blocks, 1-D delta
N_VIDEO = (3, 12, 32)  #: phase N: the 30x2048x1536 videos and B2's times
N_IMAGE = (3, 32)  #: phase N: decode_image and a checked region of the photo
N_FCRC = 12  #: phase N: the block size whose videos record per-frame CRCs
N_RANGE = (5, 13)  #: phase N: frames of the FCRC video's decode_range
N_REGION = (512, 768, 512, 512)  #: (y0, x0, rh, rw) of phase N's region
N_PLAIN_ITERS = 3  #: phase N: timed calls of B2's plain version


def phase_n(device, card: str) -> tuple[dict, int, dict]:
    """Block sizes off 2/4/8/16 (see the module docstring): B2 against its
    plain version, then the user path at full size, then B2's times ->
    (the launches each kernel made on the user path, after checking them;
    B2's max absolute difference from its plain version; the phase's
    numbers for its ``phase N`` line)."""
    import metalhuffman_tpu_torch as mt
    from metalhuffman_tpu_torch import native
    from metalhuffman_tpu_torch.models import frame_stream as fs
    from metalhuffman_tpu_torch.models.config import CodecConfig
    from metalhuffman_tpu_torch.models.image_codec import ImageCodec
    from metalhuffman_tpu_torch.ops import decode_cuda

    t_phase = time.perf_counter()
    t, h, w = FULL
    frame = synthetic_frame(h, w)
    cases = [(bd, {"delta": d}) for bd in N_DIMS for d in (True, False)]
    cases += [(bd, {"delta2d": True}) for bd in N_DELTA2D]
    worst = max(b2_case(device, "phase N", frame, bd, kw) for bd, kw in cases)
    worst = max(worst, b2_case(device, "phase N", synthetic_frame(*N_WIDE),
                               255, {"delta": True}))
    t_check = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    contents = {"synthetic": synthetic(t, h, w),
                "photo": photo_frames(h, w, t)}
    blobs = {(bd, name): mt.encode_video(frames, CodecConfig(
        block_dim=bd, frame_crcs=bd == N_FCRC))
        for bd in N_VIDEO for name, frames in contents.items()}
    img = photo()
    mht1 = {bd: mt.encode_image(img, CodecConfig(block_dim=bd))
            for bd in N_IMAGE}
    t_encode = time.perf_counter() - t0
    print(f"phase N inputs encoded in {t_encode:.2f} s")

    size = f"{t}x{w}x{h}"
    expected = expect()
    times = {}
    reset_launches()
    for (bd, name), blob in blobs.items():
        frames = contents[name]
        t0 = time.perf_counter()
        got = mt.decode_video(blob, device)
        dc = time.perf_counter() - t0
        t0 = time.perf_counter()
        nat = mt.decode_video(blob, native.NATIVE)
        dn = time.perf_counter() - t0
        expected["decode_blocks"] += 1
        label = f"decode_video {name} {size} {bd}x{bd}"
        check(np.array_equal(got, frames),
              f"phase N {label}: the frames differ from the source")
        check(np.array_equal(nat, got),
              f"phase N {label}: the card's frames differ from native's")
        times[label] = {"card_s": dc, "native_s": dn, "bytes": len(blob)}
        print(f"phase N ok: {label} ({len(blob)} B, "
              f"{len(blob) / frames.size:.4f}) == source == native "
              f"({dc:.3f} s card, {dn:.3f} s native, host clock)")
    a, b = N_RANGE
    got = fs.decode_range(blobs[N_FCRC, "photo"], a, b, device=device)[0]
    expected["decode_blocks"] += 1
    expected["frame_crc"] += 1
    check(np.array_equal(got, contents["photo"][a:b]),
          f"phase N decode_range {a}-{b}: the frames differ from the source")
    print(f"phase N ok: decode_range {a}-{b} of the photo MHTV at "
          f"{N_FCRC}x{N_FCRC}, checked against its per-frame CRCs")
    y0, x0, rh, rw = N_REGION
    for bd, blob in mht1.items():
        check(np.array_equal(mt.decode_image(blob, device), img),
              f"phase N decode_image {bd}x{bd}: the image differs")
        cfg = CodecConfig(block_dim=bd)
        region = ImageCodec(cfg).decode_region(
            ImageCodec(cfg).encode(img), h, w, y0, x0, rh, rw, check=True,
            device=device)
        expected["decode_blocks"] += 2
        check(np.array_equal(region, img[y0:y0 + rh, x0:x0 + rw]),
              f"phase N decode_region {bd}x{bd}: the crop differs")
        print(f"phase N ok: decode_image photo {bd}x{bd} ({len(blob)} B) "
              f"CRC-checked and a checked {rh}x{rw} decode_region, equal")
    counts = read_launches()
    check(counts == expected,
          f"phase N: kernel launches {counts}, expected {expected}")
    print(f"phase N launches: {counts}")
    del contents, mht1

    # B2 alone on the synthetic batch at each size, with CUDA events
    numbers = {}
    for bd in N_VIDEO:
        cfg = CodecConfig(block_dim=bd)
        prep = fs.prepare_shared(fs.read_shared(blobs[bd, "synthetic"])[0],
                                 t, h, w, cfg, device=device)
        geo = dict(num_steps=bd * bd, delta=True)
        args = (prep.words, prep.offsets, prep.code)

        def b2(p, geo=geo, args=args):
            return decode_cuda.decode_blocks(*args, **geo)

        def b2_plain(_p, geo=geo, args=args):
            return decode_cuda.decode_blocks_plain(*args, **geo)

        err = int((b2(prep).int() - b2_plain(prep).int()).abs().max())
        worst = max(worst, err)
        check(err == 0, f"phase N timed B2 {bd}x{bd}: kernel differs from "
              f"plain by {err}")
        nb = prep.offsets.numel()
        nbytes = nb * bd * bd
        label = f"N B2 {bd}x{bd} {size}"
        shape = report_shape(label, "decode_blocks", prep, num_steps=bd * bd)
        ms = timed(f"{label} kernel", b2, [prep], card, nbytes)
        queued = back_to_back(f"{label} kernel", b2, [prep], card, nbytes)
        plain_ms = timed(f"{label} plain", b2_plain, [prep], card, nbytes,
                         iters=N_PLAIN_ITERS)
        bms, by = bound(label, prep, nbytes)
        numbers[f"{bd}x{bd}"] = {
            "blocks": nb, "ms": ms, "queued_ms": queued, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "ctas_per_sm": shape["ctas_per_sm"],
            "grid": shape["grid"], "registers": shape["registers"]}
        del prep
    total = time.perf_counter() - t_phase
    print(f"phase N: {total:.1f} s in all ({t_check:.1f} s B2 against its "
          f"plain version, {t_encode:.1f} s host encode)")
    return counts, worst, {"card": card, "launches": counts, "b2": numbers,
                           "s": times, "phase_s": total}


O_SIZES = (1, 15, 16, 17, 4095, 40 * 72, 48 * 64)  #: phase O: frame bytes
O_DEPTHS = (1, 3, 8)  #: phase O: frames a stack of each of O_SIZES
O_OFFSETS = (1, 2, 4, 8)  #: phase O: bytes a misaligned stack starts late
O_FRAMES = 8  #: phase O: the most frames of the range cell's requests
O_ROUNDS = 3  #: phase O: rounds of queued calls behind a spin


def phase_o(device, card: str) -> tuple[dict, int, dict, dict]:
    """C1, the per-frame CRC-32 (``csrc/frame_crc.cu`` through
    ``crc_cuda.frame_crcs``), on the card against ``zlib.crc32`` of every
    frame: the first 1 to 8 of 8 panned 2048x1536 photo frames (a range
    request's frames), random stacks of 1, 3 and 8 frames of the odd sizes
    ``O_SIZES``, and stacks of 3 frames starting ``O_OFFSETS`` bytes past an
    aligned address (every access width). Then its time on the 8 bridge
    frames, L2-warm as after a range request's decode: one call between
    CUDA events (median of 12), and the card's time of a call queued behind
    a spin (median of ``O_ROUNDS`` rounds), beside the byte bound (every
    frame byte read once, 4 bytes a frame written), and zlib's on the host
    -> (launches, frames whose CRC differs from zlib's, the ``phase O``
    line's numbers, the kernels line's entry)."""
    import statistics

    import torch

    from metalhuffman_tpu_torch.ops import crc_cuda

    _t, h, w = FULL
    bridge = photo_frames(h, w, O_FRAMES)
    rng = np.random.default_rng(22)
    expected = expect()
    wrong = 0
    reset_launches()

    def hashed(label, x):
        nonlocal wrong
        got = crc_cuda.frame_crcs(x).cpu().numpy().tolist()
        expected["frame_crc"] += 1
        want = [zlib.crc32(f.tobytes())
                for f in x.cpu().numpy().reshape(x.shape[0], -1)]
        bad = sum(g != z for g, z in zip(got, want))
        wrong += bad
        check(bad == 0, f"phase O {label}: {bad} of {len(want)} CRCs differ "
              "from zlib's")

    x = torch.from_numpy(bridge).to(device)
    for k in range(1, O_FRAMES + 1):
        hashed(f"{k} bridge frames", x[:k])
    for n in O_SIZES:
        for t in O_DEPTHS:
            hashed(f"{t}x{n} B", torch.from_numpy(
                rng.integers(0, 256, (t, n), dtype=np.uint8)).to(device))
    widths, misaligned = set(), 0
    for n in (*O_SIZES[3:], h * w):
        for off in O_OFFSETS:
            buf = torch.from_numpy(
                rng.integers(0, 256, off + 3 * n, dtype=np.uint8)).to(device)
            xs = buf[off:].view(3, n)
            vec = crc_cuda.access_width(n, xs.data_ptr())
            widths.add(vec)
            misaligned += 1
            hashed(f"3x{n} B at +{off} ({vec} B loads)", xs)
    check(widths == {1, 2, 4, 8}, f"phase O: access widths {widths}")
    counts = read_launches()
    check(counts == expected,
          f"phase O: kernel launches {counts}, expected {expected}")
    print(f"phase O ok: C1 == zlib.crc32 on {O_FRAMES} stacks of 1-"
          f"{O_FRAMES} bridge frames, {len(O_SIZES) * len(O_DEPTHS)} stacks "
          f"of {O_SIZES} B frames and {misaligned} misaligned ones "
          f"(loads of {sorted(widths)} B); launches {counts}")

    nb = x.numel()
    label = f"frame CRC {O_FRAMES}x{w}x{h}"
    one_ms = timed(f"{label} one call", crc_cuda.frame_crcs, [x], card, nb,
                   "hashed")
    ms = statistics.median(behind_spin(f"{label} round {r}",
                                       crc_cuda.frame_crcs, x, card, nb)
                           for r in range(O_ROUNDS))
    bms, by = roofline(label, nb + 4 * O_FRAMES, 0)
    plain_ms = host_timed(
        f"{label} zlib.crc32 on the host",
        lambda f: [zlib.crc32(g.tobytes()) for g in f], [bridge], card, nb)
    print(f"{label}: C1 {ms * 1e3:.2f} us on the card, median of "
          f"{O_ROUNDS} rounds ({100 * bms / ms:.1f} % of the {bms * 1e3:.2f} "
          f"us bound), one call between events {one_ms * 1e3:.2f} us; zlib "
          f"{plain_ms:.3f} ms on the host ({plain_ms / ms:.0f}x), on {card}")
    numbers = {"card": card, "launches": counts, "frames": O_FRAMES,
               "ms": ms, "one_call_ms": one_ms, "bound_ms": bms,
               "zlib_host_ms": plain_ms}
    return counts, wrong, numbers, dict(max_abs_err=wrong, ms=ms,
                                        plain_ms=plain_ms, bound_ms=bms,
                                        bound_by=by)


def timed(label: str, fn, inputs, card: str, nbytes: int,
          unit: str = "decoded", iters: int = TIMED_ITERS) -> float:
    """Median ms of ``fn`` over ``iters`` calls cycling over ``inputs``,
    with CUDA events; prints it, as ``nbytes`` per call in GB/s ``unit``,
    beside the card."""
    import torch

    for x in inputs:  # warm up
        fn(x)
    torch.cuda.synchronize()
    times = []
    for i in range(iters):
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


def report_shape(label: str, name: str, prep, num_steps: int = 64) -> dict:
    """Print the grid of kernel ``name`` on a staged batch (1-D delta) and
    what ptxas gave the kernel; return them (``decode_cuda.launch_shape``)."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    nb = prep.offsets.numel()
    s = decode_cuda.launch_shape(name, prep.words.numel(), nb, prep.code,
                                 num_steps=num_steps)
    threads = s["grid"] * 256
    print(f"grid {label}: {s['ctas_per_sm']} resident CUDA blocks of 256 per "
          f"SM, grid {s['grid']}, shared memory per CUDA block "
          f"{s['dyn_smem']} B table + {s['static_smem']} B static "
          f"({prep.code.num_t2} T2 tables of 32 entries); "
          f"{s['registers']} registers, {s['local_bytes']} B local "
          f"(spills) per thread; {nb / threads:.3f} blocks per thread, the "
          f"busiest {-(-nb // threads)}")
    return s


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
        return (p.words, p.offsets, p.code)

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

    payload = encode_payload(synthetic(*FULL))
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
    rotations (one table, distinct bitstreams) -> (preps, S2's tables of
    each)."""
    from metalhuffman_tpu_torch.models import frame_stream as fs

    preps, widths = [], None
    for v in range(VARIANTS):
        stream = fs.encode_frames_shared(np.roll(frames, v, axis=0))
        if widths is None:
            widths = stream.widths
        check(np.array_equal(stream.widths, widths),
              "timed probe inputs: the table differs between rotations")
        preps.append(fs.prepare_shared(stream, *FULL, device=device))
    return preps, [probe_tables(widths, device)] * len(preps)


HOST_CALLS = 50  # B1 calls enqueued back to back per host-clock round
HOST_ROUNDS = 7


def wrapper_host_us(p, card: str) -> dict:
    """Host us per B1 call enqueued back to back on a staged 30x2048x1536
    batch (host clock over HOST_CALLS calls, median of HOST_ROUNDS rounds
    taken in turns, the card catching up between rounds): through
    ``decode_images`` (checks, ``torch.empty``, the stream, ctypes) and
    through its C entry alone with every argument made beforehand. The
    difference is the most that cutting the wrapper's host work can save
    per call."""
    import torch

    from metalhuffman_tpu_torch import _build
    from metalhuffman_tpu_torch.ops import decode_cuda

    t = p.num_frames
    out = torch.empty((t, p.bh * 8, p.bw * 8), dtype=torch.uint8,
                      device=p.words.device)
    entry = _build.lib("decode_images").mht_decode_images
    c_args = (p.words.data_ptr(), p.words.numel(), p.offsets.data_ptr(),
              p.offsets.numel(), p.bh, p.bw, p.code.entries.data_ptr(),
              p.code.entries.numel(), int(p.code.t2_in_smem), 1,
              out.data_ptr(), None, torch.cuda.current_stream().cuda_stream)

    def wrapper():
        decode_cuda.decode_images(p.words, p.offsets, p.code, num_frames=t,
                                  bh=p.bh, bw=p.bw, delta=True)

    def c_entry():
        check(entry(*c_args) == 0, "host timing: the C entry failed")

    fns = {"decode_images": wrapper, "C entry": c_entry}
    per = {name: [] for name in fns}
    for _ in range(HOST_ROUNDS):
        for name, fn in fns.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(HOST_CALLS):
                fn()
            per[name].append((time.perf_counter() - t0) * 1e6 / HOST_CALLS)
    torch.cuda.synchronize()
    med = {}
    for name, us in per.items():
        us.sort()
        med[name] = us[len(us) // 2]
        print(f"host B1 {name} photo 30x2048x1536: median {med[name]:.2f} us "
              f"per enqueued call of {HOST_ROUNDS} rounds of {HOST_CALLS} "
              f"(min {us[0]:.2f}, max {us[-1]:.2f}), host clock, on {card}")
    added = med["decode_images"] - med["C entry"]
    print(f"host B1: the wrapper adds {added:.2f} us per call to its C "
          "entry's")
    return med


def probe_timings(device, card: str) -> dict:
    """Times of B1, S1 and every S2 variant in interleaved rounds on 4 staged
    30x2048x1536 photo batches and 4 synthetic ones, after holding each
    equal to the plain version on every input, with each launch's CUDA
    blocks per SM and registers; of every S3 variant and the int32 plain
    chain on 2^22 elements; the SASS opcodes of the S3 kernels and of S2's
    b1 family. Returns the probes' JSON entries (launches left 0)."""
    import torch

    from metalhuffman_tpu_torch.ops import decode_cuda
    from metalhuffman_tpu_torch.probes import (ablate_decode, int16_rate,
                                               measure_interleaved, median,
                                               strips)

    entries = {}
    t, h, w = FULL
    for content, frames in (("photo", photo_frames(h, w, t)),
                            ("synthetic", synthetic(t, h, w))):
        preps, tabs = probe_batches(frames, device)

        def args(i):
            p = preps[i]
            return ((p.words, p.offsets, p.code),
                    dict(num_frames=t, bh=p.bh, bw=p.bw))

        def b1_plain(p):
            return decode_cuda.decode_images_plain(
                p.words, p.offsets, p.code,
                num_frames=t, bh=p.bh, bw=p.bw, delta=True)

        def variant(v):
            def run(i):
                a, g = args(i)
                return ablate_decode.ablate_decode(*a, **g, variant=v,
                                                   **tabs[i])
            return run

        def b1(i):
            a, g = args(i)
            return decode_cuda.decode_images(*a, **g, delta=True)

        def s1(prefetch):
            def run(i):
                a, g = args(i)
                return strips.decode_strips(*a, **g,
                                            prefetch=prefetch)
            return run

        fns = {"B1": b1,
               **{f"S1 {f}": s1(pf) for f, pf in strips.FORMS.items()},
               **{f"S2 {v}": variant(v) for v in ablate_decode.VARIANTS}}
        for i, p in enumerate(preps):
            plain = b1_plain(p)
            for label, fn in fns.items():
                want = (ablate_decode.xor_fold(plain, **args(i)[1])
                        if label == "S2 xorfold" else plain)
                check(torch.equal(fn(i), want), f"timed {content} input {i}: "
                      f"{label} differs from the plain version")
        p0, n0 = preps[0], preps[0].offsets.numel()
        report_shape(f"B1 {content} 30x2048x1536", "decode_images", p0)
        shapes = {"B1": decode_cuda.launch_shape(
                      "decode_images", p0.words.numel(), n0, p0.code),
                  **{f"S1 {f}": strips.launch_shape(n0, p0.code, pf)
                     for f, pf in strips.FORMS.items()},
                  **{f"S2 {v}": ablate_decode.launch_shape(
                      v, n0, p0.code, **tabs[0])
                     for v in ablate_decode.VARIANTS}}
        spans = strips.cta_spans(p0.offsets, p0.words.numel())
        span_bytes = 4 * (spans[:, 1] - spans[:, 0]).double()
        print(f"full-size check ok: B1, S1 {', '.join(strips.FORMS)}, S2 "
              f"{', '.join(ablate_decode.VARIANTS)}"
              f" == plain on {VARIANTS} staged {content} 30x2048x1536 inputs "
              f"(T2 tables {tabs[0]['lut'].num_t2} at 8/8, "
              f"{p0.code.num_t2} at 11/5; "
              f"{len(ablate_decode.pruned_terms(p0.code.bounds,
                                                p0.code.adj)[0])}"
              f" compare terms; S1's code spans mean {span_bytes.mean():.0f} "
              f"B, max {span_bytes.max():.0f} B)")
        times = measure_interleaved(fns, len(preps))
        bms, by = bound(f"B1 {content} 30x2048x1536", p0, frames.size)
        for label, ms in times.items():
            med, sh = median(ms), shapes[label]
            print(f"time {label} {content} 30x2048x1536: median {med:.4f} ms "
                  f"of {len(ms)} interleaved rounds (min {ms[0]:.4f}, max "
                  f"{ms[-1]:.4f}), {frames.size / med / 1e6:.3f} GB/s decoded, "
                  f"{100 * bms / med:.1f} % of the bound, "
                  f"{sh['ctas_per_sm']} CTAs/SM, grid {sh['grid']}, "
                  f"{sh['registers']} registers, {sh['local_bytes']} local "
                  f"bytes, on {card}")
        b1_ms, y_ms = times["B1"], times["S2 b1"]
        inside = b1_ms[0] <= median(y_ms) <= b1_ms[-1]
        print(f"yardstick {content}: S2 b1 median {median(y_ms):.4f} ms "
              f"{'inside' if inside else 'OUTSIDE'} B1's spread "
              f"{b1_ms[0]:.4f}-{b1_ms[-1]:.4f} ms")
        if content == "photo":
            wrapper_host_us(p0, card)
            plain_ms = timed("S1/S2 plain (B1's) photo 30x2048x1536",
                             b1_plain, preps, card, frames.size)
            common = dict(max_abs_err=0, plain_ms=plain_ms, bound_ms=bms,
                          bound_by=by)
            entries["decode_strips"] = dict(
                ms=median(times["S1 strips"]), **common,
                variants={f: median(times[f"S1 {f}"]) for f in strips.FORMS})
            entries["ablate_decode"] = dict(
                ms=median(times["S2 base"]), **common,
                variants={v: median(times[f"S2 {v}"])
                          for v in ablate_decode.VARIANTS})
        del preps, tabs
    for v, counts in ablate_decode.sass_opcodes().items():
        print(f"SASS S2 {v}: {sum(counts.values())} instructions: " + ", ".join(
            f"{op} {k}" for op, k in counts.most_common()))

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
                tab = (p.code.entries.data_ptr(), p.code.entries.numel(),
                       *k1, int(p.code.t2_in_smem), 1,
                       outs[which].data_ptr(), None)
            else:
                tab = ((ctypes.c_uint32 * 16)(*p.code.bounds),
                       (ctypes.c_int32 * 16)(*p.code.adj),
                       p.code.symbols.data_ptr(), 1,
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
    b2_err = max(phase_a_blocks(device), phase_a_widest(device))
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
    i_counts, i_times, i_bench = phase_i(device, f_ctx["blob1"])
    for name, count in i_counts.items():
        launches[name] += count
    j_counts, j_times, j_rows, j_scaling = phase_j(device)
    for name, count in j_counts.items():
        launches[name] += count
    k_counts, k_errs, k_times = phase_k(device)
    for name, count in k_counts.items():
        launches[name] += count
    l_counts, l_runs = phase_l(device, card)
    for name, count in l_counts.items():
        launches[name] += count
    m_counts, m_numbers = phase_m(device, card, f_ctx)
    for name, count in m_counts.items():
        launches[name] += count
    n_counts, n_err, n_numbers = phase_n(device, card)
    for name, count in n_counts.items():
        launches[name] += count
    o_counts, o_err, o_numbers, o_entry = phase_o(device, card)
    for name, count in o_counts.items():
        launches[name] += count
    entries = timings(device, card)
    entries["encode_stream"], entries["encode_rows"] = encode_timings(
        device, card)
    image_timings(device, card)
    entries.update(probe_timings(device, card))
    stream_timings(device, card, f_ctx)
    del f_ctx
    entries["temporal_fold"] = temporal_timings(device, card, g_blobs)
    entries["frame_crc"] = o_entry
    del g_blobs
    max_err = max(max_err, f_errs["decode_images"], g_errs["decode_images"],
                  h_errs["decode_images"], k_errs["decode_images"])
    b2_err = max(b2_err, f_errs["decode_blocks"], g_errs["decode_blocks"],
                 h_errs["decode_blocks"], k_errs["decode_blocks"], n_err)
    errs["temporal_fold"] = g_errs["temporal_fold"]
    errs.update(decode_images=max_err, decode_blocks=b2_err,
                encode_stream=max(stream_err, h_errs["encode_stream"]),
                encode_rows=max(b3_err, h_errs["encode_rows"]))
    for name, err in errs.items():
        entries[name]["max_abs_err"] = max(err, entries[name]["max_abs_err"])
    print(f"total {time.perf_counter() - t_start:.1f} s")
    print("phase H " + json.dumps({"card": card, "launches": h_counts,
                                   "ms": h_times}))
    print("phase I " + json.dumps({"card": card, "launches": i_counts,
                                   "s": i_times, "bench": i_bench}))
    print("phase J " + json.dumps({"card": card, "launches": j_counts,
                                   "s": j_times, "perf_matrix": j_rows,
                                   "scaling_report": j_scaling}))
    print("phase K " + json.dumps({"card": card, "launches": k_counts,
                                   "s": k_times}))
    print("phase L " + json.dumps({"card": card, "launches": l_counts,
                                   **l_runs}))
    print("phase M " + json.dumps({"launches": m_counts, **m_numbers}))
    print("phase N " + json.dumps(n_numbers))
    print("phase O " + json.dumps(o_numbers))
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
