"""The system under test: what the benchmark calls of ``metalhuffman_tpu_torch``.

The only module of the benchmark that imports the port. It takes the
port's entry points, its build, and its launch counters; every input it is
given (the clips) is the benchmark's own, and everything it derives (the
encoded streams, the staged tensors, the motion vectors) stays the port's.
"""

from __future__ import annotations

import dataclasses
import time
from collections.abc import Callable
from dataclasses import dataclass

import numpy as np


def codec_config(config: dict):
    """The port's ``CodecConfig`` of a configuration's ``codec`` group."""
    from metalhuffman_tpu_torch.models.config import CodecConfig

    return CodecConfig(**config["codec"])


def build() -> float:
    """Build or load the port's CUDA kernels and its host codec -> seconds.
    The libraries live under ``build/`` in the checkout, so only a
    checkout's first run compiles."""
    from metalhuffman_tpu_torch import _build, native

    t0 = time.perf_counter()
    _build.build()
    native.build()
    _build.lib("decode_images")
    return time.perf_counter() - t0


def launches() -> dict:
    """The port's kernel launches in this process, by kernel."""
    from metalhuffman_tpu_torch.ops import decode_cuda

    return dict(decode_cuda.launches)


@dataclass
class Staged:
    """One staged clip: ``call`` is the window's call and returns the
    answer, a tensor on the device; ``shape`` the counts the rooflines
    read (code words, block offsets, symbols the decode writes, bytes of
    the frames the call reconstructs)."""

    call: Callable
    shape: dict


def stage(config: dict, clip: np.ndarray, order: np.ndarray,
          pan: tuple[int, int], device) -> Staged:
    """Encode ``clip`` (the seed's clip in frame order ``order`` of a clip
    panned by ``pan``; the port is given the frames alone) with the port's
    host encoder and stage it on ``device``, as the configuration stores it.

    A plain configuration decodes its shared-table stream of 8x8 blocks in
    one launch, to the raw (T, bh*8, bw*8) layout. A temporal one stages
    the residual planes of ``temporal_encode_mc`` and folds them after the
    decode, as ``bench._time_mhvt`` does.
    """
    from metalhuffman_tpu_torch.models import frame_stream, temporal

    cfg = codec_config(config)
    t, h, w = clip.shape
    planes, mvs = clip, None
    if cfg.temporal:
        planes, mvs = temporal.temporal_encode_mc(clip, cfg.keyint)
        cfg = dataclasses.replace(cfg, temporal=False, motion=False,
                                  frame_crcs=False)
    stream = frame_stream.encode_frames_shared(planes, cfg)
    prep = frame_stream.prepare_shared(stream, t, h, w, cfg, device=device)
    keyint = config["codec"]["keyint"]
    if config["codec"]["temporal"]:
        def call():
            res = frame_stream.decode_shared_step(prep, cfg)
            return temporal.fold_planes(res, keyint, mvs, None, None)
    else:
        def call():
            return frame_stream.decode_shared_step(prep, cfg, raw=True)
    shape = {"words": prep.words.numel(), "offsets": prep.offsets.numel(),
             "symbols": t * prep.bh * 8 * prep.bw * 8,
             "frame_bytes": clip.nbytes}
    return Staged(call, shape)


def ranged(config: dict, clip: np.ndarray, device) -> tuple[Callable, int]:
    """Store the clip as the configuration does (the container bytes of
    the port's ``encode_video``, held in host memory) and parse it once, as
    a player or loader that asks for many ranges of one clip does -> (``(a,
    b) ->`` frames [a, b) as numpy, the container's bytes). A request goes
    through the public random access at its defaults,
    ``frame_stream.decode_range_parsed``, checked against the per-frame
    CRCs."""
    import metalhuffman_tpu_torch
    from metalhuffman_tpu_torch.models import frame_stream

    blob = metalhuffman_tpu_torch.encode_video(clip, codec_config(config))
    parsed = frame_stream.parse_range_container(blob)

    def decode(a, b):
        return frame_stream.decode_range_parsed(parsed, a, b,
                                                device=device)[0]
    return decode, len(blob)
