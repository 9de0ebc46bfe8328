"""The port's streaming writers (``metalhuffman_tpu_torch.models.
stream_writer``) against the JAX package's, byte for byte.

The same seeded numpy frames are pushed through both packages' writers, in
chunks of 1, 3 and all frames, with and without the per-frame CRC table;
the files must be equal (tolerance 0), equal to the port's own batch writer
(``write_segmented(encode_frames_segmented(...))``), and decode to the
frames on the CPU. Every JAX writer encodes on the host, so no Pallas kernel
is compiled. The writers' refusals raise what the JAX writers raise.
"""

import io
import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import stream_writer as jsw
from metalhuffman_tpu_torch import decode_video
from metalhuffman_tpu_torch.core import blocks
from metalhuffman_tpu_torch.models import color, frame_stream, temporal
from metalhuffman_tpu_torch.models import stream_writer as tsw
from metalhuffman_tpu_torch.models.config import CodecConfig

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

T, H, W = 7, 24, 40
CHUNKS = {"1": 1, "3": 3, "all": T}
PRECODERS = {
    "none": {"delta": False},
    "delta": {},
    "delta2d": {"delta2d": True},
    "zero-init": {"zero_init": True},
    "delta2d-zero-init": {"delta2d": True, "zero_init": True},
}


def _frames(t=T, h=H, w=W, seed=0, pan=5):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(100 + 60 * np.sin((xx + pan * i) / 17.0) * np.cos(yy / 13.0)
                + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8)
        for i in range(t)])


def _color(t=T, h=H, w=W, seed=1):
    f = _frames(t, h, w, seed)
    return np.stack([f, np.roll(f, 3, 2), 255 - f], axis=-1)


def _u16(t=T, h=H, w=W, seed=2):
    return _frames(t, h, w, seed).astype(np.uint16) * 16 + np.arange(
        w, dtype=np.uint16) * 7


def _write(cls, frames, chunk, *args, **kw):
    """``frames`` pushed into ``cls(sink, *args, **kw)`` ``chunk`` at a
    time -> (file bytes, stats)."""
    sink = io.BytesIO()
    with cls(sink, *args, **kw) as enc:
        for a in range(0, len(frames), chunk):
            part = frames[a : a + chunk]
            enc.push(part[0] if chunk == 1 else part)
    return sink.getvalue(), enc.stats


def _pair(name, frames, chunk, cfg_kw, *args, **kw):
    """The port's file (pushed ``chunk`` at a time) and the JAX writer's
    (pushed whole), with their stats."""
    ours, stats = _write(getattr(tsw, name), frames, chunk, *args,
                         config=CodecConfig(**cfg_kw), **kw)
    theirs, jstats = _write(getattr(jsw, name), frames, len(frames), *args,
                            config=JaxConfig(backend="native", **cfg_kw),
                            **kw)
    assert ours == theirs
    assert (stats.total_frames, stats.num_segments, stats.bytes_written,
            stats.source_crc32) == (
        jstats.total_frames, jstats.num_segments, jstats.bytes_written,
        jstats.source_crc32)
    return ours, stats


@pytest.mark.parametrize("fcrc", [False, True], ids=["", "fcrc"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("pre", PRECODERS)
@pytest.mark.parametrize("bd", [4, 8, 16])
def test_gray_equals_the_jax_writer_and_the_batch_writer(bd, pre, chunk,
                                                         fcrc):
    frames = _frames(seed=bd)
    kw = {"block_dim": bd, **PRECODERS[pre]}
    blob, stats = _pair("StreamingEncoder", frames, CHUNKS[chunk], kw, H, W,
                        max_segment_frames=3, frame_crcs=fcrc)
    assert stats.num_segments == 3  # segments of 3, 3, 1
    # the port's batch writer at the same capacity
    cfg = CodecConfig(**kw)
    bh, bw = blocks.block_grid(H, W, bd)
    bits = 3 * bh * bw * cfg.block_size * frame_stream._SEG_BITS_PER_SYMBOL
    segs = frame_stream.encode_frames_segmented(frames, cfg,
                                                max_segment_bits=bits)
    assert blob == frame_stream.write_segmented(
        segs, H, W, cfg, source_crc32=zlib.crc32(frames.tobytes()),
        frame_crcs=frame_stream.compute_frame_crcs(frames) if fcrc else None)
    np.testing.assert_array_equal(decode_video(blob, "cpu"), frames)


@pytest.mark.parametrize("fcrc", [False, True], ids=["", "fcrc"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("kind", ["subgreen", "u16"])
def test_color_and_u16_equal_the_jax_writer(kind, chunk, fcrc):
    if kind == "u16":
        frames = _u16()
        blob, _ = _pair("ColorStreamingEncoder", frames, CHUNKS[chunk], {},
                        H, W, u16=True, max_segment_frames=2,
                        frame_crcs=fcrc)
        got = color.decode_gray16_from_bytes(blob, "cpu")
    else:
        frames = _color()
        blob, _ = _pair("ColorStreamingEncoder", frames, CHUNKS[chunk],
                        {"delta2d": True}, H, W, channels=3,
                        colorspace=color.CS_SUBGREEN, max_segment_frames=2,
                        frame_crcs=fcrc)
        got = color.decode_color_video_from_bytes(blob, "cpu")
    assert got.dtype == frames.dtype
    np.testing.assert_array_equal(got, frames)


@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("pre", ["none", "delta", "delta2d"])
def test_mhts_equals_the_jax_writer_and_write_stream(pre, chunk):
    frames = _frames(seed=3)
    blob, stats = _pair("MHTSStreamingEncoder", frames, CHUNKS[chunk],
                        PRECODERS[pre], H, W)
    assert stats.num_segments == T
    cfg = CodecConfig(**PRECODERS[pre])
    assert blob == frame_stream.write_stream(
        frame_stream.encode_frames(frames, cfg), H, W, cfg,
        source_crc32s=[zlib.crc32(f.tobytes()) for f in frames])
    streams, *_ = frame_stream.read_stream(blob)
    assert len(streams) == T


@pytest.mark.parametrize("fcrc", [False, True], ids=["", "fcrc"])
@pytest.mark.parametrize("chunk", CHUNKS)
@pytest.mark.parametrize("motion", [False, True], ids=["plain", "mc"])
def test_temporal_equals_the_jax_writer_and_the_trailer_wrap(motion, chunk,
                                                             fcrc):
    frames = _frames(seed=4)
    kw = {"temporal": True, "motion": motion, "keyint": 3}
    blob, _ = _pair("TemporalStreamingEncoder", frames, CHUNKS[chunk], kw, H,
                    W, max_segment_frames=3, frame_crcs=fcrc)
    # the batch residuals wrapped in the trailer layout
    cfg = CodecConfig(**kw)
    mvs = None
    if motion:
        res, mvs = temporal.temporal_encode_mc(frames, 3)
    else:
        res = temporal.temporal_encode(frames, 3)
    inner, _ = _write(tsw.StreamingEncoder, res, T, H, W,
                      temporal._inner_config(cfg), max_segment_frames=3)
    assert blob == temporal.wrap(
        inner, 3, source_crc32=zlib.crc32(frames.tobytes()), mvs=mvs,
        frame_crcs=frame_stream.compute_frame_crcs(frames) if fcrc else None,
        trailer=True)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(blob, "cpu"), frames)


@pytest.mark.parametrize("kind", ["color", "u16"])
def test_temporal_color_and_u16_equal_the_jax_writer(kind):
    frames = _color() if kind == "color" else _u16()
    kw = dict(channels=3, colorspace=color.CS_SUBGREEN) if kind == "color" \
        else dict(u16=True)
    blob, _ = _pair("TemporalStreamingEncoder", frames, 2,
                    {"temporal": True, "motion": True, "keyint": 4}, H, W,
                    max_segment_frames=3, frame_crcs=True, **kw)
    got = temporal.decode_temporal_video(blob, "cpu")
    assert got.dtype == frames.dtype
    np.testing.assert_array_equal(got, frames)


class _Unseekable(io.BytesIO):
    def seekable(self):
        return False


def _refusal(pkg, case):
    """Run refusal ``case`` on package ``pkg`` ("jax" or "torch") -> the
    exception it raised."""
    sw = jsw if pkg == "jax" else tsw

    def cfg(**kw):
        return (JaxConfig(backend="native", **kw) if pkg == "jax"
                else CodecConfig(**kw))

    with pytest.raises(Exception) as e:
        if case == "temporal-config":
            sw.StreamingEncoder(io.BytesIO(), H, W, cfg(temporal=True))
        elif case == "mhts-temporal-config":
            sw.MHTSStreamingEncoder(io.BytesIO(), H, W, cfg(temporal=True))
        elif case == "zero-init-without-delta":
            sw.StreamingEncoder(io.BytesIO(), H, W,
                                cfg(delta=False, zero_init=True))
        elif case == "geometry":
            enc = sw.StreamingEncoder(io.BytesIO(), H, W, cfg())
            enc.push(np.zeros((2, H, W + 8), np.uint8))
        elif case == "dtype":
            enc = sw.TemporalStreamingEncoder(io.BytesIO(), H, W,
                                              cfg(temporal=True))
            enc.push(np.zeros((2, H, W), np.uint16))
        elif case == "unseekable":
            sw.StreamingEncoder(_Unseekable(), H, W, cfg())
        elif case == "unseekable-temporal":
            sw.TemporalStreamingEncoder(_Unseekable(), H, W,
                                        cfg(temporal=True))
        elif case == "empty-close":
            sw.StreamingEncoder(io.BytesIO(), H, W, cfg()).close()
        elif case == "empty-close-mhts":
            sw.MHTSStreamingEncoder(io.BytesIO(), H, W, cfg()).close()
        elif case == "push-after-close":
            enc = sw.StreamingEncoder(io.BytesIO(), H, W, cfg())
            enc.push(_frames(1))
            enc.close()
            enc.push(_frames(1))
        elif case == "u16-channels":
            sw.ColorStreamingEncoder(io.BytesIO(), H, W, channels=3,
                                     u16=True)
        elif case == "subgreen-two-channels":
            sw.ColorStreamingEncoder(io.BytesIO(), H, W, channels=2,
                                     colorspace=color.CS_SUBGREEN)
        elif case == "segment-frames":
            sw.StreamingEncoder(io.BytesIO(), H, W, cfg(),
                                max_segment_frames=0)
    return e.value


REFUSALS = ["temporal-config", "mhts-temporal-config",
            "zero-init-without-delta", "geometry", "dtype", "unseekable",
            "unseekable-temporal", "empty-close", "empty-close-mhts",
            "push-after-close", "u16-channels", "subgreen-two-channels",
            "segment-frames"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_what_the_jax_writers_raise(case):
    ours, theirs = _refusal("torch", case), _refusal("jax", case)
    assert type(ours) is type(theirs) is ValueError
    assert str(ours) == str(theirs)


def test_failed_close_truncates_the_sink_and_close_again_raises():
    sink = io.BytesIO()
    enc = tsw.StreamingEncoder(sink, H, W, CodecConfig())
    with pytest.raises(ValueError, match="empty"):
        enc.close()
    assert sink.getvalue() == b""
    with pytest.raises(ValueError, match="failed close"):
        enc.close()


def test_push_failure_truncates_the_sink(monkeypatch, tmp_path):
    path = tmp_path / "cap.mhv2"

    def boom(*a, **k):
        raise OSError("disk full")

    enc = tsw.StreamingEncoder(path, H, W, CodecConfig(),
                               max_segment_frames=2)
    enc.push(_frames(2))  # one segment on disk
    monkeypatch.setattr(frame_stream, "encode_frames_shared", boom)
    with pytest.raises(OSError, match="disk full"):
        enc.push(_frames(2))
    assert path.read_bytes() == b""  # no torn container
    with pytest.raises(ValueError, match="after close"):
        enc.push(_frames(1))


def test_segment_capacity_and_single_segment_mhv2():
    frames = _frames(3)
    enc = tsw.StreamingEncoder(io.BytesIO(), H, W, CodecConfig())
    bh, bw = blocks.block_grid(H, W, 8)
    assert enc.segment_frames == ((1 << 32) - 1024) // (
        bh * bw * 64 * frame_stream._SEG_BITS_PER_SYMBOL)
    blob, stats = _write(tsw.StreamingEncoder, frames, 3, H, W)
    assert blob[:4] == frame_stream.SEGMENTED_MAGIC
    assert stats.num_segments == 1
    np.testing.assert_array_equal(decode_video(blob, "cpu"), frames)
