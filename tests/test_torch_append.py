"""In-place append (capture resume) of the port's streaming writers, held to
the contracts of ``tests/test_append.py`` and to the JAX package's bytes.

- A boundary-aligned append equals the one-shot capture (MHV2, MHVT with
  and without motion, a short first keyframe group, MHTS, color and u16
  MHVT), and every append equals the JAX package's append of the same
  frames, byte for byte.
- A failed append restores the original file, and re-raises what failed:
  a decode error on the device included (there is no fallback).
- A mode, delta-ness, keyint, motion or kind mismatch is refused before
  any work, with the JAX writers' messages.
- A file that records no CRC stays unrecorded.
- A seeded bit-flip fuzz: the port and the JAX package both refuse the
  flipped file (which stays untouched) or both write the same bytes.

The temporal append decodes its open keyframe group with
``device="cpu"`` (the kernels' plain versions); the JAX side runs its host
decoder. No Pallas kernel is compiled.
"""

import io
import struct
import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import stream_writer as jsw
from metalhuffman_tpu.models import surgery as jsurgery
from metalhuffman_tpu_torch import decode_video, encode_video
from metalhuffman_tpu_torch.models import (color, frame_stream, surgery,
                                           temporal)
from metalhuffman_tpu_torch.models import stream_writer as tsw
from metalhuffman_tpu_torch.models.config import CodecConfig

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

CPU = {"device": "cpu"}


def _frames(t, h, w, seed=0, pan=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(100 + 60 * np.sin((xx + pan * i) / 13.0)
                * np.cos(yy / 11.0) + rng.normal(0, 2, (h, w)),
                0, 255).astype(np.uint8)
        for i in range(t)])


def _jcfg(cfg: CodecConfig) -> JaxConfig:
    """The JAX package's config of the port's ``cfg``."""
    return JaxConfig(backend="native", block_dim=cfg.block_dim,
                     delta=cfg.delta, zero_init=cfg.zero_init,
                     delta2d=cfg.delta2d, frame_crcs=cfg.frame_crcs,
                     temporal=cfg.temporal, keyint=cfg.keyint,
                     motion=cfg.motion)


def _capture(path, name, parts, h, w, cfg, **kw):
    """The port's writer ``name``: ``parts[0]`` as a fresh capture into
    ``path``, each later part appended in place; -> the file's bytes."""
    cls = getattr(tsw, name)
    for i, part in enumerate(parts):
        extra = CPU if i and name == "TemporalStreamingEncoder" else {}
        with cls(path, h, w, config=cfg, append=bool(i), **extra,
                 **(kw if not i else {k: v for k, v in kw.items()
                                      if k != "frame_crcs"})) as enc:
            enc.push(part)
    return path.read_bytes()


def _jax_capture(path, name, parts, h, w, cfg, **kw):
    """:func:`_capture` with the JAX package's writer."""
    cls = getattr(jsw, name)
    for i, part in enumerate(parts):
        with cls(path, h, w, config=_jcfg(cfg), append=bool(i),
                 **(kw if not i else {k: v for k, v in kw.items()
                                      if k != "frame_crcs"})) as enc:
            enc.push(part)
    return path.read_bytes()


def _both(tmp_path, name, parts, h, w, cfg, **kw):
    """The port's append, held equal to the JAX package's -> its bytes."""
    ours = _capture(tmp_path / "ours.bin", name, parts, h, w, cfg, **kw)
    theirs = _jax_capture(tmp_path / "theirs.bin", name, parts, h, w, cfg,
                          **kw)
    assert ours == theirs
    return ours


class Boom(Exception):
    pass


def test_mhv2_append_equals_concat_oneshot_and_the_jax_append(tmp_path):
    f = _frames(11, 24, 32, seed=1)
    cfg = CodecConfig()
    kw = dict(max_segment_frames=3, frame_crcs=True)
    got = _both(tmp_path, "StreamingEncoder", [f[:6], f[6:]], 24, 32, cfg,
                **kw)
    first = _capture(tmp_path / "a.bin", "StreamingEncoder", [f[:6]], 24,
                     32, cfg, **kw)
    second = _capture(tmp_path / "b.bin", "StreamingEncoder", [f[6:]], 24,
                      32, cfg, **kw)
    assert got == surgery.concat_videos([first, second])
    assert got == _capture(tmp_path / "one.bin", "StreamingEncoder", [f],
                           24, 32, cfg, **kw)  # 6 % 3 == 0: one-shot
    assert frame_stream.source_crc32(got) == zlib.crc32(f.tobytes())
    np.testing.assert_array_equal(frame_stream.read_frame_crcs(got),
                                  frame_stream.compute_frame_crcs(f))
    np.testing.assert_array_equal(decode_video(got, "cpu"), f)
    # the stats count the whole stream
    p = tmp_path / "ours.bin"
    with tsw.StreamingEncoder(p, 24, 32, cfg, max_segment_frames=3,
                              append=True) as enc:
        enc.push(f[:1])
    assert enc.stats.total_frames == 12


def test_append_failure_restores_the_original(tmp_path):
    f = _frames(5, 16, 16, seed=3)
    p = tmp_path / "cap.mhv2"
    orig = _capture(p, "StreamingEncoder", [f], 16, 16, CodecConfig(),
                    max_segment_frames=2)
    with pytest.raises(Boom):
        with tsw.StreamingEncoder(p, 16, 16, CodecConfig(),
                                  max_segment_frames=2, append=True) as enc:
            enc.push(f[:3])  # a full segment lands on disk
            raise Boom()
    assert p.read_bytes() == orig
    # the restored file still appends cleanly
    with tsw.StreamingEncoder(p, 16, 16, CodecConfig(),
                              max_segment_frames=2, append=True) as enc:
        enc.push(f[:2])
    np.testing.assert_array_equal(decode_video(p.read_bytes(), "cpu"),
                                  np.concatenate([f, f[:2]]))


def _refused(tmp_path, make, blob: bytes):
    """``make(path)`` on a copy of ``blob`` must raise ValueError and leave
    the file as it was -> the message."""
    p = tmp_path / "refused.bin"
    p.write_bytes(blob)
    with pytest.raises(ValueError) as e:
        make(p)
    assert p.read_bytes() == blob
    return str(e.value)


def _pair_refusal(tmp_path, blob, make):
    """``make(sw, cfg_of, path, dev)`` with each package's writers (``dev``:
    the port's temporal append decodes on the CPU): both must refuse with
    the same message and leave the file as it was."""
    ours = _refused(tmp_path, lambda p: make(tsw, lambda c: c, p, CPU), blob)
    theirs = _refused(tmp_path, lambda p: make(jsw, _jcfg, p, {}), blob)
    assert ours == theirs
    return ours


def test_append_refusals(tmp_path):
    f = _frames(3, 16, 16, seed=5)
    cfg = CodecConfig()
    blob = _capture(tmp_path / "cap.mhv2", "StreamingEncoder", [f], 16, 16,
                    cfg)
    assert "16x16" in _pair_refusal(tmp_path, blob, lambda sw, c, p, d:
                                    sw.StreamingEncoder(p, 24, 24, c(cfg),
                                                        append=True))
    assert "mid-stream" in _pair_refusal(
        tmp_path, blob, lambda sw, c, p, d: sw.StreamingEncoder(
            p, 16, 16, c(cfg), append=True, frame_crcs=True))
    assert "coding mode" in _pair_refusal(
        tmp_path, blob, lambda sw, c, p, d: sw.StreamingEncoder(
            p, 16, 16, c(CodecConfig(delta2d=True)), append=True))
    assert "block_dim" in _pair_refusal(
        tmp_path, blob, lambda sw, c, p, d: sw.StreamingEncoder(
            p, 16, 16, c(CodecConfig(block_dim=4)), append=True))
    # an MHTV is refused with the way out
    assert "resegment" in _pair_refusal(
        tmp_path, encode_video(f), lambda sw, c, p, d: sw.StreamingEncoder(
            p, 16, 16, c(cfg), append=True))


def test_unrecorded_crc_stays_unrecorded(tmp_path):
    f = _frames(4, 16, 16, seed=7)
    p = tmp_path / "cap.mhv2"
    data = bytearray(_capture(p, "StreamingEncoder", [f[:2]], 16, 16,
                              CodecConfig(), max_segment_frames=2))
    struct.pack_into("<I", data, frame_stream._trailer_offset(bytes(data)),
                     0)  # blank the recorded CRC
    p.write_bytes(bytes(data))
    with tsw.StreamingEncoder(p, 16, 16, CodecConfig(), max_segment_frames=2,
                              append=True) as enc:
        enc.push(f[2:])
    assert enc.stats.source_crc32 == 0
    assert frame_stream.source_crc32(p.read_bytes()) == 0
    out, _h, _w = frame_stream.decode_range(p.read_bytes(), 0, 4,
                                            device="cpu")
    np.testing.assert_array_equal(out, f)


@pytest.mark.parametrize("split", [6, 7], ids=["aligned", "mid-group"])
@pytest.mark.parametrize("motion", [False, True], ids=["plain", "mc"])
def test_temporal_append_equals_the_oneshot_and_the_jax_append(
        motion, split, tmp_path):
    cfg = CodecConfig(temporal=True, motion=motion, keyint=4)
    f = _frames(12, 24, 32, seed=9, pan=5)
    kw = dict(max_segment_frames=3, frame_crcs=True)
    got = _both(tmp_path, "TemporalStreamingEncoder", [f[:split], f[split:]],
                24, 32, cfg, **kw)
    if split % 3 == 0:  # the first part ends on a segment boundary
        assert got == _capture(tmp_path / "one.bin",
                               "TemporalStreamingEncoder", [f], 24, 32,
                               cfg, **kw)
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(got, "cpu"), f)


def test_temporal_append_failure_and_refusals(tmp_path):
    cfg = CodecConfig(temporal=True, motion=True, keyint=4)
    f = _frames(12, 24, 32, seed=9, pan=5)
    p = tmp_path / "cap.mhvt"
    got = _capture(p, "TemporalStreamingEncoder", [f[:6], f[6:]], 24, 32,
                   cfg, max_segment_frames=3, frame_crcs=True)
    # a failed temporal append restores everything (outer header, inner
    # header and trailer, tables)
    with pytest.raises(Boom):
        with tsw.TemporalStreamingEncoder(p, 24, 32, cfg,
                                          max_segment_frames=3,
                                          append=True, device="cpu") as enc:
            enc.push(f[:6])
            raise Boom()
    assert p.read_bytes() == got
    for bad, word in ((CodecConfig(temporal=True, keyint=4), "motion"),
                      (CodecConfig(temporal=True, motion=True, keyint=5),
                       "keyint"),
                      (CodecConfig(temporal=True, motion=True, keyint=4,
                                   delta=False), "coding mode")):
        assert word in _pair_refusal(
            tmp_path, got, lambda sw, c, q, d, bad=bad:
            sw.TemporalStreamingEncoder(q, 24, 32, c(bad), append=True, **d))
    # the header layout is refused with the way out
    assert "trailer" in _pair_refusal(
        tmp_path, temporal.encode_temporal_video(f[:6], cfg),
        lambda sw, c, q, d: sw.TemporalStreamingEncoder(q, 24, 32, c(cfg),
                                                     append=True, **d))


def test_temporal_append_continues_a_short_first_group(tmp_path):
    cfg = CodecConfig(temporal=True, keyint=4)
    f = _frames(10, 16, 16, seed=11)
    ext = surgery.extract_video(temporal.encode_temporal_video(f, cfg), 2,
                                10, device="cpu")  # first_len 2
    inner, keyint, crc, mvs, fcrcs, fl = temporal.unwrap(ext)
    assert fl == 2
    blob = temporal.wrap(surgery.resegment_video(inner, 3), keyint, crc,
                         mvs=mvs, frame_crcs=fcrcs, first_len=fl,
                         trailer=True)
    extra = _frames(5, 16, 16, seed=12)
    outs = []
    for sw, c, kw in ((tsw, cfg, CPU), (jsw, _jcfg(cfg), {})):
        p = tmp_path / f"{sw.__name__}.mhvt"
        p.write_bytes(blob)
        with sw.TemporalStreamingEncoder(p, 16, 16, c, max_segment_frames=3,
                                         append=True, **kw) as enc:
            enc.push(extra)
        outs.append(p.read_bytes())
    assert outs[0] == outs[1]
    np.testing.assert_array_equal(
        temporal.decode_temporal_video(outs[0], "cpu"),
        np.concatenate([f[2:], extra]))


def test_mhts_append_is_always_the_oneshot(tmp_path):
    f = _frames(7, 16, 24, seed=13)
    p = tmp_path / "cap.mhts"
    got = _both(tmp_path, "MHTSStreamingEncoder", [f[:3], f[3:]], 16, 24,
                CodecConfig())
    assert got == _capture(tmp_path / "one.mhts", "MHTSStreamingEncoder",
                           [f], 16, 24, CodecConfig())
    p.write_bytes(got)
    # records are self-contained: another predictor may follow
    with tsw.MHTSStreamingEncoder(p, 16, 24, CodecConfig(delta2d=True),
                                  append=True) as enc:
        enc.push(f[:2])
    outs = [fr for _i, fr, _e, _c in frame_stream.iter_stream_frames(
        p.read_bytes(), device="cpu")]
    np.testing.assert_array_equal(np.stack(outs), np.concatenate([f, f[:2]]))
    before = p.read_bytes()
    with pytest.raises(Boom):
        with tsw.MHTSStreamingEncoder(p, 16, 24, CodecConfig(),
                                      append=True) as enc:
            enc.push(f[:1])
            raise Boom()
    assert p.read_bytes() == before
    assert "delta-ness" in _pair_refusal(
        tmp_path, before, lambda sw, c, q, d: sw.MHTSStreamingEncoder(
            q, 16, 24, c(CodecConfig(delta=False)), append=True))
    # a cut last record is refused, never zero-extended
    assert "truncated" in _pair_refusal(
        tmp_path, before[:-10], lambda sw, c, q, d: sw.MHTSStreamingEncoder(
            q, 16, 24, c(CodecConfig()), append=True))


def test_color_append_equals_concat_and_the_jax_append(tmp_path):
    rng = np.random.default_rng(15)
    col = rng.integers(0, 200, (9, 24, 24, 3)).astype(np.uint8)
    kw = dict(channels=3, max_segment_frames=2, frame_crcs=True)
    got = _both(tmp_path, "ColorStreamingEncoder", [col[:5], col[5:]], 24,
                24, CodecConfig(), **kw)
    first = _capture(tmp_path / "a.bin", "ColorStreamingEncoder", [col[:5]],
                     24, 24, CodecConfig(), **kw)
    second = _capture(tmp_path / "b.bin", "ColorStreamingEncoder",
                      [col[5:]], 24, 24, CodecConfig(), **kw)
    assert got == surgery.concat_videos([first, second])
    np.testing.assert_array_equal(
        color.decode_color_video_from_bytes(got, "cpu"), col)
    assert "disagree" in _pair_refusal(
        tmp_path, got, lambda sw, c, p, d: sw.ColorStreamingEncoder(
            p, 24, 24, channels=3, config=c(CodecConfig()),
            colorspace=color.CS_SUBGREEN, append=True))


@pytest.mark.parametrize("kind", ["color", "u16"])
def test_temporal_color_and_u16_append_equal_the_oneshot(kind, tmp_path):
    rng = np.random.default_rng(35)
    if kind == "color":
        frames = (rng.integers(0, 40, (12, 24, 24, 3))
                  + np.arange(12)[:, None, None, None] * 2).astype(np.uint8)
        cfg = CodecConfig(temporal=True, keyint=3)
        kw = dict(channels=3, colorspace=color.CS_SUBGREEN,
                  max_segment_frames=3, frame_crcs=True)
        split = 6
    else:
        frames = rng.integers(0, 3000, (10, 24, 24)).astype(np.uint16)
        cfg = CodecConfig(temporal=True, motion=True, keyint=4)
        kw = dict(u16=True, max_segment_frames=2, frame_crcs=True)
        split = 6
    got = _both(tmp_path, "TemporalStreamingEncoder",
                [frames[:split], frames[split:]], 24, 24, cfg, **kw)
    assert got == _capture(tmp_path / "one.bin", "TemporalStreamingEncoder",
                           [frames], 24, 24, cfg, **kw)
    out = temporal.decode_temporal_video(got, "cpu")
    assert out.dtype == frames.dtype
    np.testing.assert_array_equal(out, frames)


def test_temporal_append_kind_and_header_mismatches(tmp_path):
    rng = np.random.default_rng(41)
    col = rng.integers(0, 60, (4, 16, 16, 3)).astype(np.uint8)
    cfg = CodecConfig(temporal=True, keyint=2)
    blob = _capture(tmp_path / "c.mhvt", "TemporalStreamingEncoder", [col],
                    16, 16, cfg, channels=3, max_segment_frames=2)
    for kw in (dict(channels=4), dict(channels=3,
                                      colorspace=color.CS_SUBGREEN)):
        assert "disagree" in _pair_refusal(
            tmp_path, blob, lambda sw, c, p, d, kw=kw:
            sw.TemporalStreamingEncoder(p, 16, 16, c(cfg), append=True,
                                        **d, **kw))
    assert "MHTC" in _pair_refusal(
        tmp_path, blob, lambda sw, c, p, d: sw.TemporalStreamingEncoder(
            p, 16, 16, c(cfg), append=True, **d))
    gray = _capture(tmp_path / "g.mhvt", "TemporalStreamingEncoder",
                    [_frames(4, 16, 16, seed=37)], 16, 16, cfg)
    assert "grayscale" in _pair_refusal(
        tmp_path, gray, lambda sw, c, p, d: sw.TemporalStreamingEncoder(
            p, 16, 16, c(cfg), channels=3, append=True, **d))


def test_temporal_append_abort_poisons_a_color_inner():
    cfg = CodecConfig(temporal=True, keyint=2)
    col = np.random.default_rng(43).integers(0, 60, (4, 16, 16, 3)).astype(
        np.uint8)
    buf = io.BytesIO()
    with tsw.TemporalStreamingEncoder(buf, 16, 16, cfg, channels=3,
                                      max_segment_frames=1) as enc:
        enc.push(col)
    good = buf.getvalue()
    buf.seek(0)
    enc = tsw.TemporalStreamingEncoder(buf, 16, 16, cfg, channels=3,
                                       max_segment_frames=1, append=True,
                                       device="cpu")
    enc.abort()
    with pytest.raises(ValueError, match="close"):
        enc.push(col[:1])
    assert buf.getvalue() == good


def test_temporal_append_corrupt_tables_fail_before_the_decode(
        tmp_path, monkeypatch):
    cfg = CodecConfig(temporal=True, keyint=4)
    f = _frames(6, 16, 16, seed=47)
    data = bytearray(_capture(tmp_path / "cap.mhvt",
                              "TemporalStreamingEncoder", [f], 16, 16, cfg,
                              max_segment_frames=3, frame_crcs=True))
    (inner_len,) = struct.unpack_from("<Q", data, 12)
    fc_at = 20 + inner_len  # the FCRC count: no motion table before it
    assert struct.unpack_from("<I", data, fc_at) == (6,)
    struct.pack_into("<I", data, fc_at, 5)

    def no_decode(*a, **k):
        raise AssertionError("decoded before validating")

    monkeypatch.setattr(frame_stream, "decode_range", no_decode)
    msg = _pair_refusal(tmp_path, bytes(data), lambda sw, c, p, d:
                        sw.TemporalStreamingEncoder(p, 16, 16, c(cfg),
                                                    append=True, **d))
    assert "frame CRC table" in msg


def test_temporal_append_reraises_a_device_error_after_restoring(
        tmp_path, monkeypatch):
    cfg = CodecConfig(temporal=True, motion=True, keyint=4)
    f = _frames(7, 16, 16, seed=49, pan=3)
    p = tmp_path / "cap.mhvt"
    orig = _capture(p, "TemporalStreamingEncoder", [f], 16, 16, cfg,
                    max_segment_frames=3, frame_crcs=True)
    seen = []

    def failing_decode(*a, device, **k):
        seen.append(device)
        raise RuntimeError("CUDA error: an illegal memory access was "
                           "encountered")

    monkeypatch.setattr(frame_stream, "decode_range", failing_decode)
    with pytest.raises(RuntimeError, match="illegal memory access"):
        tsw.TemporalStreamingEncoder(p, 16, 16, cfg, append=True,
                                     device="cuda:0")
    assert seen == ["cuda:0"]
    assert p.read_bytes() == orig


def test_temporal_append_decodes_on_cuda_by_default(tmp_path, monkeypatch):
    cfg = CodecConfig(temporal=True, keyint=4)
    f = _frames(6, 16, 16, seed=51)
    p = tmp_path / "cap.mhvt"
    orig = _capture(p, "TemporalStreamingEncoder", [f], 16, 16, cfg,
                    max_segment_frames=3)

    def no_cuda():
        raise RuntimeError("no CUDA device here")

    # a CPU build raises at CUDA's lazy init too; this makes a CUDA build
    # of torch raise the same way, so no plain version may run instead
    monkeypatch.setattr(torch.cuda, "_lazy_init", no_cuda)
    with pytest.raises((RuntimeError, AssertionError)):
        tsw.TemporalStreamingEncoder(p, 16, 16, cfg, append=True)
    assert p.read_bytes() == orig


def test_append_bitflip_fuzz_matches_the_jax_package(tmp_path):
    f = _frames(5, 16, 16, seed=31)
    good = _capture(tmp_path / "cap.mhv2", "StreamingEncoder", [f], 16, 16,
                    CodecConfig(), max_segment_frames=2, frame_crcs=True)
    rng = np.random.default_rng(33)
    outcomes = set()
    # 30 flips anywhere, 20 in the header, the first segment's header and
    # the trailers, where the append's walk reads
    spots = np.concatenate([rng.integers(0, len(good), 30),
                            rng.integers(0, 34, 10),
                            rng.integers(len(good) - 40, len(good), 10)])
    for pos in spots.tolist():
        data = bytearray(good)
        data[pos] ^= 1 << int(rng.integers(0, 8))
        results = []
        for sw, cfg in ((tsw, CodecConfig()),
                        (jsw, JaxConfig(backend="native"))):
            q = tmp_path / f"mut_{sw.__name__}.mhv2"
            q.write_bytes(bytes(data))
            try:
                with sw.StreamingEncoder(q, 16, 16, cfg,
                                         max_segment_frames=2,
                                         append=True) as enc:
                    enc.push(f[:1])
            except ValueError as e:
                assert q.read_bytes() == bytes(data), f"torn at byte {pos}"
                results.append(("refused", str(e)))
            else:
                results.append(("wrote", q.read_bytes()))
        assert results[0] == results[1], f"flip at byte {pos}"
        outcomes.add(results[0][0])
    assert outcomes == {"refused", "wrote"}


def test_jax_surgery_reads_the_ports_append(tmp_path):
    # the appended file is an ordinary container to the JAX package too
    cfg = CodecConfig(temporal=True, keyint=3)
    f = _frames(9, 16, 16, seed=53, pan=2)
    got = _capture(tmp_path / "cap.mhvt", "TemporalStreamingEncoder",
                   [f[:4], f[4:]], 16, 16, cfg, max_segment_frames=2,
                   frame_crcs=True)
    assert jsurgery.extract_video(got, 3, 8) == surgery.extract_video(
        got, 3, 8, device="cpu")
