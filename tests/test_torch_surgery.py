"""The port's container surgery (``metalhuffman_tpu_torch.models.surgery``)
against the JAX package's, byte for byte.

``extract_video``, ``concat_videos``, ``resegment_video`` and the
constant-memory file-to-file forms ``concat_videos_streamed`` and
``resegment_video_streamed`` run on MHTV, MHV2, MHTS, MHTC (color and u16)
and MHVT (with and without motion, the header and the trailer layout, a
short first keyframe group): keyframe and mid-group starts, an extract of an
extract, zero-init and no delta. Each output equals the JAX surgery's bytes
(and ``info``), and decodes on the CPU to its source frames; each refusal
raises the JAX surgery's exception with its message. An MHVT mid-group start
decodes with ``device="cpu"`` (the kernels' plain versions); the JAX side
runs its host decoder, so no Pallas kernel is compiled.
"""

import io

import numpy as np
import pytest
import torch

from metalhuffman_tpu.models import surgery as jsu
from metalhuffman_tpu_torch import decode_video, encode_video
from metalhuffman_tpu_torch.models import color, frame_stream, temporal
from metalhuffman_tpu_torch.models import surgery as tsu
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.models.stream_writer import (
    StreamingEncoder, TemporalStreamingEncoder)

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

T, H, W = 11, 24, 40


def _frames(t=T, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    return np.stack([
        np.clip(100 + 60 * np.sin((xx + 4 * i) / 9.0)
                * np.cos((yy + 2 * i) / 7.0) + rng.normal(0, 3, (h, w)),
                0, 255).astype(np.uint8) for i in range(t)])


def _streamed(frames, cfg, per, cls=StreamingEncoder):
    sink = io.BytesIO()
    with cls(sink, H, W, cfg, max_segment_frames=per,
             frame_crcs=cfg.frame_crcs) as enc:
        enc.push(frames)
    return sink.getvalue()


GRAY = _frames()
RGB = np.stack([GRAY, np.roll(GRAY, 3, 2), 255 - GRAY], axis=-1)
U16 = GRAY.astype(np.uint16) * 16 + np.arange(W, dtype=np.uint16) * 5


def _containers():
    """name -> (blob, source frames)."""
    fc = CodecConfig(frame_crcs=True)
    out = {
        "mhtv": (encode_video(GRAY), GRAY),
        "mhtv-fcrc": (encode_video(GRAY, fc), GRAY),
        "mhtv-zero-init": (encode_video(GRAY, CodecConfig(
            zero_init=True, frame_crcs=True)), GRAY),
        "mhtv-no-delta": (encode_video(GRAY, CodecConfig(delta=False)),
                          GRAY),
        "mhv2": (_streamed(GRAY, fc, 3), GRAY),
        "mhv2-delta2d-zero-init": (_streamed(GRAY, CodecConfig(
            delta2d=True, zero_init=True), 4), GRAY),
        "mhts": (frame_stream.write_stream(
            frame_stream.encode_frames(GRAY), H, W), GRAY),
        "mhtc": (color.encode_color_video_to_bytes(
            RGB, fc, colorspace=color.CS_SUBGREEN), RGB),
        "mhtc-u16": (color.encode_gray16_to_bytes(U16), U16),
        "mhvt": (encode_video(GRAY, CodecConfig(
            temporal=True, keyint=4, frame_crcs=True)), GRAY),
        "mhvt-mc": (encode_video(GRAY, CodecConfig(
            temporal=True, keyint=4, motion=True, frame_crcs=True)), GRAY),
        "mhvt-streamed": (_streamed(GRAY, CodecConfig(
            temporal=True, keyint=3, motion=True, frame_crcs=True), 2,
            TemporalStreamingEncoder), GRAY),
        "mhvt-color": (temporal.encode_temporal_color_video(
            RGB, CodecConfig(temporal=True, keyint=4),
            colorspace=color.CS_SUBGREEN), RGB),
        "mhvt-u16": (temporal.encode_temporal_gray16_video(
            U16, CodecConfig(temporal=True, keyint=4, motion=True,
                             frame_crcs=True)), U16),
    }
    # a short first keyframe group (FLAG_FIRST_LEN): frames 2.. of mhvt
    out["mhvt-first-len"] = (jsu.extract_video(out["mhvt"][0], 2, T),
                             GRAY[2:])
    return out


C = _containers()


def _decode(blob: bytes):
    """Any video container of this file -> its frames, on the CPU."""
    if blob[:4] == frame_stream.STREAM_MAGIC:
        return frame_stream.decode_range(
            blob, 0, frame_stream.stream_frame_count(blob), device="cpu")[0]
    if blob[:4] == color.COLOR_MAGIC:
        if color.unwrap(blob)[3] == color.KIND_U16:
            return color.decode_gray16_from_bytes(blob, "cpu")
        return color.decode_color_video_from_bytes(blob, "cpu")
    return decode_video(blob, "cpu")


def _same_frames(got, want):
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


EXTRACTS = [
    ("mhtv", 0, T), ("mhtv", 2, 7), ("mhtv-fcrc", 10, 11),
    ("mhtv-fcrc", 1, 9), ("mhtv-zero-init", 3, 8), ("mhtv-no-delta", 4, 10),
    ("mhv2", 2, 8), ("mhv2", 3, 6), ("mhv2", 0, 1),
    ("mhv2-delta2d-zero-init", 1, 10), ("mhts", 2, 9), ("mhts", 0, T),
    ("mhtc", 1, 6), ("mhtc-u16", 4, 11),
    ("mhvt", 0, T), ("mhvt", 4, 10), ("mhvt", 3, 9), ("mhvt", 5, 7),
    ("mhvt", 1, 3), ("mhvt-mc", 8, 11), ("mhvt-mc", 2, 11),
    ("mhvt-mc", 6, 7), ("mhvt-streamed", 3, 9), ("mhvt-streamed", 4, 11),
    ("mhvt-color", 5, 10), ("mhvt-u16", 1, 6), ("mhvt-u16", 4, 8),
    ("mhvt-first-len", 0, 9), ("mhvt-first-len", 1, 5),
    ("mhvt-first-len", 2, 9), ("mhvt-first-len", 3, 8),
]


@pytest.mark.parametrize("name,a,b", EXTRACTS,
                         ids=[f"{n}-{a}-{b}" for n, a, b in EXTRACTS])
def test_extract_equals_the_jax_surgery(name, a, b):
    blob, src = C[name]
    ours, theirs = {}, {}
    out = tsu.extract_video(blob, a, b, ours, device="cpu")
    assert out == jsu.extract_video(blob, a, b, theirs)
    assert ours == theirs
    _same_frames(_decode(out), src[a:b])


def test_a_mid_group_start_rekeys_only_its_group():
    out, info = {}, {}
    mis = tsu.extract_video(C["mhvt"][0], 3, 11, info, device="cpu")
    assert info == {"reencoded_frames": 1}
    assert temporal.unwrap(mis)[5] == 1  # FLAG_FIRST_LEN: a group of 1
    ali = tsu.extract_video(C["mhvt"][0], 4, 11, out, device="cpu")
    assert out == {"reencoded_frames": 0}
    segs, *_ = frame_stream.read_segmented(temporal.unwrap(mis)[0])
    stream, t, *_ = frame_stream.read_shared(temporal.unwrap(ali)[0])
    assert [ft for _, ft in segs] == [1, t]
    np.testing.assert_array_equal(segs[1][0].code_bytes, stream.code_bytes)


@pytest.mark.parametrize("name", ["mhvt", "mhvt-mc", "mhvt-first-len"])
def test_extract_of_an_extract(name):
    blob, src = C[name]
    once = tsu.extract_video(blob, 1, len(src), device="cpu")
    twice = tsu.extract_video(once, 2, len(src) - 2, device="cpu")
    assert twice == jsu.extract_video(jsu.extract_video(blob, 1, len(src)),
                                      2, len(src) - 2)
    _same_frames(_decode(twice), src[3 : len(src) - 1])


CONCATS = {
    "mhtv+mhv2": (["mhtv-fcrc", "mhv2"], None),
    "mhv2+mhtv-no-crc": (["mhv2", "mhtv"], None),
    "one-input": (["mhv2"], None),
    "mhts+mhts": (["mhts", "mhts"], None),
    "mhtc+mhtc": (["mhtc", "mhtc"], None),
    "mhvt-whole-groups+mhvt": (["mhvt", "mhvt"], (0, 8)),
    "mhvt-first-len-lead": (["mhvt-first-len", "mhvt"], (0, 6)),
    "mhvt-mc": (["mhvt-mc", "mhvt-mc"], (4, 8)),
}


@pytest.mark.parametrize("case", CONCATS)
def test_concat_equals_the_jax_surgery(case):
    names, cut = CONCATS[case]
    blobs = [C[n][0] for n in names]
    srcs = [C[n][1] for n in names]
    if cut:  # the first input cut to whole keyframe groups
        blobs[0] = jsu.extract_video(blobs[0], *cut)
        srcs[0] = srcs[0][cut[0] : cut[1]]
    out = tsu.concat_videos(blobs)
    assert out == jsu.concat_videos(blobs)
    _same_frames(_decode(out), np.concatenate(srcs))


RESEGMENTS = ["mhtv-fcrc", "mhtv-zero-init", "mhv2", "mhtc", "mhtc-u16",
              "mhvt", "mhvt-streamed", "mhvt-first-len"]


@pytest.mark.parametrize("n", [1, 4])
@pytest.mark.parametrize("name", RESEGMENTS)
def test_resegment_equals_the_jax_surgery(name, n):
    blob, src = C[name]
    out = tsu.resegment_video(blob, n)
    assert out == jsu.resegment_video(blob, n)
    _same_frames(_decode(out), src)


STREAMED = ["mhtv-fcrc", "mhtv-zero-init", "mhv2", "mhv2-delta2d-zero-init",
            "mhtc", "mhtc-u16"]


@pytest.mark.parametrize("name", STREAMED)
def test_streamed_forms_equal_the_in_memory_and_the_jax_ones(name,
                                                             tmp_path):
    blob, src = C[name]
    inp = tmp_path / "in.bin"
    inp.write_bytes(blob)
    for n in (2, 5):
        ours, theirs = tmp_path / "o.bin", tmp_path / "j.bin"
        info = tsu.resegment_video_streamed(inp, ours, n)
        assert info == jsu.resegment_video_streamed(inp, theirs, n)
        assert ours.read_bytes() == theirs.read_bytes() == \
            tsu.resegment_video(blob, n)
    _same_frames(_decode(ours.read_bytes()), src)
    for inputs in ([inp], [inp, tmp_path / "o.bin", inp]):
        ours, theirs = tmp_path / "co.bin", tmp_path / "cj.bin"
        info = tsu.concat_videos_streamed(inputs, ours)
        assert info == jsu.concat_videos_streamed(inputs, theirs)
        assert ours.read_bytes() == theirs.read_bytes() == \
            tsu.concat_videos([p.read_bytes() for p in inputs])
    _same_frames(_decode(ours.read_bytes()), np.concatenate([src] * 3))


def _raised(fn):
    with pytest.raises(ValueError) as e:
        fn()
    return str(e.value)


def _refusal(mod, case, tmp_path):
    mhvt, mc = C["mhvt"][0], C["mhvt-mc"][0]
    p = tmp_path / f"{mod.__name__}.mhvt"
    p.write_bytes(mhvt)
    q = tmp_path / "v.mhv2"
    q.write_bytes(C["mhv2"][0])
    calls = {
        "extract-range": lambda: mod.extract_video(C["mhv2"][0], 5, 12),
        "extract-empty": lambda: mod.extract_video(C["mhtv"][0], 4, 4),
        "extract-mhts-range": lambda: mod.extract_video(C["mhts"][0], 0, 12),
        "extract-mhvt-range": lambda: mod.extract_video(mhvt, 3, 12),
        "extract-not-video": lambda: mod.extract_video(b"MHT1" + bytes(40),
                                                       0, 1),
        "concat-nothing": lambda: mod.concat_videos([]),
        "concat-families": lambda: mod.concat_videos(
            [C["mhtv"][0], C["mhts"][0]]),
        "concat-modes": lambda: mod.concat_videos(
            [C["mhtv"][0], C["mhtv-no-delta"][0]]),
        "concat-mhtc-meta": lambda: mod.concat_videos(
            [C["mhtc"][0], color.encode_color_video_to_bytes(RGB)]),
        "concat-motion-mix": lambda: mod.concat_videos([mhvt, mc]),
        "concat-keyint": lambda: mod.concat_videos(
            [mhvt, C["mhvt-streamed"][0]]),
        "concat-partial-group": lambda: mod.concat_videos([mhvt, mhvt]),
        "concat-first-len-later": lambda: mod.concat_videos(
            [mhvt, C["mhvt-first-len"][0]]),
        "resegment-mhts": lambda: mod.resegment_video(C["mhts"][0], 2),
        "resegment-zero": lambda: mod.resegment_video(C["mhtv"][0], 0),
        "streamed-mhvt": lambda: mod.concat_videos_streamed(
            [p, p], tmp_path / "x.bin"),
        "streamed-output-is-input": lambda: mod.concat_videos_streamed(
            [q, q], q),
        "streamed-resegment-mhvt": lambda: mod.resegment_video_streamed(
            p, tmp_path / "y.bin", 2),
        "streamed-resegment-in-place": lambda: mod.resegment_video_streamed(
            q, q, 2),
    }
    return _raised(calls[case])


REFUSALS = ["extract-range", "extract-empty", "extract-mhts-range",
            "extract-mhvt-range", "extract-not-video", "concat-nothing",
            "concat-families", "concat-modes", "concat-mhtc-meta",
            "concat-motion-mix", "concat-keyint", "concat-partial-group",
            "concat-first-len-later", "resegment-mhts", "resegment-zero",
            "streamed-mhvt", "streamed-output-is-input",
            "streamed-resegment-mhvt", "streamed-resegment-in-place"]


@pytest.mark.parametrize("case", REFUSALS)
def test_refusals_raise_what_the_jax_surgery_raises(case, tmp_path):
    assert _refusal(tsu, case, tmp_path) == _refusal(jsu, case, tmp_path)


def test_mid_group_extract_decodes_on_its_device(monkeypatch):
    seen = []
    real = temporal.decode_temporal_range

    def spy(blob, a, b, device="cuda"):
        seen.append(device)
        return real(blob, a, b, device="cpu")

    monkeypatch.setattr(temporal, "decode_temporal_range", spy)
    tsu.extract_video(C["mhvt"][0], 4, 9)  # a keyframe start: no decode
    assert seen == []
    out = tsu.extract_video(C["mhvt"][0], 5, 9)  # the default device
    assert seen == ["cuda"]
    assert out == jsu.extract_video(C["mhvt"][0], 5, 9)
