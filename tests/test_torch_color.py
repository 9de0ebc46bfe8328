"""Parity of the port's color and 16-bit grayscale containers (MHTC) with the
JAX package.

The same seeded numpy inputs go through both packages: the JAX side writes
with ``backend="native"`` and decodes on its host path, the port decodes on
the CPU (``device="cpu"``). Every comparison is exact (tolerance 0): the
device plane fold against ``fold_video_planes_jax`` and both host folds,
images, videos, gray16, the legacy bare-MHTV color blob, frame and region
random access, encode bytes and the plane-count errors.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import metalhuffman_tpu as mh
import metalhuffman_tpu_torch as mt
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import color as jc
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu_torch.models import color as tc
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig

NATIVE = JaxConfig(backend="native")
H, W = 20, 28


def _img(c, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 100 + 40 * np.sin(xx / 4.0) + 30 * np.cos(yy / 3.0)
    planes = [base + 10 * k + rng.normal(0, 4, (h, w)) for k in range(c)]
    return np.clip(np.stack(planes, -1), 0, 255).astype(np.uint8)


def _video(t, c, seed=1):
    img = _img(c, seed=seed)
    return np.stack([np.roll(img, 2 * i, axis=1) for i in range(t)])


def _u16(shape, seed=2):
    rng = np.random.default_rng(seed)
    grad = np.arange(shape[-1], dtype=np.uint16) * 131
    return (rng.integers(0, 4096, shape).astype(np.uint16) + grad)


FOLDS = {
    "gray": (1, tc.KIND_U8, tc.CS_IDENTITY),
    "rgb": (3, tc.KIND_U8, tc.CS_IDENTITY),
    "rgb-subgreen": (3, tc.KIND_U8, tc.CS_SUBGREEN),
    "rgba-subgreen": (4, tc.KIND_U8, tc.CS_SUBGREEN),
    "5-channel": (5, tc.KIND_U8, tc.CS_IDENTITY),
    "u16": (2, tc.KIND_U16, tc.CS_IDENTITY),
}


@pytest.mark.parametrize("name", FOLDS)
def test_fold_video_planes_torch_matches_jax(name):
    channels, kind, cs = FOLDS[name]
    planes = np.random.default_rng(3).integers(0, 256, (4 * channels, 6, 10),
                                               dtype=np.uint8)
    want = np.asarray(jc.fold_video_planes_jax(jnp.asarray(planes),
                                               channels, kind, cs))
    got = tc.fold_video_planes_torch(torch.from_numpy(planes), channels, kind,
                                     cs)
    assert got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tc.fold_video_planes(planes, channels, kind, cs), want)
    np.testing.assert_array_equal(
        jc.fold_video_planes(planes, channels, kind, cs), want)
    assert want.dtype == (np.uint16 if kind == tc.KIND_U16 else np.uint8)


@pytest.mark.parametrize("n, channels, kind", [(5, 3, 0), (6, 0, 0),
                                               (5, 2, 1), (4, 3, 1)])
def test_plane_count_errors_match_jax(n, channels, kind):
    planes = np.zeros((n, 4, 8), np.uint8)
    with pytest.raises(ValueError) as ref:
        jc.fold_video_planes(planes, channels, kind, 0)
    for fold in (lambda: tc.fold_video_planes(planes, channels, kind, 0),
                 lambda: tc.fold_video_planes_torch(
                     torch.from_numpy(planes), channels, kind, 0)):
        with pytest.raises(ValueError) as ours:
            fold()
        assert str(ours.value) == str(ref.value)


def test_subgreen_transform_matches_jax():
    img = _img(4)
    np.testing.assert_array_equal(tc.to_subgreen(img), jc.to_subgreen(img))
    np.testing.assert_array_equal(tc.from_subgreen(tc.to_subgreen(img)), img)
    with pytest.raises(ValueError, match="at least 3"):
        tc.encode_color_to_bytes(_img(2), colorspace=tc.CS_SUBGREEN)


@pytest.mark.parametrize("channels, cs", [(1, 0), (3, 0), (3, 1), (4, 1)])
def test_color_image_matches_jax(channels, cs):
    img = _img(channels, seed=channels)
    blob = tc.encode_color_to_bytes(img, colorspace=cs)
    assert blob == jc.encode_color_to_bytes(img, NATIVE, colorspace=cs)
    np.testing.assert_array_equal(tc.decode_color_from_bytes(blob, "cpu"), img)
    np.testing.assert_array_equal(jc.decode_color_from_bytes(blob, NATIVE),
                                  img)
    if cs == tc.CS_IDENTITY:
        assert mt.encode_color_image(img) == mh.encode_color_image(img,
                                                                   NATIVE)
    np.testing.assert_array_equal(mt.decode_color_image(blob, "cpu"), img)
    assert tc.describe(blob) == jc.describe(blob)
    stream, c = tc.encode_color(img)
    ref_stream, _ = jc.encode_color(img, NATIVE)
    assert c == channels and stream.code_bytes.tobytes() == \
        ref_stream.code_bytes.tobytes()
    np.testing.assert_array_equal(
        tc.decode_color(stream, H, W, c, device="cpu"),
        jc.decode_color(ref_stream, H, W, c, NATIVE))


def test_legacy_bare_mhtv_decodes_like_jax():
    img = _img(3, seed=4)
    stream = jfs.encode_frames_shared(np.moveaxis(img, -1, 0), NATIVE)
    legacy = jfs.write_shared(stream, 3, H, W, NATIVE)
    np.testing.assert_array_equal(tc.decode_color_from_bytes(legacy, "cpu"),
                                  img)
    np.testing.assert_array_equal(jc.decode_color_from_bytes(legacy, NATIVE),
                                  img)


@pytest.mark.parametrize("channels, cs", [(3, 1), (4, 0)])
def test_color_video_matches_jax(channels, cs):
    frames = _video(5, channels)
    blob = tc.encode_color_video_to_bytes(frames, colorspace=cs)
    assert blob == jc.encode_color_video_to_bytes(frames, NATIVE,
                                                  colorspace=cs)
    np.testing.assert_array_equal(
        tc.decode_color_video_from_bytes(blob, "cpu"), frames)
    np.testing.assert_array_equal(mt.decode_color_video(blob, "cpu"), frames)
    np.testing.assert_array_equal(
        jc.decode_color_video_from_bytes(blob, NATIVE), frames)
    if cs == tc.CS_IDENTITY:
        assert mt.encode_color_video(frames) == mh.encode_color_video(
            frames, NATIVE)
    for n in (0, 3, 4):
        np.testing.assert_array_equal(tc.decode_color_frame(blob, n, "cpu"),
                                      frames[n])
        np.testing.assert_array_equal(jc.decode_color_frame(blob, n, NATIVE),
                                      frames[n])
    assert tc.describe(blob) == jc.describe(blob)


def test_color_frame_across_mhv2_segments(monkeypatch):
    frames = _video(5, 3, seed=5)
    # two frames' planes per segment in both packages
    for fs in (tfs, jfs):
        monkeypatch.setattr(fs, "_SEG_BITS_PER_SYMBOL",
                            ((1 << 32) - 1024) // (6 * H * W))
    blob = tc.encode_color_video_to_bytes(frames, CodecConfig(
        frame_crcs=True))
    assert blob == jc.encode_color_video_to_bytes(
        frames, dataclasses.replace(NATIVE, frame_crcs=True))
    assert tc.unwrap(blob)[0][:4] == b"MHV2"
    np.testing.assert_array_equal(mt.decode_color_video(blob, "cpu"), frames)
    for n in range(5):
        np.testing.assert_array_equal(tc.decode_color_frame(blob, n, "cpu"),
                                      frames[n])


def _flip_plane_block(blob, plane, block, bit):
    """An MHTC video blob with code bit ``bit`` of block ``block`` of inner
    plane ``plane`` flipped."""
    inner, ch, layout, kind, cs = jc.unwrap(blob)
    stream, t, h, w, bd, _delta = jfs.read_shared(inner)
    per = (-(-h // bd)) * (-(-w // bd))
    at = int(stream.block_offsets[plane * per + block]) + bit
    code = stream.code_bytes.copy()
    code[at // 8] ^= 128 >> (at % 8)
    inner = jfs.write_shared(dataclasses.replace(stream, code_bytes=code), t,
                             h, w, NATIVE,
                             source_crc32=jfs.source_crc32(inner))
    return jc.wrap(inner, ch, layout, kind, cs)


def test_color_region_matches_jax():
    frames = _video(4, 3, seed=6)
    blob = jc.encode_color_video_to_bytes(frames, NATIVE,
                                          colorspace=jc.CS_SUBGREEN)
    region = (1, 3, 3, 5, 9, 14)
    a, b, y0, x0, rh, rw = region
    ours = tc.decode_color_video_region(blob, *region, check=True,
                                        device="cpu")
    np.testing.assert_array_equal(ours, frames[a:b, y0:y0 + rh, x0:x0 + rw])
    np.testing.assert_array_equal(ours, jc.decode_color_video_region(
        blob, *region, NATIVE, check=True))
    # frame 2's plane 1 (G): block 0 lies in the region, block 3 outside
    raised = {}
    for where, block in (("inside", 0), ("outside", 3)):
        for bit in range(0, 30, 2):
            flipped = _flip_plane_block(blob, 2 * 3 + 1, block, bit)
            got = []
            for decode in (
                    lambda: tc.decode_color_video_region(
                        flipped, *region, check=True, device="cpu"),
                    lambda: jc.decode_color_video_region(
                        flipped, *region, NATIVE, check=True)):
                try:
                    decode()
                    got.append(False)
                except ValueError as e:
                    assert "integrity check failed" in str(e)
                    got.append(True)
            assert got[0] == got[1]
            raised[where] = raised.get(where, 0) + got[0]
    assert raised["inside"] > 0 and raised["outside"] == 0


def test_gray16_matches_jax():
    img = _u16((H, W))
    blob = tc.encode_gray16_to_bytes(img)
    assert blob == jc.encode_gray16_to_bytes(img, NATIVE)
    got = tc.decode_gray16_from_bytes(blob, "cpu")
    assert got.dtype == np.uint16 and got.shape == (H, W)
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(jc.decode_gray16_from_bytes(blob, NATIVE),
                                  img)
    video = _u16((4, H, W), seed=7)
    vblob = tc.encode_gray16_to_bytes(video)
    assert vblob == jc.encode_gray16_to_bytes(video, NATIVE)
    np.testing.assert_array_equal(tc.decode_gray16_from_bytes(vblob, "cpu"),
                                  video)
    for n in (0, 3):
        np.testing.assert_array_equal(tc.decode_color_frame(vblob, n, "cpu"),
                                      video[n])
    region = tc.decode_color_video_region(vblob, 1, 4, 2, 3, 11, 13,
                                          check=True, device="cpu")
    np.testing.assert_array_equal(region, video[1:4, 2:13, 3:16])
    np.testing.assert_array_equal(region, jc.decode_color_video_region(
        vblob, 1, 4, 2, 3, 11, 13, NATIVE, check=True))
    assert tc.describe(vblob) == jc.describe(vblob)


def test_container_errors_match_jax():
    img = _img(3)
    image = tc.encode_color_to_bytes(img)
    video = tc.encode_color_video_to_bytes(_video(2, 3))
    gray16 = tc.encode_gray16_to_bytes(_u16((H, W)))
    cases = [
        (image, "video"), (video, "image"), (gray16, "image"),
        (image, "gray16"), (image, "frame"), (image[:6], "image"),
        (b"MHTC" + bytes([3, 9, 0, 0]) + image[8:], "image"),
        (b"MHTC" + bytes([3, 0, 5, 0]) + image[8:], "image"),
        (b"MHTC" + bytes([3, 0, 0, 7]) + image[8:], "image"),
        (tc.wrap(tc.unwrap(image)[0], 4, tc.LAYOUT_IMAGE), "image"),
        (tc.wrap(tc.unwrap(video)[0], 4, tc.LAYOUT_VIDEO), "video"),
        (tc.wrap(tc.unwrap(image)[0], 2, tc.LAYOUT_IMAGE, tc.KIND_U16),
         "gray16"),
    ]
    ours = {"image": lambda b: tc.decode_color_from_bytes(b, "cpu"),
            "video": lambda b: tc.decode_color_video_from_bytes(b, "cpu"),
            "gray16": lambda b: tc.decode_gray16_from_bytes(b, "cpu"),
            "frame": lambda b: tc.decode_color_frame(b, 0, "cpu")}
    ref = {"image": lambda b: jc.decode_color_from_bytes(b, NATIVE),
           "video": lambda b: jc.decode_color_video_from_bytes(b, NATIVE),
           "gray16": lambda b: jc.decode_gray16_from_bytes(b, NATIVE),
           "frame": lambda b: jc.decode_color_frame(b, 0, NATIVE)}
    for blob, what in cases:
        with pytest.raises(ValueError) as e_ours:
            ours[what](blob)
        with pytest.raises(ValueError) as e_ref:
            ref[what](blob)
        assert str(e_ours.value) == str(e_ref.value), what
    for bad in (0, 256):
        with pytest.raises(ValueError, match="channels"):
            tc.wrap(b"", bad, tc.LAYOUT_IMAGE)
    for bad in (img[..., 0], img.astype(np.uint16)):
        with pytest.raises(ValueError, match="expected"):
            tc.encode_color_to_bytes(bad)
    with pytest.raises(ValueError, match="expected"):
        tc.encode_gray16_to_bytes(img)


def test_corrupt_color_payload_fails_its_crc():
    img = _img(3, seed=8)
    blob = bytearray(tc.encode_color_to_bytes(img))
    blob[60] ^= 0x10
    for decode in (lambda: tc.decode_color_from_bytes(bytes(blob), "cpu"),
                   lambda: jc.decode_color_from_bytes(bytes(blob), NATIVE)):
        with pytest.raises(ValueError):
            decode()
