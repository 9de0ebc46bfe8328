"""Parity of the port's temporal video (MHVT) with the JAX package.

The same inputs, made from a seed with numpy, go through the JAX package and
the port (``device="cpu"``: the plain versions of the decode kernels, and
the torch folds on CPU tensors). Blobs are written by the JAX package with
``backend="native"`` and decoded by its host path, except for one case
through its default backend in Pallas interpret mode. Every comparison is
exact (tolerance 0).

- the host code: ``wrap``/``unwrap`` on every flag (the trailer layout of
  ``TemporalStreamingEncoder``, FIRST_LEN from ``surgery.extract_video``,
  INNER64), the transforms and ``estimate_motion``;
- the device folds against ``temporal_decode_jax``, ``temporal_decode_mc_jax``
  and the packed-word folds through a byte view of their words;
- whole decodes, encode parity, random access and the errors of corrupt
  containers.
"""

import dataclasses
import io
import struct
import zlib

import numpy as np
import pytest
import torch

import metalhuffman_tpu as mh
import metalhuffman_tpu_torch as mt
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import color as jcolor
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import surgery
from metalhuffman_tpu.models import temporal as jt
from metalhuffman_tpu.models.stream_writer import TemporalStreamingEncoder
from metalhuffman_tpu_torch.models import color as tcolor
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import temporal as tt
from metalhuffman_tpu_torch.models.config import CodecConfig

NATIVE = JaxConfig(backend="native")
H, W = 24, 36  # no multiple of 8 across: padded block grids


def _pan(t=11, h=H, w=W, seed=0, step=(2, -3)):
    """A textured frame panned ``step`` pixels a frame, with a little noise
    (a pan the motion estimator finds)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = (120 + 50 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
            + rng.normal(0, 12, (h, w)))
    base = np.clip(base, 0, 255).astype(np.uint8)
    frames = np.stack([np.roll(base, (step[0] * i, step[1] * i), (0, 1))
                       for i in range(t)])
    noise = rng.integers(0, 3, frames.shape).astype(np.uint8)
    return frames + noise


def _color(frames, c=3):
    return np.stack([np.roll(frames, k, axis=2) // (k + 1)
                     for k in range(c)], axis=-1)


def _u16(frames):
    """Depth-like u16 frames: the frames scaled to 12 bits and a gradient,
    so the lo plane carries into the hi plane."""
    grad = (np.arange(frames.shape[2], dtype=np.uint16) * 97)[None, None]
    return frames.astype(np.uint16) * 16 + grad


def _cfgs(**kw):
    """(port config, JAX native config) with the same fields."""
    return CodecConfig(**kw), dataclasses.replace(NATIVE, **kw)


# -- the host code -------------------------------------------------------------


WRAPS = {
    "plain": {},
    "motion": {"mvs": True},
    "frame-crcs": {"frame_crcs": True},
    "first-len": {"first_len": 3},
    "all-header": {"mvs": True, "frame_crcs": True, "first_len": 2},
    "trailer": {"trailer": True},
    "trailer-all": {"mvs": True, "frame_crcs": True, "first_len": 5,
                    "trailer": True},
}


@pytest.mark.parametrize("name", WRAPS)
def test_wrap_and_unwrap_match_jax(name):
    rng = np.random.default_rng(1)
    kw = dict(WRAPS[name])
    if kw.pop("mvs", False):
        kw["mvs"] = rng.integers(-300, 300, (7, 2)).astype(np.int16)
    if kw.pop("frame_crcs", False):
        kw["frame_crcs"] = rng.integers(0, 1 << 32, 7, dtype=np.uint64)
    inner = b"MHTV" + rng.integers(0, 256, 50, np.uint8).tobytes()
    blob = tt.wrap(inner, 6, source_crc32=0xDEADBEEF, **kw)
    assert blob == jt.wrap(inner, 6, source_crc32=0xDEADBEEF, **kw)
    ours, ref = tt.unwrap(blob), jt.unwrap(blob)
    assert ours[0] == ref[0] == inner and ours[1:3] == ref[1:3]
    for a, b in zip(ours[3:5], ref[3:5]):
        assert (a is None and b is None) or np.array_equal(a, b)
    assert ours[5] == ref[5]
    assert tt.describe(blob) == jt.describe(blob)


def test_wrap_past_u32_takes_the_u64_length():
    class _FakeLen(bytes):
        def __len__(self):
            return 0x100000001

    assert tt.wrap(_FakeLen(), 8) == jt.wrap(_FakeLen(), 8)
    _keyint, flags, len32 = struct.unpack_from("<HHI", tt.wrap(_FakeLen(), 8),
                                               4)
    assert flags & tt.FLAG_INNER64 and len32 == 0


def test_inner64_blob_decodes_like_jax():
    # the header layout with FLAG_INNER64 and the u64 length after it, as
    # wrap writes it for an inner past 4 GiB
    frames = _pan(6)
    blob = mh.encode_video(frames, dataclasses.replace(
        NATIVE, temporal=True, motion=True, keyint=4))
    keyint, flags, inner_len = struct.unpack_from("<HHI", blob, 4)
    big = (blob[:4] + struct.pack("<HHI", keyint, flags | jt.FLAG_INNER64, 0)
           + struct.pack("<Q", inner_len) + blob[12:])
    np.testing.assert_array_equal(tt.unwrap(big)[3], jt.unwrap(big)[3])
    np.testing.assert_array_equal(mt.decode_video(big, "cpu"), frames)
    np.testing.assert_array_equal(jt.decode_temporal_video(big, NATIVE),
                                  frames)


def _streamed(frames, cfg, **kw):
    sink = io.BytesIO()
    h, w = frames.shape[1:3]
    with TemporalStreamingEncoder(sink, h, w, cfg, **kw) as enc:
        enc.push(frames[:5])
        enc.push(frames[5:])
    return sink.getvalue()


@pytest.mark.parametrize("kind", ["gray-motion", "color", "u16"])
def test_streamed_trailer_layout_decodes_like_jax(kind):
    frames = _pan(9, seed=3)
    cfg = dataclasses.replace(NATIVE, temporal=True, keyint=4,
                              motion=kind != "color")
    if kind == "gray-motion":
        blob = _streamed(frames, cfg, frame_crcs=True, max_segment_frames=4)
    elif kind == "color":
        frames = _color(frames)
        blob = _streamed(frames, cfg, channels=3,
                         colorspace=jcolor.CS_SUBGREEN)
    else:
        frames = _u16(frames)
        blob = _streamed(frames, cfg, u16=True)
    assert struct.unpack_from("<HHI", blob, 4)[1] & tt.FLAG_TRAILER
    ours = mt.decode_video(blob, "cpu")
    assert ours.dtype == frames.dtype
    np.testing.assert_array_equal(ours, frames)
    np.testing.assert_array_equal(jt.decode_temporal_video(blob, NATIVE),
                                  frames)
    np.testing.assert_array_equal(tt.decode_temporal_range(blob, 3, 7, "cpu"),
                                  frames[3:7])
    assert tt.describe(blob) == jt.describe(blob)


def test_extracted_short_first_group_decodes_like_jax():
    frames = _pan(13, seed=4)
    for motion in (False, True):
        blob = mh.encode_video(frames, dataclasses.replace(
            NATIVE, temporal=True, keyint=4, motion=motion, frame_crcs=True))
        part = surgery.extract_video(blob, 2, 12)  # starts mid-group
        fl = jt.unwrap(part)[5]
        assert fl == 2 and tt.unwrap(part)[5] == fl
        np.testing.assert_array_equal(mt.decode_video(part, "cpu"),
                                      frames[2:12])
        np.testing.assert_array_equal(jt.decode_temporal_video(part, NATIVE),
                                      frames[2:12])
        for a, b in ((0, 1), (1, 3), (2, 7), (5, 10)):
            np.testing.assert_array_equal(
                tt.decode_temporal_range(part, a, b, "cpu"),
                jt.decode_temporal_range(part, a, b, NATIVE))
        got = [c for _, c in tt.iter_temporal_video(part, "cpu",
                                                    chunk_frames=3)]
        np.testing.assert_array_equal(np.concatenate(got), frames[2:12])


@pytest.mark.parametrize("dtype", ["u8", "u16", "color"])
def test_transforms_match_jax(dtype):
    frames = _pan(9, h=64, w=72, seed=5)  # even and >= 64: downsampled
    frames = {"u8": frames, "u16": _u16(frames),
              "color": _color(frames)}[dtype]
    for keyint in (1, 3, 8):
        res = tt.temporal_encode(frames, keyint)
        np.testing.assert_array_equal(res, jt.temporal_encode(frames, keyint))
        for fl in (None, 2):
            np.testing.assert_array_equal(
                tt.temporal_decode(res, keyint, fl),
                jt.temporal_decode(res, keyint, fl))
    res, mvs = tt.temporal_encode_mc(frames, 4)
    ref, ref_mvs = jt.temporal_encode_mc(frames, 4)
    np.testing.assert_array_equal(res, ref)
    np.testing.assert_array_equal(mvs, ref_mvs)
    assert (mvs != 0).any()
    np.testing.assert_array_equal(tt.temporal_decode_mc(res, 4, mvs), frames)
    # odd sizes correlate at full resolution
    odd = frames[:, :33, :45]
    for i in (1, 2):
        assert (tt.estimate_motion(odd[i - 1], odd[i])
                == jt.estimate_motion(odd[i - 1], odd[i]))


def test_transforms_validate_like_jax():
    frames = _pan(4)
    for fn in (lambda m: m.temporal_encode(frames, 0),
               lambda m: m.temporal_encode(frames.astype(np.int16), 2),
               lambda m: m.temporal_encode(frames[0], 2),
               lambda m: m.temporal_encode_mc(frames, 0),
               lambda m: m.temporal_decode(frames, 0),
               lambda m: m.temporal_decode_mc(frames, 2, np.zeros((3, 2)))):
        with pytest.raises(ValueError) as ours:
            fn(tt)
        with pytest.raises(ValueError) as ref:
            fn(jt)
        assert str(ours.value) == str(ref.value)


# -- the folds on the device ---------------------------------------------------


def _res(dtype, t=10, seed=6):
    rng = np.random.default_rng(seed)
    shape = {"u8": (t, H, W), "u16": (t, H, W), "color": (t, H, W, 3)}[dtype]
    top = 1 << 16 if dtype == "u16" else 256
    return rng.integers(0, top, shape).astype(
        np.uint16 if dtype == "u16" else np.uint8)


def _t(a):
    """A CPU tensor of a copy of ``a`` (the folds work in place)."""
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["u8", "u16", "color"])
def test_temporal_fold_matches_jax(dtype):
    res = _res(dtype)
    for keyint, fl in ((1, None), (3, None), (4, 2), (8, 3), (16, None)):
        want = np.asarray(jt.temporal_decode_jax(res, keyint, fl))
        x = _t(res)
        assert tt.temporal_fold(x, keyint, fl) is x  # in place
        np.testing.assert_array_equal(x.numpy(), want)
        np.testing.assert_array_equal(want, jt.temporal_decode(res, keyint,
                                                               fl))


def test_temporal_fold_matches_the_word_folds():
    rng = np.random.default_rng(8)
    t, rows, wpw = 9, 8, 6
    words = rng.integers(-(1 << 31), 1 << 31, (t, rows, wpw), np.int64
                         ).astype(np.int32)
    as_bytes = words.view(np.uint8).reshape(t, rows, wpw * 4)
    want = np.asarray(jt.temporal_fold_words_jax(words, 4, 3))
    np.testing.assert_array_equal(
        tt.temporal_fold(_t(as_bytes), 4, 3).numpy(),
        want.view(np.uint8).reshape(as_bytes.shape))
    # three planes per frame (MHTC color): the fold of the (T, H, W, C)
    # frames the plane fold gives, sub-green inverted after it
    planes = words.reshape(3, 3, rows, wpw).reshape(9, rows, wpw)
    want = np.asarray(jt.temporal_fold_plane_words_jax(planes, 2, 3))
    want_frames = jcolor.fold_video_planes(
        want.view(np.uint8).reshape(9, rows, wpw * 4), 3, 0, 1)
    frames = tcolor.fold_video_planes_torch(
        _t(planes.view(np.uint8).reshape(9, rows, wpw * 4)), 3, 0, 1)
    np.testing.assert_array_equal(tt.temporal_fold(frames, 2).numpy(),
                                  want_frames)
    # u16 hi/lo plane pairs, the lo plane carrying into the hi plane
    pairs = words[:8]
    want = np.asarray(jt.temporal_fold_u16_words_jax(pairs, 3, 2))
    want_frames = jcolor.fold_video_planes(
        want.view(np.uint8).reshape(8, rows, wpw * 4), 2, 1, 0)
    frames = tcolor.fold_video_planes_torch(
        _t(pairs.view(np.uint8).reshape(8, rows, wpw * 4)), 2, 1, 0)
    got = tt.temporal_fold(frames, 3, 2).numpy()
    assert got.dtype == np.uint16
    np.testing.assert_array_equal(got, want_frames)


def _mvs(t, seed, span=100):
    """Vectors with negative ones and ones past the frame's size."""
    mvs = np.random.default_rng(seed).integers(-span, span, (t, 2))
    mvs[1] = (-1, -W - 5)
    mvs[2] = (H + 7, 0)
    mvs[4] = 0
    return mvs.astype(np.int16)


@pytest.mark.parametrize("dtype", ["u8", "u16", "color"])
def test_temporal_fold_mc_matches_jax(dtype):
    res = _res(dtype, seed=9)
    mvs = _mvs(res.shape[0], 10)
    for keyint, fl in ((3, None), (4, 1), (8, 3)):
        want = np.asarray(jt.temporal_decode_mc_jax(res, keyint, mvs, fl))
        np.testing.assert_array_equal(
            want, jt.temporal_decode_mc(res, keyint, mvs, fl))
        got = tt.temporal_fold_mc(_t(res), keyint, mvs, fl)
        np.testing.assert_array_equal(got.numpy(), want)
    for bad in (mvs[:4], mvs[:, :1]):
        with pytest.raises(ValueError, match="motion table length"):
            tt.temporal_fold_mc(_t(res), 3, bad)


@pytest.mark.parametrize("mode", ["gray", "planes", "u16"])
def test_temporal_fold_mc_matches_the_word_fold_on_padded_frames(mode):
    # the packed fold runs on B1's padded extent (rows_pf x w_pad) and rolls
    # the true (h, w) frame inside it; the port crops first and rolls the
    # true frame
    rng = np.random.default_rng(11)
    p = {"gray": 1, "planes": 3, "u16": 2}[mode]
    t, rows_pf, wpw, h, w = 7, 16, 8, 13, 27
    words = rng.integers(-(1 << 31), 1 << 31, (t * p, rows_pf, wpw),
                         np.int64).astype(np.int32)
    mvs = _mvs(t, 12, span=40)
    want = np.asarray(jt.temporal_fold_words_mc_jax(
        words, 3, mvs, height=h, width=w, first_len=2, planes_per_frame=p,
        carry_u16=mode == "u16"))
    want = want.view(np.uint8).reshape(t * p, rows_pf, wpw * 4)[:, :h, :w]
    planes = np.ascontiguousarray(
        words.view(np.uint8).reshape(t * p, rows_pf, wpw * 4)[:, :h, :w])
    if mode == "gray":
        res, want = torch.from_numpy(planes), want
    else:
        kind = 1 if mode == "u16" else 0
        res = tcolor.fold_video_planes_torch(torch.from_numpy(planes), p,
                                             kind, 0)
        want = jcolor.fold_video_planes(np.ascontiguousarray(want), p, kind,
                                        0)
    got = tt.temporal_fold_mc(res, 3, mvs, 2).numpy()
    np.testing.assert_array_equal(got, want)


def test_roll_groups_is_np_roll():
    rng = np.random.default_rng(13)
    prev = rng.integers(0, 256, (4, 5, 7, 2), np.uint8)
    dy, dx = np.array([0, 3, 4, 1]), np.array([6, 0, 2, 5])
    got = tt.roll_groups(torch.from_numpy(prev), torch.from_numpy(dy),
                         torch.from_numpy(dx)).numpy()
    for g in range(4):
        np.testing.assert_array_equal(
            got[g], np.roll(prev[g], (dy[g], dx[g]), axis=(0, 1)))


def test_folds_validate():
    res = torch.from_numpy(_res("u8"))
    with pytest.raises(ValueError, match="keyint"):
        tt.temporal_fold(res, 0)
    with pytest.raises(ValueError, match="uint8/uint16"):
        tt.temporal_fold(res.int(), 2)
    with pytest.raises(ValueError, match="contiguous"):
        tt.temporal_fold(res.transpose(1, 2), 2)


# -- whole decodes and encode parity --------------------------------------------


def _encode(kind, frames, **kw):
    """(port blob, JAX blob, the true frames) of ``kind``."""
    ours, ref = _cfgs(temporal=True, **kw)
    if kind == "gray":
        return (mt.encode_video(frames, ours), mh.encode_video(frames, ref),
                frames)
    if kind.startswith("color"):
        c = int(kind[5:])
        frames = _color(frames, c)
        cs = jcolor.CS_SUBGREEN if c >= 3 else jcolor.CS_IDENTITY
        return (tt.encode_temporal_color_video(frames, ours, colorspace=cs),
                jt.encode_temporal_color_video(frames, ref, colorspace=cs),
                frames)
    frames = _u16(frames)
    return (tt.encode_temporal_gray16_video(frames, ours),
            jt.encode_temporal_gray16_video(frames, ref), frames)


DECODES = {
    "gray": ("gray", {}),
    "motion": ("gray", {"motion": True, "keyint": 4}),
    "color3-subgreen": ("color3", {"keyint": 3}),
    "color5": ("color5", {"motion": True}),
    "gray16": ("u16", {}),
    "motion-u16": ("u16", {"motion": True, "keyint": 5}),
    "zero-init": ("gray", {"zero_init": True, "motion": True}),
    "delta2d": ("gray", {"delta2d": True, "frame_crcs": True}),
    "16x16": ("gray", {"block_dim": 16, "motion": True}),
    "mhv2": ("gray", {"motion": True, "keyint": 4}),
    "mhv2-color": ("color3", {"keyint": 4}),
}


@pytest.mark.parametrize("name", DECODES)
def test_decode_video_matches_jax(monkeypatch, name):
    kind, kw = DECODES[name]
    if name.startswith("mhv2"):  # three true frames' planes per segment
        per = 3 * H * W * (3 if kind == "color3" else 1)
        for fs in (tfs, jfs):
            monkeypatch.setattr(fs, "_SEG_BITS_PER_SYMBOL",
                                ((1 << 32) - 1024) // per)
    ours, ref, frames = _encode(kind, _pan(11, seed=14), **kw)
    assert ours == ref
    inner = tt.unwrap(ours)[0]
    plane_inner = tt._plane_inner(inner)[0]
    assert plane_inner[:4] == (b"MHV2" if name.startswith("mhv2")
                               else b"MHTV")
    got = mt.decode_video(ours, "cpu")
    assert got.dtype == frames.dtype
    np.testing.assert_array_equal(got, frames)
    np.testing.assert_array_equal(jt.decode_temporal_video(ours, NATIVE),
                                  frames)
    if kind.startswith("color"):
        np.testing.assert_array_equal(mt.decode_color_video(ours, "cpu"),
                                      frames)
    assert tt.describe(ours) == jt.describe(ours)


@pytest.fixture(scope="module")
def interpret_case():
    """A motion-compensated MHVT through the JAX package's default backend
    in Pallas interpret mode (one compile)."""
    frames = _pan(7, h=16, w=24, seed=15)
    blob = mh.encode_video(frames, dataclasses.replace(
        NATIVE, temporal=True, motion=True, keyint=3))
    return frames, blob, jt.decode_temporal_video(
        blob, JaxConfig(interpret=True))


def test_decode_video_matches_jax_in_interpret_mode(interpret_case):
    frames, blob, ref = interpret_case
    np.testing.assert_array_equal(ref, frames)
    np.testing.assert_array_equal(mt.decode_video(blob, "cpu"), ref)


def test_top_level_entry_points_match_jax():
    frames = _pan(6, seed=16)
    col = _color(frames, 4)
    ours, ref = _cfgs(temporal=True, motion=True, keyint=4)
    blob = mt.encode_color_video(col, ours)
    assert blob == mh.encode_color_video(col, ref)
    np.testing.assert_array_equal(mt.decode_color_video(blob, "cpu"), col)
    np.testing.assert_array_equal(mh.decode_color_video(blob, NATIVE), col)


# -- random access -------------------------------------------------------------


@pytest.fixture(scope="module")
def clips():
    frames = _pan(13, seed=17)
    out = {}
    for kind, kw in (("gray", {"frame_crcs": True}),
                     ("gray", {"motion": True, "frame_crcs": True}),
                     ("color3", {"keyint": 5}),
                     ("u16", {"motion": True})):
        ours, _ref, f = _encode(kind, frames, **kw)
        out[f"{kind}{'-mc' if kw.get('motion') else ''}"] = (ours, f)
    return out


@pytest.mark.parametrize("clip", ["gray", "gray-mc", "color3", "u16-mc"])
def test_range_frame_and_iterator_match_jax(clips, clip):
    blob, frames = clips[clip]
    for a, b in ((0, 13), (5, 14 - 1), (7, 9), (8, 9), (12, 13)):
        ours = tt.decode_temporal_range(blob, a, b, "cpu")
        np.testing.assert_array_equal(ours, frames[a:b])
        np.testing.assert_array_equal(
            ours, jt.decode_temporal_range(blob, a, b, NATIVE))
    for n in (0, 9, 12):
        np.testing.assert_array_equal(tt.decode_temporal_frame(blob, n, "cpu"),
                                      frames[n])
    for chunk in (1, 10, 50):
        ours = [(base, out.shape[0]) for base, out in
                tt.iter_temporal_video(blob, "cpu", chunk_frames=chunk)]
        ref = [(base, out.shape[0]) for base, out in
               jt.iter_temporal_video(blob, NATIVE, chunk_frames=chunk)]
        assert ours == ref
    np.testing.assert_array_equal(np.concatenate(
        [out for _, out in tt.iter_temporal_video(blob, "cpu", 4)]), frames)
    for bad in ((-1, 2), (3, 3), (0, 14)):
        with pytest.raises(ValueError):
            tt.decode_temporal_range(blob, *bad, "cpu")
        with pytest.raises(ValueError):
            jt.decode_temporal_range(blob, *bad, NATIVE)


@pytest.mark.parametrize("clip", ["gray", "gray-mc", "color3", "u16-mc"])
def test_region_matches_jax(clips, clip):
    blob, frames = clips[clip]
    region = (3, 12, 5, 9, 10, 17)  # frames 3-11, a 10x17 crop at (5, 9)
    a, b, y0, x0, rh, rw = region
    # a checked MC region needs the frame CRC table, which u16-mc lacks
    for check in (False,) if clip == "u16-mc" else (False, True):
        ours = tt.decode_temporal_video_region(blob, *region, check,
                                               device="cpu")
        np.testing.assert_array_equal(ours, frames[a:b, y0:y0 + rh,
                                                   x0:x0 + rw])
        np.testing.assert_array_equal(ours, jt.decode_temporal_video_region(
            blob, *region, NATIVE, check=check))
    with pytest.raises(ValueError, match="region out of bounds"):
        tt.decode_temporal_video_region(blob, 0, 2, 20, 0, 10, 10,
                                        device="cpu")


def test_mc_region_check_needs_the_frame_crc_table(clips):
    blob, _frames = clips["u16-mc"]
    for decode in (lambda: tt.decode_temporal_video_region(
                       blob, 1, 3, 0, 0, 8, 8, True, device="cpu"),
                   lambda: jt.decode_temporal_video_region(
                       blob, 1, 3, 0, 0, 8, 8, NATIVE, check=True)):
        with pytest.raises(ValueError, match="per-frame CRC table"):
            decode()


def _flip_inner_block(blob, frame, block, bit):
    """``blob`` (a plain gray MHVT over an MHTV) with code bit ``bit`` of
    block ``block`` of residual frame ``frame`` flipped."""
    inner, keyint, crc, mvs, fcrcs, fl = jt.unwrap(blob)
    stream, t, h, w, bd, _delta = jfs.read_shared(inner)
    per = (-(-h // bd)) * (-(-w // bd))
    at = int(stream.block_offsets[frame * per + block]) + bit
    code = stream.code_bytes.copy()
    code[at // 8] ^= 128 >> (at % 8)
    stream = dataclasses.replace(stream, code_bytes=code)
    inner = jfs.write_shared(stream, t, h, w, NATIVE,
                             source_crc32=jfs.source_crc32(inner))
    return jt.wrap(inner, keyint, crc, mvs, fcrcs, fl)


def test_region_check_flags_flips_inside_only(clips):
    blob, frames = clips["gray"]
    a, b, y0, x0, rh, rw = 9, 11, 8, 8, 8, 16  # blocks (1, 1) and (1, 2)
    bw = -(-W // 8)

    def both(b_):
        raised = []
        for decode in (
                lambda: tt.decode_temporal_video_region(
                    b_, a, b, y0, x0, rh, rw, True, device="cpu"),
                lambda: jt.decode_temporal_video_region(
                    b_, a, b, y0, x0, rh, rw, NATIVE, check=True)):
            try:
                decode()
                raised.append(False)
            except ValueError as e:
                assert "integrity check failed" in str(e)
                raised.append(True)
        return tuple(raised)

    caught = sum(both(_flip_inner_block(blob, 9, 1 * bw + 1, bit))[0]
                 for bit in range(0, 40, 3))
    assert caught > 0
    for bit in range(0, 40, 3):  # parity bit by bit
        flipped = _flip_inner_block(blob, 9, 1 * bw + 1, bit)
        ours, ref = both(flipped)
        assert ours == ref
    outside = _flip_inner_block(blob, 9, 0 * bw + 4, 5)
    assert both(outside) == (False, False)
    np.testing.assert_array_equal(
        tt.decode_temporal_video_region(outside, a, b, y0, x0, rh, rw, True,
                                        device="cpu"),
        frames[a:b, y0:y0 + rh, x0:x0 + rw])


# -- corrupt containers ----------------------------------------------------------


def _same_error(blob):
    """Both packages raise on ``blob``, the same type (and message where
    the reference's is deterministic)."""
    with pytest.raises(Exception) as ours:
        mt.decode_video(blob, "cpu")
    with pytest.raises(Exception) as ref:
        mh.decode_video(blob, NATIVE)
    assert type(ours.value) is type(ref.value)
    return str(ours.value), str(ref.value)


def test_corrupt_containers_raise_like_jax(clips):
    blob, frames = clips["gray-mc"]
    inner = jt.unwrap(blob)[0]
    # cut blobs: in the header, the tables, the inner and the trailer
    for cut in (6, 13, 30, len(blob) - len(inner) + 40, len(blob) - 2):
        ours, ref = _same_error(blob[:cut])
        assert ours == ref
    # an unknown flag
    bad = blob[:6] + struct.pack("<H", 0x20) + blob[8:]
    assert len(set(_same_error(bad))) == 1
    # a short motion table
    res, mvs = jt.temporal_encode_mc(frames, 8)
    short = jt.wrap(mh.encode_video(res, jt._inner_config(NATIVE)), 8,
                    source_crc32=jt._crc(frames), mvs=mvs[:4])
    ours, ref = _same_error(short)
    assert ours == ref and "motion table length disagrees" in ours
    # a changed keyint: the residuals verify, the wrapper is suspect
    plain, frames = clips["gray"]
    keyed = plain[:4] + struct.pack("<H", 3) + plain[6:]
    ours, ref = _same_error(keyed)
    assert ours == ref and "wrapper header itself is suspect" in ours
    # a corrupt inner: its own CRC says so
    flipped = _flip_inner_block(plain, 9, 7, 3)
    ours, ref = _same_error(flipped)
    assert ours == ref and "CRC-32 mismatch" in ours


def test_unrecorded_outer_crc_checks_the_inner():
    frames = _pan(6, seed=18)
    res = jt.temporal_encode(frames, 4)
    inner = mh.encode_video(res, jt._inner_config(NATIVE))
    blob = jt.wrap(inner, 4)  # no outer CRC
    np.testing.assert_array_equal(mt.decode_video(blob, "cpu"), frames)
    flipped = _flip_inner_block(blob, 2, 3, 1)
    ours, ref = _same_error(flipped)
    assert ours == ref and "CRC-32 mismatch" in ours
