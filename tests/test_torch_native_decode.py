"""The port's host C++ decoder (``native``'s decode half, ``device="native"``)
against the JAX package's (``metalhuffman_tpu.native``, ``backend="native"``).

Both sides of every comparison are host C++, so nothing here interprets a
Pallas kernel. The same seeded numpy inputs go through the bindings of both
packages (block sizes 4/16/64/256, precoders none/delta/delta2d, 1, 3 and
all threads, the serial decoders at every start bit and k1 in {4, 8, 11,
12}), then through every decode surface of the port with
``device="native"``, each against the JAX package's ``backend="native"``,
the port's ``device="cpu"`` (the kernels' plain versions) and the source.
Every comparison is exact (tolerance 0). Where the JAX package refuses its
native backend, the port raises the same exception type.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import metalhuffman_tpu as jmt
import metalhuffman_tpu_torch as mt
from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import ImageCodec as JaxImageCodec
from metalhuffman_tpu.models import color as jcolor
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import temporal as jtemporal
from metalhuffman_tpu_torch import _build, native
from metalhuffman_tpu_torch.core import tables
from metalhuffman_tpu_torch.models import color as tcolor
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import temporal as ttemporal
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.models.image_codec import ImageCodec
from metalhuffman_tpu_torch.ops import decode_cuda

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

JN = JaxConfig(backend="native")
T, H, W = 6, 24, 40


def _skewed(n, seed):
    """Bytes with a skewed histogram: codes of many widths, up to 16."""
    rng = np.random.default_rng(seed)
    return np.minimum(rng.geometric(0.08, n) - 1, 255).astype(np.uint8)


def _pan(seed, t=T, h=H, w=W, c=None):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 90 + 40 * np.sin(xx / 4.0) + 30 * np.cos(yy / 3.0)
    img = np.clip(base + rng.normal(0, 5, (h, w)), 0, 255).astype(np.uint8)
    frames = np.stack([np.roll(img, (i, 2 * i), (0, 1)) for i in range(t)])
    if c is None:
        return frames
    return np.stack([frames + 17 * k for k in range(c)], -1).astype(np.uint8)


# -- the bindings --------------------------------------------------------------

PRECODERS = ("none", "delta", "delta2d")


def _encoded(block_size, precoder, seed=0):
    """(source blocks, the stream of their payload); the payload has a tail
    of 11 symbols past the last whole block."""
    data = _skewed(block_size * 37 + 11, seed)
    nb = data.size // block_size
    src = data[: nb * block_size]
    if precoder == "delta":
        payload = native.delta_encode(data, block_size)
    elif precoder == "delta2d":
        bd = int(round(block_size ** 0.5))
        payload = np.concatenate([native.delta2d_encode(src, bd),
                                  data[nb * block_size:]])
    else:
        payload = data
    return src.reshape(nb, block_size), native.encode_symbols(
        payload, block_size=block_size)


@pytest.mark.parametrize("threads", [1, 3, 0])
@pytest.mark.parametrize("precoder", PRECODERS)
@pytest.mark.parametrize("block_size", [4, 16, 64, 256])
def test_decode_blocks_matches_jax(block_size, precoder, threads):
    src, stream = _encoded(block_size, precoder, seed=block_size)
    kw = dict(delta=precoder == "delta", block_size=block_size,
              n_threads=threads, delta2d=precoder == "delta2d")
    ours = native.decode_blocks(stream, **kw)
    assert ours.dtype == np.uint8 and ours.shape == src.shape
    np.testing.assert_array_equal(ours, jnative.decode_blocks(stream, **kw))
    np.testing.assert_array_equal(ours, src)


@pytest.mark.parametrize("block_size", [4, 64])
def test_a_stream_shorter_than_a_block_decodes_no_blocks(block_size):
    stream = native.encode_symbols(_skewed(block_size - 1, 5),
                                   block_size=block_size)
    assert stream.block_offsets.size == 0
    ours = native.decode_blocks(stream, block_size=block_size)
    assert ours.shape == (0, block_size) and ours.dtype == np.uint8
    assert jnative.decode_blocks(stream, block_size=block_size).shape == \
        ours.shape


@pytest.mark.parametrize("k1", [4, 8, 11, 12])
def test_serial_decoders_and_split_tables_match_jax(k1):
    data = _skewed(64 * 40, 7)
    stream = native.encode_symbols(data)
    ours = native.build_split_tables(stream.widths, k1, 16 - k1)
    ref = jnative.build_split_tables(stream.widths, k1, 16 - k1)
    for f in ("t1_symbol", "t1_width", "t2_symbol", "t2_width"):
        np.testing.assert_array_equal(getattr(ours, f), getattr(ref, f))
    assert (ours.k1, ours.k2, ours.num_t2_tables) == (ref.k1, ref.k2,
                                                      ref.num_t2_tables)
    if k1 == tables.K1:  # the port's own numpy tables at their fixed split
        own = tables.build_split_tables(stream.widths)
        for f in ("t1_symbol", "t1_width", "t2_symbol", "t2_width"):
            np.testing.assert_array_equal(getattr(ours, f), getattr(own, f))
    rng = np.random.default_rng(k1)
    starts = list(range(8)) + [int(b) for b in rng.choice(
        stream.block_offsets[:-4], 5)]
    for sb in starts:
        n = 150
        got = native.decode_serial_split(stream.code_bytes, stream.widths, n,
                                         sb, k1)
        np.testing.assert_array_equal(got, jnative.decode_serial_split(
            stream.code_bytes, stream.widths, n, sb, k1))
        np.testing.assert_array_equal(got, native.decode_serial(
            stream.code_bytes, stream.widths, n, sb))
        np.testing.assert_array_equal(got, jnative.decode_serial(
            stream.code_bytes, stream.widths, n, sb))
    whole = native.decode_serial(stream.code_bytes, stream.widths, data.size)
    np.testing.assert_array_equal(whole, data)
    with pytest.raises(ValueError, match="k1 \\+ k2"):
        native.build_split_tables(stream.widths, k1, 17 - k1)


@pytest.mark.parametrize("block_dim", [2, 4, 8, 16])
def test_delta_inverses_match_jax(block_dim):
    bs = block_dim * block_dim
    data = _skewed(bs * 9 + 3, block_dim)
    d1 = native.delta_encode(data, bs)
    np.testing.assert_array_equal(native.delta_decode(d1, bs), data)
    np.testing.assert_array_equal(native.delta_decode(d1, bs),
                                  jnative.delta_decode(d1, bs))
    whole = data[: bs * 9]
    d2 = native.delta2d_encode(whole, block_dim)
    np.testing.assert_array_equal(native.delta2d_decode(d2, block_dim), whole)
    np.testing.assert_array_equal(native.delta2d_decode(d2, block_dim),
                                  jnative.delta2d_decode(d2, block_dim))
    with pytest.raises(ValueError, match="whole number of blocks"):
        native.delta2d_decode(data, block_dim)
    with pytest.raises(ValueError, match="whole number of blocks"):
        jnative.delta2d_decode(data, block_dim)


def test_a_truncated_code_buffer_raises_runtime_error():
    _src, stream = _encoded(64, "delta")
    cut = dataclasses.replace(stream, code_bytes=stream.code_bytes[:-40])
    for pkg in (native, jnative):
        with pytest.raises(RuntimeError, match="mht_decode_blocks failed"):
            pkg.decode_blocks(cut, n_threads=3)
        with pytest.raises(RuntimeError, match="mht_decode_serial failed"):
            pkg.decode_serial(cut.code_bytes, cut.widths, stream.num_symbols)
        with pytest.raises(RuntimeError,
                           match="mht_decode_serial_split failed"):
            pkg.decode_serial_split(cut.code_bytes, cut.widths,
                                    stream.num_symbols, 0, 11)
    # a window that matches no code: a one-symbol table read past its code
    one = native.encode_symbols(np.full(128, 7, np.uint8))
    junk = dataclasses.replace(one, code_bytes=np.full(
        one.code_bytes.size, 0xFF, np.uint8))
    with pytest.raises(RuntimeError, match="-6"):
        native.decode_blocks(junk)
    with pytest.raises(RuntimeError, match="-6"):
        jnative.decode_blocks(junk)


def test_a_failed_build_raises_with_no_fallback(monkeypatch, tmp_path):
    stream = tfs.encode_frames_shared(_pan(1))  # encoded before the break
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "SRC", bad)
    monkeypatch.setattr(native, "_LIB", None)

    def plain(*_a, **_k):
        raise AssertionError("the native route fell back to a plain decode")

    monkeypatch.setattr(decode_cuda, "decode_images", plain)
    monkeypatch.setattr(decode_cuda, "decode_blocks", plain)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        native.decode_blocks(stream)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed"):
        tfs.decode_frames_shared(stream, T, H, W, device="native")
    assert not list((tmp_path / "build").iterdir())


def test_native_is_never_chosen_for_the_caller():
    assert not native.is_native("cpu") and not native.is_native("cuda")
    assert not native.is_native(torch.device("cpu"))
    assert native.is_native("native")
    import inspect

    for fn in (mt.decode_video, mt.decode_image, mt.decode_color_image,
               mt.decode_color_video, tfs.decode_range,
               tfs.decode_video_region, ttemporal.decode_temporal_range):
        assert inspect.signature(fn).parameters["device"].default == "cuda"


# -- the routes ---------------------------------------------------------------

IMAGE_CONFIGS = {
    "bd2": dict(block_dim=2),
    "bd4-none": dict(block_dim=4, delta=False),
    "bd8": dict(),
    "bd8-delta2d": dict(delta2d=True),
    "bd8-zero-init": dict(zero_init=True),
    "bd16-delta2d-zero-init": dict(block_dim=16, delta2d=True,
                                   zero_init=True),
}


@pytest.mark.parametrize("name", IMAGE_CONFIGS)
def test_mht1_images_and_regions(name):
    kw = IMAGE_CONFIGS[name]
    img = _pan(2, t=1, h=37, w=53)[0]
    blob = mt.encode_image(img, CodecConfig(**kw))
    ours = mt.decode_image(blob, device="native")
    np.testing.assert_array_equal(ours, img)
    np.testing.assert_array_equal(ours, jmt.decode_image(blob, JN))
    np.testing.assert_array_equal(ours, mt.decode_image(blob, device="cpu"))
    cfg = CodecConfig(**kw)
    stream = ImageCodec(cfg).encode(img)
    jcodec = JaxImageCodec(JaxConfig(backend="native", **kw))
    for region in [(3, 5, 20, 31), (0, 0, 37, 53), (36, 52, 1, 1)]:
        for check in (False, True):
            got = ImageCodec(cfg).decode_region(stream, 37, 53, *region,
                                                check=check, device="native")
            y0, x0, rh, rw = region
            np.testing.assert_array_equal(got, img[y0:y0 + rh, x0:x0 + rw])
            np.testing.assert_array_equal(got, jcodec.decode_region(
                stream, 37, 53, *region, check=check))
            np.testing.assert_array_equal(got, ImageCodec(cfg).decode_region(
                stream, 37, 53, *region, check=check, device="cpu"))
    prep = ImageCodec(cfg).prepare(stream, 37, 53, device="native")
    assert isinstance(prep, tfs.PreparedNative)
    step = ImageCodec(cfg).decode_step(prep)
    assert step.device.type == "cpu"
    np.testing.assert_array_equal(step.numpy(), img)


def _flip(stream, bit):
    code = stream.code_bytes.copy()
    code[bit // 8] ^= 128 >> (bit % 8)
    return dataclasses.replace(stream, code_bytes=code)


def _raised(fn):
    try:
        fn()
    except (ValueError, RuntimeError) as e:
        return type(e), str(e)
    return None


@pytest.mark.parametrize("name", ["bd8", "bd4-none", "bd8-delta2d"])
def test_region_check_flip_inside_raises_and_outside_passes(name):
    kw = IMAGE_CONFIGS[name]
    img = _pan(3, t=1, h=40, w=48)[0]
    cfg = CodecConfig(**kw)
    stream = ImageCodec(cfg).encode(img)
    jcodec = JaxImageCodec(JaxConfig(backend="native", **kw))
    bd = cfg.block_dim
    region = (bd, bd, 2 * bd, 2 * bd)  # blocks (1, 1)..(2, 2)
    bw = -(-48 // bd)
    inside = int(stream.block_offsets[1 * bw + 1])
    outside = int(stream.block_offsets[-2])

    def ours(s):
        return ImageCodec(cfg).decode_region(s, 40, 48, *region, check=True,
                                             device="native")

    def theirs(s):
        return jcodec.decode_region(s, 40, 48, *region, check=True)

    caught = None
    for bit in range(inside, inside + 64):
        bad = _flip(stream, bit)
        want = _raised(lambda: theirs(bad))
        got = _raised(lambda: ours(bad))
        assert got == want, bit
        if want is not None:
            caught = want
            break
    assert caught is not None, "no flip inside the region was detected"
    bad = _flip(stream, outside)
    np.testing.assert_array_equal(ours(bad), img[bd:3 * bd, bd:3 * bd])
    np.testing.assert_array_equal(ours(bad), theirs(bad))


@pytest.fixture(scope="module")
def videos():
    """Port-written containers (the port's host encoders are byte-equal to
    the JAX package's), with their sources."""
    frames = _pan(4)
    cfg = CodecConfig(frame_crcs=True)
    crc = zlib.crc32(frames.tobytes())
    segs = tfs.encode_frames_segmented(frames, cfg,
                                       max_segment_bits=2 * H * W * 10)
    assert len(segs) > 1
    mhv2 = tfs.write_segmented(segs, H, W, cfg, source_crc32=crc,
                               frame_crcs=tfs.compute_frame_crcs(frames))
    zi = CodecConfig(zero_init=True, delta2d=True)
    rgb = _pan(5, c=3)
    u16 = (frames.astype(np.uint16) * 37 + 11)
    return {
        "frames": frames, "rgb": rgb, "u16": u16,
        "mhtv": mt.encode_video(frames, cfg),
        "mhtv-zero-init": mt.encode_video(frames, zi),
        "mhv2": mhv2,
        "mhts": tfs.write_stream(
            tfs.encode_frames(frames), H, W,
            source_crc32s=[zlib.crc32(f.tobytes()) for f in frames]),
        "mhvt": mt.encode_video(frames, CodecConfig(temporal=True, keyint=4,
                                                    frame_crcs=True)),
        "mhvt-mc": mt.encode_video(frames, CodecConfig(
            temporal=True, keyint=4, motion=True, frame_crcs=True)),
        "mhvt-color": mt.encode_color_video(rgb, CodecConfig(
            temporal=True, keyint=3)),
        "mhvt-u16": ttemporal.encode_temporal_gray16_video(
            u16, CodecConfig(temporal=True, keyint=3)),
        "mhtc-video": tcolor.encode_color_video_to_bytes(
            rgb, colorspace=tcolor.CS_SUBGREEN),
        "mhtc-image": tcolor.encode_color_to_bytes(rgb[0]),
        "mhtc-u16": tcolor.encode_gray16_to_bytes(u16),
    }


WHOLE = {
    # name: (port decode(blob, device), JAX decode(blob, config), source)
    "mhtv": (mt.decode_video, jmt.decode_video, "frames"),
    "mhtv-zero-init": (mt.decode_video, jmt.decode_video, "frames"),
    "mhv2": (mt.decode_video, jmt.decode_video, "frames"),
    "mhvt": (mt.decode_video, jmt.decode_video, "frames"),
    "mhvt-mc": (mt.decode_video, jmt.decode_video, "frames"),
    "mhvt-color": (mt.decode_color_video, jmt.decode_color_video, "rgb"),
    "mhvt-u16": (mt.decode_video, jmt.decode_video, "u16"),
    "mhtc-video": (mt.decode_color_video, jmt.decode_color_video, "rgb"),
    "mhtc-image": (mt.decode_color_image, jmt.decode_color_image,
                   lambda v: v["rgb"][0]),
    "mhtc-u16": (tcolor.decode_gray16_from_bytes,
                 jcolor.decode_gray16_from_bytes, "u16"),
}


@pytest.mark.parametrize("name", WHOLE)
def test_whole_decodes(name, videos):
    ours_fn, jax_fn, src = WHOLE[name]
    want = src(videos) if callable(src) else videos[src]
    blob = videos[name]
    got = ours_fn(blob, "native")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, jax_fn(blob, JN))
    np.testing.assert_array_equal(got, ours_fn(blob, "cpu"))


def test_mhts_frames(videos):
    blob, frames = videos["mhts"], videos["frames"]
    ours = list(tfs.iter_stream_frames(blob, device="native"))
    theirs = list(jfs.iter_stream_frames(blob, JN))
    assert [i for i, *_ in ours] == list(range(T))
    for (i, f, err, crc), (_j, g, _e, jcrc) in zip(ours, theirs):
        assert err is None and crc == jcrc == zlib.crc32(frames[i].tobytes())
        np.testing.assert_array_equal(f, frames[i])
        np.testing.assert_array_equal(f, g)
    got, h, w = tfs.decode_range(blob, 1, 5, device="native")
    np.testing.assert_array_equal(got, frames[1:5])
    np.testing.assert_array_equal(got, jfs.decode_range(blob, 1, 5, JN)[0])
    np.testing.assert_array_equal(got, tfs.decode_range(blob, 1, 5,
                                                        device="cpu")[0])


RANGES = {"mhtv": (1, 5), "mhv2": (1, 6), "mhtv-zero-init": (0, 3)}


@pytest.mark.parametrize("name", RANGES)
def test_decode_range_frame_and_region(name, videos):
    blob, frames = videos[name], videos["frames"]
    a, b = RANGES[name]
    got, h, w = tfs.decode_range(blob, a, b, device="native")
    np.testing.assert_array_equal(got, frames[a:b])
    np.testing.assert_array_equal(got, jfs.decode_range(blob, a, b, JN)[0])
    np.testing.assert_array_equal(
        got, tfs.decode_range(blob, a, b, device="cpu")[0])
    lazy, _h, _w = tfs.decode_range(blob, a, b, to_host=False,
                                    device="native")
    assert isinstance(lazy, torch.Tensor) and lazy.device.type == "cpu"
    np.testing.assert_array_equal(lazy.numpy(), frames[a:b])
    if name != "mhv2":
        stream, t, h, w, bd, delta = tfs.read_shared(blob)
        cfg = CodecConfig(block_dim=bd, delta=delta,
                          delta2d=stream.predictor == "2d")
        jcfg = JaxConfig(backend="native", block_dim=bd, delta=delta,
                         delta2d=stream.predictor == "2d")
        one = tfs.decode_frame(stream, b - 1, h, w, cfg, device="native")
        np.testing.assert_array_equal(one, frames[b - 1])
        np.testing.assert_array_equal(
            one, jfs.decode_frame(stream, b - 1, h, w, jcfg))
    for check in (False, True):
        reg = tfs.decode_video_region(blob, a, b, 3, 5, 13, 29, check=check,
                                      device="native")
        np.testing.assert_array_equal(reg, frames[a:b, 3:16, 5:34])
        np.testing.assert_array_equal(reg, jfs.decode_video_region(
            blob, a, b, 3, 5, 13, 29, JN, check=check))
        np.testing.assert_array_equal(reg, tfs.decode_video_region(
            blob, a, b, 3, 5, 13, 29, check=check, device="cpu"))


@pytest.mark.parametrize("name", ["mhvt", "mhvt-mc", "mhvt-color",
                                  "mhvt-u16"])
def test_mhvt_random_access(name, videos):
    blob = videos[name]
    src = {"mhvt": "frames", "mhvt-mc": "frames", "mhvt-color": "rgb",
           "mhvt-u16": "u16"}[name]
    frames = videos[src]
    got = ttemporal.decode_temporal_range(blob, 2, 5, "native")
    np.testing.assert_array_equal(got, frames[2:5])
    np.testing.assert_array_equal(
        got, jtemporal.decode_temporal_range(blob, 2, 5, JN))
    np.testing.assert_array_equal(
        got, ttemporal.decode_temporal_range(blob, 2, 5, "cpu"))
    np.testing.assert_array_equal(
        ttemporal.decode_temporal_frame(blob, 5, "native"), frames[5])
    chunks = list(ttemporal.iter_temporal_video(blob, "native",
                                                chunk_frames=2))
    jchunks = list(jtemporal.iter_temporal_video(blob, JN, chunk_frames=2))
    assert [c[0] for c in chunks] == [c[0] for c in jchunks]
    np.testing.assert_array_equal(np.concatenate([c[1] for c in chunks]),
                                  frames)
    # the MC container checks its crop by its per-frame CRC table
    reg = ttemporal.decode_temporal_video_region(
        blob, 1, 6, 2, 3, 11, 17, check=True, device="native")
    np.testing.assert_array_equal(reg, frames[1:6, 2:13, 3:20])
    np.testing.assert_array_equal(reg, jtemporal.decode_temporal_video_region(
        blob, 1, 6, 2, 3, 11, 17, JN, check=True))


def test_mhtc_random_access(videos):
    blob, rgb = videos["mhtc-video"], videos["rgb"]
    got = tcolor.decode_color_frame(blob, 3, "native")
    np.testing.assert_array_equal(got, rgb[3])
    np.testing.assert_array_equal(got, jcolor.decode_color_frame(blob, 3, JN))
    reg = tcolor.decode_color_video_region(blob, 1, 4, 2, 6, 9, 21,
                                           check=True, device="native")
    np.testing.assert_array_equal(reg, rgb[1:4, 2:11, 6:27])
    np.testing.assert_array_equal(reg, jcolor.decode_color_video_region(
        blob, 1, 4, 2, 6, 9, 21, JN, check=True))


def test_corrupt_mhvt_raises_what_the_jax_package_raises(videos):
    blob = bytearray(videos["mhvt"])
    blob[-1] ^= 0x40  # the outer CRC: the inner verifies, the wrapper fails
    ours = _raised(lambda: mt.decode_video(bytes(blob), "native"))
    assert ours is not None and ours[0] is ValueError
    assert ours == _raised(lambda: jmt.decode_video(bytes(blob), JN))
    inner_bad = bytearray(videos["mhvt"])
    inner_bad[len(inner_bad) // 2] ^= 0x10  # inside the residual stream
    ours = _raised(lambda: mt.decode_video(bytes(inner_bad), "native"))
    assert ours is not None
    assert ours == _raised(lambda: jmt.decode_video(bytes(inner_bad), JN))


def test_the_native_route_never_reaches_a_plain_decode(monkeypatch, videos):
    def plain(*_a, **_k):
        raise AssertionError("device='native' reached a plain decode")

    for name in ("decode_images", "decode_blocks", "decode_images_plain",
                 "decode_blocks_plain"):
        if hasattr(decode_cuda, name):
            monkeypatch.setattr(decode_cuda, name, plain)
    for name in ("mhtv", "mhv2", "mhvt", "mhvt-mc", "mhvt-u16"):
        mt.decode_video(videos[name], "native")
    mt.decode_color_video(videos["mhtc-video"], "native")
    list(tfs.iter_stream_frames(videos["mhts"], device="native"))
    tfs.decode_video_region(videos["mhv2"], 0, 3, 1, 1, 9, 9, check=True,
                            device="native")
    img = videos["frames"][0]
    mt.decode_image(mt.encode_image(img, CodecConfig(block_dim=4)), "native")


# -- the refusals ---------------------------------------------------------------

def test_checked_paths_refuse_native_as_the_jax_package_does(videos):
    mhtv, mhv2, mhts = videos["mhtv"], videos["mhv2"], videos["mhts"]
    segs, _t, h, w, _bd, _d = tfs.read_segmented(mhv2)
    stream, t, h, w, _bd, _d = tfs.read_shared(mhtv)
    cases = [
        (lambda: list(tfs.iter_frames_segmented_checked(
            segs, h, w, device="native")),
         lambda: list(jfs.iter_frames_segmented_checked(segs, h, w, JN))),
        (lambda: tfs.decode_frames_segmented(segs, h, w, check=True,
                                             device="native"),
         lambda: jfs.decode_frames_segmented(segs, h, w, JN, check=True)),
        (lambda: tfs.decode_container_device(mhtv, device="native"),
         lambda: jfs.decode_container_device(mhtv, JN)),
        (lambda: list(tfs.iter_stream_frames(mhts, check=True,
                                             device="native")),
         lambda: list(jfs.iter_stream_frames(mhts, JN, check=True))),
    ]
    for ours, theirs in cases:
        got, want = _raised(ours), _raised(theirs)
        assert got is not None and want is not None
        assert got[0] is want[0] is ValueError
    with pytest.raises(ValueError, match="device decode path"):
        tfs.prepare_shared(stream, t, h, w, device="native", check=True)
    prep = tfs.prepare_shared(stream, t, h, w, device="native")
    with pytest.raises(ValueError, match="check=True"):
        tfs.decode_shared_step_checked(prep)
