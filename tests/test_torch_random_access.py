"""Slice-level parity of the port with the JAX package on random access:
``frame_slice``, ``decode_frame``, ``decode_range`` (MHTV, MHV2 across
segments, MHTS, with the per-frame CRCs), ``decode_container_device`` and the
spatio-temporal ``decode_video_region`` with its end-bit check.

The JAX side runs its host C++ decoder (``backend="native"``); the port runs
its plain PyTorch path on CPU tensors. Every comparison is exact.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

import metalhuffman_tpu
from metalhuffman_tpu.core import bitstream as jbitstream
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import decode_cuda

NATIVE = JaxConfig(backend="native")
H, W = 24, 40
#: two 24x40 frames per MHV2 segment (10 bits per symbol)
TWO_FRAMES = 2 * H * W * 10


def _frames(t, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w), np.uint8)
    smooth = np.clip(100 + 60 * np.sin(np.arange(w) / 7.0)[None, :]
                     + rng.normal(0, 3, (h, w)), 0, 255).astype(np.uint8)
    # half noise, half smooth: codes of several lengths, so a flipped bit
    # desynchronises the decode
    img = np.where(np.arange(w)[None, :] < w // 2, base, smooth)
    return np.stack([np.roll(img, (3 * i, 5 * i), (0, 1)) for i in range(t)])


def _blobs(frames, fcrc=True, **kw):
    """{container: blob} of ``frames``: MHTV, MHV2 (two frames per segment)
    and MHTS, all written by the JAX package with source and frame CRCs."""
    cfg = dataclasses.replace(NATIVE, **kw)
    t, h, w = frames.shape
    crc = zlib.crc32(frames.tobytes())
    fcrcs = jfs.compute_frame_crcs(frames) if fcrc else None
    segs = jfs.encode_frames_segmented(frames, cfg, max_segment_bits=2 * h * w * 10)
    return {
        "MHTV": jfs.write_shared(jfs.encode_frames_shared(frames, cfg), t, h,
                                 w, cfg, source_crc32=crc, frame_crcs=fcrcs),
        "MHV2": jfs.write_segmented(segs, h, w, cfg, source_crc32=crc,
                                    frame_crcs=fcrcs),
        "MHTS": jfs.write_stream(
            jfs.encode_frames(frames, cfg), h, w, cfg,
            source_crc32s=[zlib.crc32(f.tobytes()) for f in frames]),
    }


@pytest.fixture(scope="module")
def clip():
    frames = _frames(5, seed=1)
    return frames, _blobs(frames)


def test_frame_slice_matches_jax():
    frames = _frames(4, seed=2)
    for bd in (8, 4):
        stream = jfs.encode_frames_shared(frames, JaxConfig(block_dim=bd,
                                                            zero_init=True))
        for t0, num in ((0, 4), (1, 2), (3, 1)):
            ours = tfs.frame_slice(stream, t0, num, H, W,
                                   CodecConfig(block_dim=bd))
            ref = jfs.frame_slice(stream, t0, num, H, W,
                                  JaxConfig(block_dim=bd))
            assert ours.num_symbols == ref.num_symbols
            assert ours.block_offsets.dtype == np.uint32
            assert ours.code_bytes is stream.code_bytes  # zero copy
            np.testing.assert_array_equal(ours.block_offsets,
                                          ref.block_offsets)
            np.testing.assert_array_equal(ours.block_init, ref.block_init)
        for t0, num in ((-1, 1), (3, 2)):
            with pytest.raises(ValueError, match="out of range"):
                tfs.frame_slice(stream, t0, num, H, W,
                                CodecConfig(block_dim=bd))


def test_a_slice_stages_only_its_own_words():
    frames = _frames(4, seed=3)
    stream = tfs.encode_frames_shared(frames)
    whole = tfs.prepare_shared(stream, 4, H, W, device="cpu")
    view = tfs.frame_slice(stream, 2, 1, H, W)
    prep = tfs.prepare_shared(view, 1, H, W, device="cpu")
    first = int(view.block_offsets[0])
    assert prep.words.numel() < whole.words.numel() // 2
    # offsets rebased by whole words: every & 31 and every difference kept
    rebased = prep.offsets.numpy().view(np.uint32).astype(np.int64)
    np.testing.assert_array_equal(
        rebased, view.block_offsets.astype(np.int64) - (first & ~31))
    np.testing.assert_array_equal(
        prep.words.numpy()[:8], whole.words.numpy()[first >> 5 :][:8])
    np.testing.assert_array_equal(tfs.decode_shared_step(prep).numpy(),
                                  frames[2:3])
    # a whole stream stages all its words, as before
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    np.testing.assert_array_equal(whole.words.numpy(), words)
    np.testing.assert_array_equal(whole.offsets.numpy(), offsets)


def test_stage_words_equals_the_host_word_view():
    rng = np.random.default_rng(4)
    codes = [rng.integers(0, 256, n, dtype=np.uint8) for n in (0, 1, 7, 64, 1001)]
    words, starts = decode_cuda.stage_words(codes, "cpu")
    assert words.dtype == torch.int32 and words.is_contiguous()
    ends = starts[1:] + [words.numel()]
    for c, a, b in zip(codes, starts, ends):
        want = jbitstream.bytes_to_be_words(c, pad_words=decode_cuda.PAD_WORDS)
        np.testing.assert_array_equal(words[a:b].numpy().view(np.uint32), want)


@pytest.mark.parametrize("container", ["MHTV", "MHV2"])
def test_decode_frame_matches_jax(clip, container):
    frames, blobs = clip
    if container == "MHTV":
        stream, *_ = jfs.read_shared(blobs["MHTV"])
        cases = [(stream, t, t) for t in range(5)]
    else:
        segs, *_ = jfs.read_segmented(blobs["MHV2"])
        cases = [(segs[t // 2][0], t % 2, t) for t in range(5)]
    for stream, t, frame in cases:
        ours = tfs.decode_frame(stream, t, H, W, device="cpu")
        assert ours.shape == (H, W) and ours.dtype == np.uint8
        np.testing.assert_array_equal(
            ours, jfs.decode_frame(stream, t, H, W, NATIVE))
        np.testing.assert_array_equal(ours, frames[frame])


@pytest.mark.parametrize("a,b", [(0, 5), (1, 3), (1, 4), (3, 4), (4, 5)])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_decode_range_matches_jax(clip, container, a, b):
    # MHV2 ranges (1, 3) and (1, 4) straddle segments [0, 2), [2, 4), [4, 5)
    frames, blobs = clip
    ours, h, w = tfs.decode_range(blobs[container], a, b, device="cpu")
    ref, rh, rw = jfs.decode_range(blobs[container], a, b, NATIVE)
    assert (h, w) == (rh, rw) == (H, W)
    assert isinstance(ours, np.ndarray) and ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, frames[a:b])
    dev, *_ = tfs.decode_range(blobs[container], a, b, to_host=False,
                               device="cpu")
    assert isinstance(dev, torch.Tensor) and dev.shape == (b - a, H, W)
    np.testing.assert_array_equal(dev.numpy(), frames[a:b])


@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_decode_range_parsed_and_bounds(clip, container):
    frames, blobs = clip
    parsed = tfs.parse_range_container(blobs[container])
    for a, b in ((0, 2), (2, 5)):
        got, *_ = tfs.decode_range_parsed(parsed, a, b, device="cpu")
        np.testing.assert_array_equal(got, frames[a:b])
    for a, b in ((-1, 2), (2, 2), (3, 6)):
        with pytest.raises(ValueError, match="out of range"):
            tfs.decode_range(blobs[container], a, b, device="cpu")
        with pytest.raises(ValueError, match="out of range"):
            jfs.decode_range(blobs[container], a, b, NATIVE)
    with pytest.raises(ValueError, match="MHTV/MHV2/MHTS"):
        tfs.parse_range_container(b"MHT1" + bytes(40))


@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_decode_range_checks_the_recorded_frame_crcs(clip, container):
    frames, blobs = clip
    blob = bytearray(blobs[container])
    if container == "MHTS":
        # frame 3's record CRC (MHT1 header bytes 18..22 of its record)
        pos = 8
        for _ in range(3):
            pos += 4 + int.from_bytes(blob[pos : pos + 4], "little")
        blob[pos + 4 + 18] ^= 0xFF
    else:
        at = tfs._trailer_offset(bytes(blob)) + 4 + 8 + 4 * 3
        blob[at] ^= 0xFF  # frame 3's entry of the FCRC table
    blob = bytes(blob)
    for decode in (lambda a, b: tfs.decode_range(blob, a, b, device="cpu"),
                   lambda a, b: jfs.decode_range(blob, a, b, NATIVE)):
        with pytest.raises(ValueError, match="frame 3 fails its recorded"):
            decode(2, 5)
        got, *_ = decode(0, 3)  # frames it does not return are not checked
        np.testing.assert_array_equal(got, frames[:3])
    # the device form skips the host check
    dev, *_ = tfs.decode_range(blob, 2, 5, to_host=False, device="cpu")
    np.testing.assert_array_equal(dev.numpy(), frames[2:5])


@pytest.mark.parametrize("container", ["MHTV", "MHV2"])
def test_decode_container_device_matches_jax(clip, container):
    frames, blobs = clip
    out = tfs.decode_container_device(blobs[container], device="cpu")
    assert isinstance(out, torch.Tensor) and out.device.type == "cpu"
    # the JAX package's decode_container_device needs a device backend;
    # its output is the container's frames, which decode_video gives on
    # the host decoder
    ref = metalhuffman_tpu.decode_video(blobs[container], NATIVE)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(out.numpy(), frames)
    with pytest.raises(ValueError, match="MHTV/MHV2"):
        tfs.decode_container_device(blobs["MHTS"], device="cpu")


REGIONS = [(0, 5, 0, 0, H, W), (1, 4, 5, 9, 13, 22), (4, 5, 16, 32, 8, 8),
           (1, 3, 7, 3, 1, 1)]


@pytest.mark.parametrize("check", [False, True], ids=["plain", "check"])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_decode_video_region_matches_jax(clip, container, check):
    frames, blobs = clip
    for a, b, y0, x0, rh, rw in REGIONS:
        ours = tfs.decode_video_region(blobs[container], a, b, y0, x0, rh,
                                       rw, check=check, device="cpu")
        ref = jfs.decode_video_region(blobs[container], a, b, y0, x0, rh, rw,
                                      NATIVE, check=check)
        assert ours.shape == (b - a, rh, rw) and ours.dtype == np.uint8
        np.testing.assert_array_equal(ours, ref)
        np.testing.assert_array_equal(
            ours, frames[a:b, y0:y0 + rh, x0:x0 + rw])
    for bad in ((0, 6, 0, 0, 8, 8), (0, 2, 20, 0, 8, 8), (0, 2, 0, -1, 8, 8)):
        with pytest.raises(ValueError, match="out of"):
            tfs.decode_video_region(blobs[container], *bad, device="cpu")


@pytest.mark.parametrize("name", ["delta2d", "zero_init", "4x4"])
def test_decode_video_region_precoders_match_jax(name):
    kw = {"delta2d": {"delta2d": True}, "zero_init": {"zero_init": True},
          "4x4": {"block_dim": 4}}[name]
    frames = _frames(5, seed=4)
    for container, blob in _blobs(frames, fcrc=False, **kw).items():
        ours = tfs.decode_video_region(blob, 1, 5, 3, 6, 17, 29, check=True,
                                       device="cpu")
        np.testing.assert_array_equal(ours, jfs.decode_video_region(
            blob, 1, 5, 3, 6, 17, 29, NATIVE, check=True))
        np.testing.assert_array_equal(ours, frames[1:5, 3:20, 6:35])


def _flipped(frames, container, frame, block, bit):
    """The container of ``frames`` (JAX-written, no CRCs) with code bit
    ``bit`` of block ``block`` of ``frame`` flipped (counted from the
    block's first bit) -> (blob, True if the bit lies inside the block)."""
    t, h, w = frames.shape
    per = (-(-h // 8)) * (-(-w // 8))

    def flip(stream, b):
        offs = stream.block_offsets.astype(np.int64)
        at = int(offs[b]) + bit
        code = stream.code_bytes.copy()
        code[at // 8] ^= 128 >> (at % 8)
        inside = b + 1 == offs.size or at < offs[b + 1]
        return dataclasses.replace(stream, code_bytes=code), inside

    if container == "MHTS":
        streams = jfs.encode_frames(frames, NATIVE)
        streams[frame], inside = flip(streams[frame], block)
        return jfs.write_stream(streams, h, w, NATIVE), inside
    if container == "MHTV":
        stream, inside = flip(jfs.encode_frames_shared(frames, NATIVE),
                              frame * per + block)
        return jfs.write_shared(stream, t, h, w, NATIVE), inside
    segs = jfs.encode_frames_segmented(frames, NATIVE,
                                       max_segment_bits=2 * h * w * 10)
    s, ft = segs[frame // 2]
    s, inside = flip(s, (frame % 2) * per + block)
    segs[frame // 2] = (s, ft)
    return jfs.write_segmented(segs, h, w, NATIVE), inside


@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_decode_video_region_check_flags_flips_inside_only(clip, container):
    # the region covers block rows 1-2 and columns 1-3 of frames 1-3; the
    # flips go into frame 2 (in MHV2, the second segment)
    frames, _ = clip
    a, b, y0, x0, rh, rw = 1, 4, 9, 10, 12, 17
    bw = -(-W // 8)
    region = dict(y0=y0, x0=x0, rh=rh, rw=rw)

    def both(blob):
        """(port raised, JAX raised), after holding clean results equal."""
        raised = []
        for decode in (
                lambda: tfs.decode_video_region(blob, a, b, **region,
                                                check=True, device="cpu"),
                lambda: jfs.decode_video_region(blob, a, b, **region,
                                                config=NATIVE, check=True)):
            try:
                out = decode()
            except ValueError as e:
                assert "integrity check failed" in str(e)
                # MHTS checks frame by frame (ImageCodec.decode_region)
                assert container == "MHTS" or "frames [2]" in str(e)
                raised.append(True)
                continue
            raised.append(False)
            assert out.shape == (b - a, rh, rw)
        return tuple(raised)

    caught = 0
    for bit in range(48):  # block (1, 2) of frame 2 lies in the region
        blob, inside = _flipped(frames, container, 2, 1 * bw + 2, bit)
        if not inside:
            break
        ours, ref = both(blob)
        assert ours == ref, bit
        caught += ours
    assert caught > 0
    # block (0, 4) of frame 2 lies outside the region: never decoded
    for bit in (0, 5, 11):
        blob, _ = _flipped(frames, container, 2, 0 * bw + 4, bit)
        assert both(blob) == (False, False)
        np.testing.assert_array_equal(
            tfs.decode_video_region(blob, a, b, **region, check=True,
                                    device="cpu"),
            frames[a:b, y0:y0 + rh, x0:x0 + rw])
