"""Slice-level parity of the port (metalhuffman_tpu_torch) with the JAX
package: encode, container I/O and decode of shared-table (MHTV) batches.

The JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU); the port runs its plain PyTorch path on CPU tensors. Every comparison
is exact byte equality.
"""

import struct
import zlib

import numpy as np
import pytest

import metalhuffman_tpu
import metalhuffman_tpu_torch
from metalhuffman_tpu import native
from metalhuffman_tpu.core import blocks, container, delta
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig

CONFIGS = {
    "none": {"delta": False},
    "delta": {},
    "zero_init": {"zero_init": True},
    "delta2d": {"delta2d": True},
    "zero_init_delta2d": {"zero_init": True, "delta2d": True},
}
# 20 rows x 600 columns: padded to 3 block rows, and 75 block columns that
# the JAX package pads to a 128-lane row (its ImagePlan) and the port does not
SHAPE = (2, 20, 600)


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def _jax_cfg(**kw):
    return JaxConfig(backend="pallas", interpret=True, **kw)


def _assert_streams_equal(a, b):
    assert a.num_symbols == b.num_symbols
    assert a.predictor == b.predictor
    for field in ("widths", "code_bytes", "block_offsets"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    if a.block_init is None:
        assert b.block_init is None
    else:
        np.testing.assert_array_equal(a.block_init, b.block_init)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_frames_shared_is_byte_identical(name):
    frames = _frames(3, 24, 40, seed=len(name))
    ours = tfs.encode_frames_shared(frames, CodecConfig(**CONFIGS[name]))
    ref = jfs.encode_frames_shared(frames, _jax_cfg(**CONFIGS[name]))
    _assert_streams_equal(ours, ref)


@pytest.mark.parametrize("crc", [0, 0xDEADBEEF], ids=["no-crc", "crc"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_write_shared_is_byte_identical(name, crc):
    frames = _frames(2, 16, 24, seed=7)
    stream = jfs.encode_frames_shared(frames, _jax_cfg(**CONFIGS[name]))
    ours = tfs.write_shared(stream, 2, 16, 24, CodecConfig(**CONFIGS[name]),
                            source_crc32=crc)
    ref = jfs.write_shared(stream, 2, 16, 24, _jax_cfg(**CONFIGS[name]),
                           source_crc32=crc)
    assert ours == ref
    assert ours[21] == list(CONFIGS).index(name)  # the mode byte
    assert tfs.source_crc32(ours) == jfs.source_crc32(ref) == crc


@pytest.mark.parametrize("name", list(CONFIGS))
def test_read_shared_matches_jax(name):
    frames = _frames(2, 16, 24, seed=8)
    stream = jfs.encode_frames_shared(frames, _jax_cfg(**CONFIGS[name]))
    blob = jfs.write_shared(stream, 2, 16, 24, _jax_cfg(**CONFIGS[name]))
    ours, *geo = tfs.read_shared(blob)
    ref, *ref_geo = jfs.read_shared(blob)
    assert geo == ref_geo
    _assert_streams_equal(ours, ref)


def _cut_points(blob: bytes) -> dict:
    """Where to cut an MHTV blob: inside the core, inside the offset index,
    inside block_init (zero-init modes only) and inside the CRC trailer."""
    _t, _h, _w, nb, _bd, mode = struct.unpack_from("<IIIIBB", blob, 4)
    (core_len,) = struct.unpack_from("<I", blob, 22)
    index = 26 + core_len
    cuts = {"header": 20, "core": 26 + core_len // 2, "index": index + 2 * nb,
            "index end": index + 4 * nb - 1, "crc": len(blob) - 2}
    if mode in (2, 4):
        cuts["block_init"] = index + 4 * nb + nb // 2
    return cuts


@pytest.mark.parametrize("name", ["delta", "zero_init", "zero_init_delta2d"])
def test_read_shared_of_a_cut_blob_matches_jax(name):
    # the reference's own truncation checks cannot fire: np.frombuffer with
    # a count raises first, so both readers raise numpy's error, or parse
    # the same stream when only the CRC trailer is cut
    frames = _frames(2, 16, 24, seed=9)
    stream = jfs.encode_frames_shared(frames, _jax_cfg(**CONFIGS[name]))
    blob = jfs.write_shared(stream, 2, 16, 24, _jax_cfg(**CONFIGS[name]),
                            source_crc32=zlib.crc32(frames.tobytes()))
    cuts = _cut_points(blob)
    assert ("block_init" in cuts) == (name != "delta")
    for where, at in cuts.items():
        cut = blob[:at]
        try:
            ref = jfs.read_shared(cut)
        except Exception as e:  # noqa: BLE001 - the port must raise the same
            with pytest.raises(type(e)) as ours:
                tfs.read_shared(cut)
            assert str(ours.value) == str(e), where
            assert where != "crc"
            continue
        ours, *geo = tfs.read_shared(cut)
        assert geo == list(ref[1:]), where
        _assert_streams_equal(ours, ref[0])
        assert where == "crc"


@pytest.fixture(scope="module")
def delta_batch():
    """One delta batch shared by the decode tests (one JAX compile each for
    the raw and the image form)."""
    t, h, w = SHAPE
    frames = _frames(t, h, w, seed=11)
    stream = jfs.encode_frames_shared(frames, _jax_cfg())
    jprep = jfs.prepare_shared(stream, t, h, w, _jax_cfg())
    assert jprep.h2  # the JAX side runs decode_tiles_images
    return frames, stream, jprep


def test_decode_shared_step_raw_matches_jax(delta_batch):
    frames, stream, jprep = delta_batch
    t, h, w = SHAPE
    ref = jfs.frames_from_raw(
        jfs.decode_shared_step(jprep, _jax_cfg(), raw=True), t, h, w,
        w_pad=jprep.w_pad, bh=jprep.bh)
    prep = tfs.prepare_shared(stream, t, h, w, CodecConfig(), device="cpu")
    raw = tfs.decode_shared_step(prep, CodecConfig(), raw=True)
    assert raw.shape == (t, 24, 600)  # padded only to whole 8x8 blocks
    view = tfs.frames_from_raw(raw, t, h, w)
    assert view.data_ptr() == raw.data_ptr()  # a view, not a copy
    np.testing.assert_array_equal(view.numpy(), ref)
    np.testing.assert_array_equal(ref, frames)


def test_decode_shared_step_image_matches_jax(delta_batch):
    frames, stream, jprep = delta_batch
    t, h, w = SHAPE
    ref = np.asarray(jfs.decode_shared_step(jprep, _jax_cfg()))
    out = tfs.decode_frames_shared(stream, t, h, w, device="cpu")
    assert out.is_contiguous() and out.shape == (t, h, w)
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, frames)


def test_zero_init_image_form_matches_jax(delta_batch):
    # the zero-init form of the delta batch, coded with the delta batch's
    # table: the JAX side then reuses the image-form compile
    frames, delta_stream, _ = delta_batch
    t, h, w = SHAPE
    payload = np.concatenate([
        native.delta_encode(blocks.image_to_blocks(f).ravel(), 64)
        for f in frames])
    init, zeroed = delta.split_zero_init(payload.reshape(-1, 64))
    coded = native.encode_symbols(zeroed.reshape(-1),
                                  widths=delta_stream.widths)
    stream = container.EncodedStream(
        coded.num_symbols, coded.widths, coded.code_bytes,
        coded.block_offsets, block_init=init)
    ref = np.asarray(jfs.decode_frames_shared(
        stream, t, h, w, _jax_cfg(zero_init=True)))
    prep = tfs.prepare_shared(stream, t, h, w, CodecConfig(zero_init=True),
                              device="cpu")
    out = tfs.decode_shared_step(prep, CodecConfig(zero_init=True))
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, frames)
    with pytest.raises(ValueError, match="zero-init"):
        tfs.decode_shared_step(prep, CodecConfig(zero_init=True), raw=True)


def test_decode_video_matches_jax(delta_batch):
    frames, stream, _ = delta_batch
    t, h, w = SHAPE
    blob = jfs.write_shared(stream, t, h, w, _jax_cfg(),
                            source_crc32=zlib.crc32(frames.tobytes()))
    ref = metalhuffman_tpu.decode_video(blob)
    ours = metalhuffman_tpu_torch.decode_video(blob, "cpu")
    assert ours.dtype == np.uint8
    np.testing.assert_array_equal(ours, ref)
    np.testing.assert_array_equal(ours, frames)
    bad = blob[:-4] + bytes(b ^ 0xFF for b in blob[-4:])
    with pytest.raises(ValueError, match="CRC-32 mismatch"):
        metalhuffman_tpu_torch.decode_video(bad, "cpu")


def test_port_roundtrip_through_its_own_writer():
    frames = _frames(3, 13, 21, seed=13)
    for name, kw in CONFIGS.items():
        cfg = CodecConfig(**kw)
        stream = tfs.encode_frames_shared(frames, cfg)
        blob = tfs.write_shared(stream, 3, 13, 21, cfg,
                                source_crc32=zlib.crc32(frames.tobytes()))
        out = metalhuffman_tpu_torch.decode_video(blob, "cpu")
        np.testing.assert_array_equal(out, frames, err_msg=name)


def test_unported_containers_and_block_dims_raise():
    # MHVT is ported: a wrapper with keyint 0 raises the JAX package's error
    for decode in (lambda b: metalhuffman_tpu_torch.decode_video(b, "cpu"),
                   lambda b: metalhuffman_tpu.decode_video(
                       b, JaxConfig(backend="native"))):
        with pytest.raises(ValueError, match="keyint 0"):
            decode(b"MHVT" + bytes(32))
    # MHV2 is ported: a segmented blob of the JAX package decodes to its
    # frames, as the JAX package's own host decoder gives them
    frames = _frames(3, 16, 24, seed=14)
    jcfg = JaxConfig(backend="native")
    segs = jfs.encode_frames_segmented(frames, jcfg,
                                       max_segment_bits=2 * 16 * 24 * 10)
    assert [t for _, t in segs] == [2, 1]
    blob = jfs.write_segmented(segs, 16, 24, jcfg,
                               source_crc32=zlib.crc32(frames.tobytes()))
    ours = metalhuffman_tpu_torch.decode_video(blob, "cpu")
    np.testing.assert_array_equal(ours, metalhuffman_tpu.decode_video(blob, jcfg))
    np.testing.assert_array_equal(ours, frames)
    # the kernels take 4 symbols per refill: blocks of 2, 4, 8 or 16 only
    # (the JAX package's XLA path also decodes odd sizes)
    for bd in (1, 3, 6, 32):
        with pytest.raises(ValueError, match="block_dim"):
            CodecConfig(block_dim=bd)
    frames = _frames(1, 12, 12)
    stream = jfs.encode_frames_shared(frames, _jax_cfg(block_dim=3))
    blob = jfs.write_shared(stream, 1, 12, 12, _jax_cfg(block_dim=3))
    with pytest.raises(ValueError, match="block_dim"):
        metalhuffman_tpu_torch.decode_video(blob, "cpu")
