"""Slice-level parity of the port's single-image codec and checked decode
(metalhuffman_tpu_torch.models.image_codec, frame_stream's checked step,
encode_image/decode_image) with the JAX package.

The JAX side runs as its own tests run it (Pallas in interpret mode on the
CPU); the port runs its plain PyTorch path on CPU tensors. Every comparison
is exact: bytes, end-bit masks and raised errors. JAX's interpret compiles
cost seconds per canonical table (minutes for a 1-D delta over 16x16
blocks), so the JAX decodes below run on a few shared images; the port's
decode of every block size and precoder is held to the source image.
"""

import dataclasses
import zlib

import numpy as np
import pytest

import metalhuffman_tpu
import metalhuffman_tpu_torch
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import ImageCodec as JaxCodec
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import image_codec as jic
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import image_codec as tic
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.models.image_codec import ImageCodec

MODES = {
    "delta": {},
    "none": {"delta": False},
    "zero_init": {"zero_init": True},
    "delta2d": {"delta2d": True},
    "zero_init_delta2d": {"zero_init": True, "delta2d": True},
}
BLOCK_DIMS = (2, 4, 8, 16)


def _jax(**kw):
    return JaxConfig(backend="pallas", interpret=True, **kw)


def _random_image(h=64, w=96, seed=0):
    # the image of tests/test_block_dims.py: a shallow table, cheap compiles
    return np.random.default_rng(seed).integers(0, 200, (h, w), np.uint8)


def _photo_like(h, w, seed):
    # the image of tests/test_region_check.py: a deep delta table
    rng = np.random.default_rng(seed)
    base = np.cumsum(rng.normal(0, 4, (h, w)), axis=1)
    return (base - base.min()).clip(0, 255).astype(np.uint8)


def _corrupt_block(stream, b):
    """Zero block ``b``'s interior bytes (tests/test_region_check.py)."""
    offs = stream.block_offsets.astype(np.int64)
    end_bit = (int(offs[b + 1]) if b + 1 < offs.size
               else 8 * (stream.code_bytes.size - 2))
    lo, hi = int(offs[b]) // 8 + 1, end_bit // 8 - 1
    code = stream.code_bytes.copy()
    code[lo:hi] = 0
    return dataclasses.replace(stream, code_bytes=code)


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_encode_and_container_match_jax(bd, mode):
    img = _random_image(seed=bd)
    ours = ImageCodec(CodecConfig(block_dim=bd, **MODES[mode]))
    ref = JaxCodec(_jax(block_dim=bd, **MODES[mode]))
    a, b = ours.encode(img), ref.encode(img)
    assert a.num_symbols == b.num_symbols and a.predictor == b.predictor
    for field in ("widths", "code_bytes", "block_offsets"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
    assert (a.block_init is None) == (b.block_init is None)
    if a.block_init is not None:
        np.testing.assert_array_equal(a.block_init, b.block_init)
    blob = ours.encode_to_bytes(img)
    assert blob == ref.encode_to_bytes(img)
    assert blob == metalhuffman_tpu_torch.encode_image(
        img, CodecConfig(block_dim=bd, **MODES[mode]))
    # the port decodes its own container, CRC-checked, at every size
    np.testing.assert_array_equal(
        metalhuffman_tpu_torch.decode_image(blob, device="cpu"), img)
    np.testing.assert_array_equal(ours.decode(a, 64, 96, device="cpu"), img)


# the JAX decodes: 2, 4 and 8 with the 1-D delta, the 2-D post-pass and
# the zero-init fold off 8x8. JAX's 16x16 decode runs in
# test_checked_batch_masks_match_jax (a 16x16 delta is minutes of JAX
# compile; tests/test_block_dims.py holds JAX's own to the source).
JAX_DECODES = [(2, "delta"), (4, "delta"), (8, "delta"), (4, "delta2d"),
               (2, "zero_init")]


@pytest.mark.parametrize("bd,mode", JAX_DECODES, ids=lambda v: str(v))
def test_decode_matches_jax(bd, mode):
    img = _random_image(seed=bd)
    blob = JaxCodec(_jax(block_dim=bd, **MODES[mode])).encode_to_bytes(img)
    ref = JaxCodec(_jax()).decode(blob)
    codec = ImageCodec()  # the container's block_dim and precoder rule
    np.testing.assert_array_equal(codec.decode(blob, device="cpu"), ref)
    np.testing.assert_array_equal(ref, img)
    # staged once, the device step alone
    cfg_codec = ImageCodec(CodecConfig(block_dim=bd, **MODES[mode]))
    prep = cfg_codec.prepare(cfg_codec.encode(img), 64, 96, device="cpu")
    out = cfg_codec.decode_step(prep)
    assert out.shape == (64, 96) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), img)


def test_decode_image_matches_jax_and_checks_crc():
    img = _random_image(seed=8)  # the 8x8 delta image of test_decode_matches_jax
    blob = metalhuffman_tpu.encode_image(img)
    assert blob == metalhuffman_tpu_torch.encode_image(img)
    ours = metalhuffman_tpu_torch.decode_image(blob, device="cpu")
    np.testing.assert_array_equal(ours, metalhuffman_tpu.decode_image(blob))
    bad = bytearray(blob)
    bad[18:22] = bytes(b ^ 0xFF for b in bad[18:22])  # the recorded CRC-32
    with pytest.raises(ValueError, match="CRC-32"):
        metalhuffman_tpu_torch.decode_image(bytes(bad), device="cpu")
    with pytest.raises(ValueError, match="CRC-32"):
        metalhuffman_tpu.decode_image(bytes(bad))


def test_roundtrip_verify():
    img = _random_image(20, 30, seed=9)
    for bd in BLOCK_DIMS:
        s = ImageCodec(CodecConfig(block_dim=bd)).roundtrip_verify(
            img, device="cpu")
        assert s.block_offsets.size == np.prod(
            [-(-n // bd) for n in img.shape])


# -- region decode with the end-bit check -------------------------------------
#
# One 48x64 image (a 6x8 grid of 8x8 blocks) and regions of one shape (2x3
# blocks) for every JAX case, so JAX compiles its selection decode once:
# corruption leaves the table and the offsets as they are.

@pytest.fixture(scope="module")
def region_image():
    img = _photo_like(48, 64, seed=2)
    return img, ImageCodec().encode(img)


def _jax_region(stream, *region, check=True):
    return JaxCodec(_jax()).decode_region(stream, 48, 64, *region, check=check)


def test_region_check_clean_matches_jax(region_image):
    img, stream = region_image
    ours = ImageCodec().decode_region(stream, 48, 64, 16, 24, 16, 24,
                                      check=True, device="cpu")
    np.testing.assert_array_equal(ours, img[16:32, 24:48])
    np.testing.assert_array_equal(ours, _jax_region(stream, 16, 24, 16, 24))
    for y0, x0, rh, rw in ((10, 19, 21, 26), (40, 56, 8, 8), (0, 0, 48, 64)):
        np.testing.assert_array_equal(
            ImageCodec().decode_region(stream, 48, 64, y0, x0, rh, rw,
                                       check=True, device="cpu"),
            img[y0:y0 + rh, x0:x0 + rw])


def test_region_check_inside_corruption_raises_as_jax(region_image):
    _img, stream = region_image
    # region rows 16..32, cols 24..48 -> block rect rows 2..4, cols 3..6;
    # block (2, 4) = index 20 is inside the selection
    bad = _corrupt_block(stream, 2 * 8 + 4)
    with pytest.raises(ValueError, match="integrity"):
        ImageCodec().decode_region(bad, 48, 64, 16, 24, 16, 24, check=True,
                                   device="cpu")
    with pytest.raises(ValueError, match="integrity"):
        _jax_region(bad, 16, 24, 16, 24)
    sel = (np.arange(2, 4)[:, None] * 8 + np.arange(3, 6)[None, :]).ravel()
    _, err = tic.decode_blocks_selection(bad, sel, 16, 24, CodecConfig(),
                                         check=True, device="cpu")
    _, ref_err = jic.decode_blocks_selection(bad, sel, 16, 24, _jax(),
                                             check=True)
    np.testing.assert_array_equal(err, ref_err)
    assert err[list(sel).index(20)]


def test_region_check_outside_corruption_passes_as_jax(region_image):
    img, stream = region_image
    # block (2, 7): the region's block row, outside its columns, so its
    # bytes sit inside the staged word range
    bad = _corrupt_block(stream, 2 * 8 + 7)
    ours = ImageCodec().decode_region(bad, 48, 64, 16, 24, 16, 24,
                                      check=True, device="cpu")
    np.testing.assert_array_equal(ours, img[16:32, 24:48])
    np.testing.assert_array_equal(ours, _jax_region(bad, 16, 24, 16, 24))


def test_region_check_last_block_window_as_jax(region_image):
    # the region's last block is the stream's: its end is checked against
    # the byte-rounded window, not a next offset
    img, stream = region_image
    sel = (np.arange(4, 6)[:, None] * 8 + np.arange(5, 8)[None, :]).ravel()
    assert sel[-1] == stream.block_offsets.size - 1
    for s, flagged in ((stream, False), (_corrupt_block(stream, 47), True)):
        _, err = tic.decode_blocks_selection(s, sel, 16, 24, CodecConfig(),
                                             check=True, device="cpu")
        _, ref_err = jic.decode_blocks_selection(s, sel, 16, 24, _jax(),
                                                 check=True)
        np.testing.assert_array_equal(err, ref_err)
        assert err[-1] == flagged and not err[:-1].any()
    np.testing.assert_array_equal(
        ImageCodec().decode_region(stream, 48, 64, 32, 40, 16, 24, check=True,
                                   device="cpu"), img[32:, 40:])


@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_selection_targets_and_last_window_match_jax(bd):
    img = _random_image(seed=bd)
    cfg = CodecConfig(block_dim=bd)
    stream = ImageCodec(cfg).encode(img)
    nb = stream.block_offsets.size
    # any order, repeats, the last block
    sel = np.random.default_rng(bd).integers(0, nb, 40)
    sel = np.append(sel, [nb - 1, 0, nb - 1])
    np.testing.assert_array_equal(tic.selection_end_targets(stream, sel),
                                  jic.selection_end_targets(stream, sel))
    jprep = jfs.prepare_shared(stream, 1, 64, 96, _jax(block_dim=bd),
                               check=True)
    prep = tfs.prepare_shared(stream, 1, 64, 96, cfg, device="cpu", check=True)
    assert prep.last_window is not None
    assert prep.last_window == jprep.last_window
    # tail symbols past the last whole block: the last end stays unchecked
    tail = dataclasses.replace(stream, num_symbols=stream.num_symbols + 1)
    assert tfs.prepare_shared(tail, 1, 64, 96, cfg, device="cpu",
                              check=True).last_window is None


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("bd", BLOCK_DIMS)
def test_region_every_block_size_and_precoder(bd, mode):
    img = _photo_like(40, 40, seed=5)
    codec = ImageCodec(CodecConfig(block_dim=bd, **MODES[mode]))
    stream = codec.encode(img)
    for y0, x0, rh, rw in ((3, 5, 20, 17), (30, 33, 10, 7)):
        out = codec.decode_region(stream, 40, 40, y0, x0, rh, rw, check=True,
                                  device="cpu")
        np.testing.assert_array_equal(out, img[y0:y0 + rh, x0:x0 + rw])
    with pytest.raises(ValueError, match="out of bounds"):
        codec.decode_region(stream, 40, 40, 35, 0, 8, 8, device="cpu")


# -- checked batch decode ------------------------------------------------------

def _flat_frames(t, h, w, seed):
    # 3 symbols at 1/2, 1/4, 1/4: codes of 1 and 2 bits, so a flipped bit
    # mostly shifts a block's end, at a cheap JAX compile
    rng = np.random.default_rng(seed)
    return rng.choice(3, (t, h, w), p=[0.5, 0.25, 0.25]).astype(np.uint8)


def _flip(stream, bit):
    code = stream.code_bytes.copy()
    code[bit // 8] ^= 128 >> (bit % 8)
    return dataclasses.replace(stream, code_bytes=code)


@pytest.mark.parametrize("bd,kw", [(8, {}), (16, {"delta": False})],
                         ids=["8x8-delta", "16x16-none"])
def test_checked_batch_masks_match_jax(bd, kw):
    t, h, w = 2, 32, 48
    frames = _flat_frames(t, h, w, seed=bd)
    cfg, jcfg = CodecConfig(block_dim=bd, **kw), _jax(block_dim=bd, **kw)
    stream = tfs.encode_frames_shared(frames, cfg)

    def checked(s):
        prep = tfs.prepare_shared(s, t, h, w, cfg, device="cpu", check=True)
        out, err = tfs.decode_shared_step_checked(prep, cfg)
        jprep = jfs.prepare_shared(s, t, h, w, jcfg, check=True)
        ref, ref_err = jfs.decode_shared_step_checked(jprep, jcfg)
        assert err.dtype == bool and err.shape == (stream.block_offsets.size,)
        np.testing.assert_array_equal(err, ref_err)
        return out, np.asarray(ref), err

    out, ref, err = checked(stream)
    assert not err.any()
    np.testing.assert_array_equal(out.numpy(), frames)
    np.testing.assert_array_equal(ref, frames)
    # a seeded bit, and the next bits until one desyncs its block (a flip
    # that resynchronises is the documented blind spot,
    # tests/test_region_check.py)
    bit = int(np.random.default_rng(bd).integers(0, 4 * stream.code_bytes.size))
    while True:
        bad = _flip(stream, bit)
        prep = tfs.prepare_shared(bad, t, h, w, cfg, device="cpu", check=True)
        if tfs.decode_shared_step_checked(prep, cfg)[1].any():
            break
        bit += 1
    _out, _ref, err = checked(bad)
    assert err.sum() == 1 and err[stream.block_offsets.searchsorted(
        bit, side="right") - 1]


def test_checked_decode_needs_targets():
    frames = _flat_frames(1, 16, 16, seed=1)
    stream = tfs.encode_frames_shared(frames)
    prep = tfs.prepare_shared(stream, 1, 16, 16, device="cpu")
    with pytest.raises(ValueError, match="check=True"):
        tfs.decode_shared_step_checked(prep)
    with pytest.raises(ValueError, match="block_dim"):
        tfs.decode_shared_step(prep, CodecConfig(block_dim=4))


def test_raw_off_8x8_is_the_image_form():
    frames = _flat_frames(2, 20, 12, seed=2)
    for bd in (2, 4, 16):
        cfg = CodecConfig(block_dim=bd)
        prep = tfs.prepare_shared(tfs.encode_frames_shared(frames, cfg), 2,
                                  20, 12, cfg, device="cpu")
        raw = tfs.decode_shared_step(prep, cfg, raw=True)
        assert raw.shape == (2, 20, 12)
        np.testing.assert_array_equal(raw.numpy(), frames)


def test_video_at_every_block_size():
    frames = _flat_frames(3, 13, 21, seed=3)
    for bd in BLOCK_DIMS:
        for name, kw in MODES.items():
            cfg = CodecConfig(block_dim=bd, **kw)
            stream = tfs.encode_frames_shared(frames, cfg)
            blob = tfs.write_shared(stream, 3, 13, 21, cfg,
                                    source_crc32=zlib.crc32(frames.tobytes()))
            np.testing.assert_array_equal(
                metalhuffman_tpu_torch.decode_video(blob, "cpu"), frames,
                err_msg=f"{bd} {name}")
