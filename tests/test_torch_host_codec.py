"""The port's own host codec (metalhuffman_tpu_torch.core and .native) held
equal to the JAX package's originals it was copied from, on seeded inputs.

Every comparison is exact: the host codec is integer code, and both
packages must write and read the very same bytes.
"""

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.core import bitstream as jbitstream
from metalhuffman_tpu.core import blocks as jblocks
from metalhuffman_tpu.core import container as jcontainer
from metalhuffman_tpu.core import delta as jdelta
from metalhuffman_tpu_torch import native
from metalhuffman_tpu_torch.core import bitstream, blocks, container, delta

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)


def _payload(kind, n, seed=0):
    rng = np.random.default_rng(seed)
    if kind == "random":
        return rng.integers(0, 256, n, dtype=np.uint8)
    if kind == "skewed":  # a 16-bit-deep table: the package-merge cap
        f = np.array([int(1.618 ** k) + 1 for k in range(40)], float)
        return rng.choice(40, n, p=f / f.sum()).astype(np.uint8)
    if kind == "longcodes":  # frequencies 2^i: package-merge caps at 16
        counts = 2 ** np.arange(24)
        return rng.permutation(np.repeat(np.arange(24, dtype=np.uint8),
                                         counts))[:n]
    return np.full(n, 77, np.uint8)  # one symbol: a lone 1-bit code


KINDS = ["random", "skewed", "longcodes", "one-symbol"]


@pytest.mark.parametrize("threads", [1, 0], ids=["serial", "mt"])
@pytest.mark.parametrize("block_size", [4, 16, 64, 256])
@pytest.mark.parametrize("kind", ["random", "skewed", "one-symbol"])
def test_encode_symbols_matches_jax(kind, block_size, threads):
    # a tail of 3 symbols past the last whole block
    data = _payload(kind, block_size * 97 + 3, seed=block_size)
    ours = native.encode_symbols(data, block_size=block_size,
                                 n_threads=threads)
    ref = jnative.encode_symbols(data, block_size=block_size,
                                 n_threads=threads)
    assert ours.num_symbols == ref.num_symbols
    for field in ("widths", "code_bytes", "block_offsets"):
        x, y = getattr(ours, field), getattr(ref, field)
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert ours.block_init is None and ours.predictor == "left"


@pytest.mark.parametrize("block_dim", [2, 4, 8, 16])
def test_delta_precoders_match_jax(block_dim):
    data = _payload("random", block_dim * block_dim * 50, seed=block_dim)
    bs = block_dim * block_dim
    np.testing.assert_array_equal(native.delta_encode(data, bs),
                                  jnative.delta_encode(data, bs))
    np.testing.assert_array_equal(native.delta_encode(data[:-1], bs),
                                  jnative.delta_encode(data[:-1], bs))
    np.testing.assert_array_equal(native.delta2d_encode(data, block_dim),
                                  jnative.delta2d_encode(data, block_dim))
    with pytest.raises(ValueError, match="whole number"):
        native.delta2d_encode(data[:-1], block_dim)


@pytest.mark.parametrize("block_dim", [2, 4, 8, 16])
def test_delta2d_decode_blocks_matches_jax(block_dim):
    res = _payload("random", block_dim * block_dim * 30, seed=3).reshape(
        30, -1)
    ours = delta.delta2d_decode_blocks(torch.from_numpy(res), block_dim)
    assert ours.dtype == torch.uint8 and ours.shape == res.shape
    np.testing.assert_array_equal(
        ours.numpy(), jdelta.delta2d_decode_blocks(res, block_dim))


def _stream(mode, seed):
    """A JAX-encoded stream for container mode 0..4."""
    img = _payload("random", 24 * 40, seed).reshape(24, 40)
    blk = jblocks.image_to_blocks(img).ravel()
    two_d = mode in (3, 4)
    if mode:
        blk = (jnative.delta2d_encode(blk, 8) if two_d
               else jnative.delta_encode(blk, 64))
    init = None
    if mode in (2, 4):
        init, zeroed = jdelta.split_zero_init(blk.reshape(-1, 64))
        blk = zeroed.ravel()
    s = jnative.encode_symbols(blk, block_size=64)
    return jcontainer.EncodedStream(
        s.num_symbols, s.widths, s.code_bytes, s.block_offsets,
        block_init=init, predictor="2d" if two_d else "left")


@pytest.mark.parametrize("crc", [0, 0xDEADBEEF], ids=["no-crc", "crc"])
@pytest.mark.parametrize("mode", range(5))
def test_write_frame_is_byte_identical(mode, crc):
    s = _stream(mode, seed=mode)
    ours = container.write_frame(s, 24, 40, 8, bool(mode), source_crc32=crc)
    assert ours == jcontainer.write_frame(s, 24, 40, 8, bool(mode),
                                          source_crc32=crc)
    assert ours[17] == mode  # the MHT1 mode byte


@pytest.mark.parametrize("mode", range(5))
def test_read_frame_roundtrips_jax_blobs(mode):
    s = _stream(mode, seed=10 + mode)
    blob = jcontainer.write_frame(s, 24, 40, 8, bool(mode), source_crc32=7)
    ours, *geo = container.read_frame(blob)
    ref, *ref_geo = jcontainer.read_frame(blob)
    assert geo == ref_geo == [24, 40, 8, bool(mode), 7]
    assert ours.num_symbols == ref.num_symbols
    assert ours.predictor == ref.predictor
    for field in ("widths", "code_bytes", "block_offsets"):
        np.testing.assert_array_equal(getattr(ours, field), getattr(ref, field))
    if mode in (2, 4):
        np.testing.assert_array_equal(ours.block_init, ref.block_init)
    else:
        assert ours.block_init is None
    assert ours.core_blob() == ref.core_blob()
    assert ours.compressed_size == ref.compressed_size


def test_container_rejects_what_jax_rejects():
    s = _stream(1, seed=20)
    blob = jcontainer.write_frame(s, 24, 40, 8, True)
    bad_table = bytearray(blob)
    bad_table[26 + 8 + int(np.flatnonzero(s.widths)[0])] += 1  # breaks Kraft
    for data, match in ((b"MHTV" + blob[4:], "not an MHT1"),
                        (bytes(bad_table), "corrupt canonical width table"),
                        (blob[:20], "unrecognized")):
        for reader in (container.read_frame, jcontainer.read_frame):
            with pytest.raises(ValueError, match=match):
                reader(data)


@pytest.mark.parametrize("block_dim", [2, 4, 8, 16])
def test_block_reorder_matches_jax(block_dim):
    img = _payload("random", 37 * 53, seed=block_dim).reshape(37, 53)
    blk = blocks.image_to_blocks(img, block_dim)
    np.testing.assert_array_equal(blk, jblocks.image_to_blocks(img, block_dim))
    assert blocks.block_grid(37, 53, block_dim) == jblocks.block_grid(
        37, 53, block_dim)
    back = blocks.blocks_to_image(blk, 37, 53, block_dim)
    np.testing.assert_array_equal(
        back, jblocks.blocks_to_image(blk, 37, 53, block_dim))
    np.testing.assert_array_equal(back, img)
    # the torch twin, batched over a leading frame axis
    two = torch.from_numpy(np.stack([blk, blk[::-1].copy()]))
    out = blocks.blocks_to_image_torch(two, 37, 53, block_dim)
    np.testing.assert_array_equal(out[0].numpy(), img)
    np.testing.assert_array_equal(
        out[1].numpy(), jblocks.blocks_to_image(blk[::-1], 37, 53, block_dim))


def test_zero_init_split_and_fold_match_jax():
    d = _payload("random", 64 * 40, seed=30).reshape(40, 64)
    init, zeroed = delta.split_zero_init(d)
    ref_init, ref_zeroed = jdelta.split_zero_init(d)
    np.testing.assert_array_equal(init, ref_init)
    np.testing.assert_array_equal(zeroed, ref_zeroed)
    np.testing.assert_array_equal(delta.apply_block_init(zeroed, init),
                                  jdelta.apply_block_init(zeroed, init))


def test_be_words_match_jax():
    code = _payload("random", 4 * 33 + 3, seed=31)
    for pad in (1, 2, 7):
        np.testing.assert_array_equal(
            bitstream.bytes_to_be_words(code, pad_words=pad),
            jbitstream.bytes_to_be_words(code, pad_words=pad))
    assert bitstream.READ_AHEAD_PAD_BYTES == jbitstream.READ_AHEAD_PAD_BYTES


def test_encode_rejects_empty_input_as_jax_does():
    for enc in (native.encode_symbols, jnative.encode_symbols):
        with pytest.raises(ValueError, match="empty"):
            enc(np.zeros(0, np.uint8))


@pytest.mark.parametrize("kind", KINDS)
def test_canonical_table_matches_jax(kind):
    freqs = np.bincount(_payload(kind, 1 << 24, seed=40), minlength=256)
    widths = native.code_lengths(freqs)
    np.testing.assert_array_equal(widths, jnative.code_lengths(freqs))
    assert widths.dtype == np.uint8 and widths.max() <= 16
    codes = native.canonical_codes(widths)
    np.testing.assert_array_equal(codes, jnative.canonical_codes(widths))
    assert codes.dtype == np.uint16


@pytest.mark.parametrize("kind", KINDS)
def test_pack_bits_matches_jax(kind):
    data = _payload(kind, 1000, seed=41)
    widths = jnative.code_lengths(np.bincount(data, minlength=256))
    codes = jnative.canonical_codes(widths)
    packed, offs = bitstream.pack_bits(data, codes, widths)
    ref_packed, ref_offs = jbitstream.pack_bits(data, codes, widths)
    np.testing.assert_array_equal(packed, ref_packed)
    np.testing.assert_array_equal(offs, ref_offs)
    assert offs.dtype == ref_offs.dtype == np.uint64
    np.testing.assert_array_equal(bitstream.symbol_bit_offsets(data, widths),
                                  jbitstream.symbol_bit_offsets(data, widths))
    with pytest.raises(ValueError, match="zero code width"):
        bitstream.pack_bits(np.array([3, 4], np.uint8), codes,
                            np.zeros(256, np.uint8))


def _rows(data, row_words=None):
    """Per-block padded word rows of ``data`` (whole 64-symbol blocks),
    packed by the JAX package's NumPy packer, and the block bit counts."""
    widths = jnative.code_lengths(np.bincount(data, minlength=256))
    codes = jnative.canonical_codes(widths)
    body = data.reshape(-1, 64)
    bits = widths[body].astype(np.uint32).sum(1, dtype=np.uint32)
    row_words = row_words or int(bits.max()) // 32 + 2
    rows = np.zeros((body.shape[0], row_words), np.uint32)
    for b, blk in enumerate(body):
        packed, _ = jbitstream.pack_bits(blk, codes, widths)
        w = jbitstream.bytes_to_be_words(packed, pad_words=2)[:row_words]
        rows[b, : w.size] = w
    return rows, bits


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("kind", KINDS)
def test_merge_rows_matches_jax(kind, threads):
    data = _payload(kind, 64 * 301, seed=42)
    rows, bits = _rows(data)
    code, offsets, total = native.merge_rows(rows, bits, threads)
    ref_code, ref_offsets, ref_total = jnative.merge_rows(rows, bits, threads)
    np.testing.assert_array_equal(code, ref_code)
    np.testing.assert_array_equal(offsets, ref_offsets)
    assert offsets.dtype == np.uint32 and total == ref_total
    ref = jnative.encode_symbols(data, 64)
    np.testing.assert_array_equal(code, ref.code_bytes)
    np.testing.assert_array_equal(offsets, ref.block_offsets)


def test_merge_rows_raises_on_a_row_too_short():
    rows = np.zeros((2, 1), np.uint32)
    bits = np.array([40, 40], np.uint32)  # 40 bits need 2 words
    with pytest.raises(RuntimeError, match="too short"):
        native.merge_rows(rows, bits)
    with pytest.raises(RuntimeError):
        jnative.merge_rows(rows, bits)
    with pytest.raises(ValueError, match="n_blocks"):
        native.merge_rows(rows, bits[:1])
