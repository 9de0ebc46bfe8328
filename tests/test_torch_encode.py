"""The port's hybrid device encoder (metalhuffman_tpu_torch.ops.encode_cuda)
held to the JAX package on the CPU.

The packer's plain version must equal the TPU kernel ``encode_rows`` (Pallas
interpret mode) bit for bit, rows and count words; the whole path must equal
the JAX package's ``native.encode_symbols`` byte for byte. Every comparison
is exact: the encoder is integer code and both packages must write the very
same streams. The JAX kernel runs in three module fixtures only (one
interpret compile each, 5-9 s); everything else is held to the JAX package's
fast host encoder.
"""

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native as jnative
from metalhuffman_tpu.ops import encode_pallas
from metalhuffman_tpu_torch import native
from metalhuffman_tpu_torch.core import blocks
from metalhuffman_tpu_torch.models import frame_stream
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import encode_cuda


def _datasets():
    """The five sets of tests/test_encode_pallas.py, same seed and order."""
    rng = np.random.default_rng(7)
    yield "uniform", rng.integers(0, 256, 64 * 200, np.uint8)
    yield "skewed", rng.choice(
        np.arange(32), size=64 * 300 + 17, p=(p := 0.8 ** np.arange(32)) / p.sum()
    ).astype(np.uint8)
    yield "constant", np.full(64 * 10 + 5, 9, np.uint8)
    # width-1 codes: every block ends on a word boundary (64 bits)
    yield "two-sym", rng.choice([7, 200], size=64 * 130, p=[0.93, 0.07]).astype(np.uint8)
    # package-merge 16-bit-capped widths: the longest codes
    counts = [2 ** i for i in range(24)]
    adv = np.concatenate([np.full(c, i, np.uint8) for i, c in enumerate(counts)])
    rng.shuffle(adv)
    yield "longcodes", adv[: (adv.size // 64) * 64]


DATASETS = dict(_datasets())
NAMES = list(DATASETS)


def _table(data):
    widths = jnative.code_lengths(np.bincount(data, minlength=256))
    return widths, jnative.canonical_codes(widths)


def _one_tile(name):
    """(nb <= 1024, 64) blocks of a set, one TPU tile: all of them, or for
    ``longcodes`` the 512 longest blocks and the first 512."""
    data = DATASETS[name]
    body = data[: data.size // 64 * 64].reshape(-1, 64)
    if body.shape[0] > 1024:
        widths, _ = _table(data)
        bits = widths[body].astype(np.int64).sum(1)
        keep = np.union1d(np.argsort(-bits, kind="stable")[:512], np.arange(512))
        body = body[keep]
    return np.ascontiguousarray(body)


@pytest.fixture(scope="module", params=["skewed", "two-sym", "longcodes"])
def jax_rows(request):
    """(name, symbols, widths, codes, wmax, JAX rows + count word)."""
    name = request.param
    widths, codes = _table(DATASETS[name])
    body = _one_tile(name)
    nb = body.shape[0]
    wmax = int(widths[body].astype(np.int64).sum(1).max()) // 32 + 2
    padded = np.zeros(1024 * 64, np.uint8)
    padded[: body.size] = body.ravel()
    cp, wp = encode_pallas.pack_code_tables(widths, codes)
    min_w, max_w = encode_pallas.used_width_band(widths)
    out = encode_pallas.encode_rows(
        encode_pallas._stage_symbols(padded, nt=1), cp, wp, wmax=wmax,
        min_w=min_w, max_w=max_w, interpret=True)
    # words 0..wmax: the block's bits and, in word wmax, its bit count
    rows = np.asarray(encode_pallas._rows_block_major(
        out, wmax=wmax + 1, n_blocks=nb))
    return name, body, widths, codes, wmax, rows


def _staged(body, widths, codes):
    return (torch.from_numpy(body),
            torch.from_numpy(encode_cuda.code_table(widths, codes)))


def test_encode_rows_plain_matches_the_tpu_kernel(jax_rows):
    name, body, widths, codes, wmax, ref = jax_rows
    got = encode_cuda.encode_rows_plain(*_staged(body, widths, codes),
                                        wmax=wmax)
    assert got.dtype == torch.int32 and got.shape == ref.shape
    np.testing.assert_array_equal(got.numpy(), ref)
    np.testing.assert_array_equal(
        got[:, wmax].numpy(), widths[body].astype(np.int64).sum(1))
    if name == "longcodes":
        assert widths[body].max() == 16
    if name == "two-sym":  # 64 one-bit codes: the row fills words 0 and 1
        assert (got[:, wmax] == 64).all() and (got[:, 2:wmax] == 0).all()


def test_encode_rows_on_cpu_runs_the_plain_version(jax_rows):
    _, body, widths, codes, wmax, ref = jax_rows
    before = dict(encode_cuda.launches)
    got = encode_cuda.encode_rows(*_staged(body, widths, codes), wmax=wmax)
    np.testing.assert_array_equal(got.numpy(), ref)
    assert encode_cuda.launches == before


@pytest.mark.parametrize("name", NAMES)
def test_rows_merge_into_the_host_stream(name):
    data = DATASETS[name]
    widths, codes = _table(data)
    body = data[: data.size // 64 * 64].reshape(-1, 64)
    bits = widths[body].astype(np.uint32).sum(1, dtype=np.uint32)
    wmax = int(bits.max()) // 32 + 2
    rows = encode_cuda.encode_rows_plain(*_staged(body, widths, codes),
                                         wmax=wmax)
    np.testing.assert_array_equal(rows[:, wmax].numpy(), bits)
    code, offsets, total = native.merge_rows(
        rows[:, :wmax].numpy().view(np.uint32), bits)
    ref = jnative.encode_symbols(body.ravel(), 64)
    np.testing.assert_array_equal(code, ref.code_bytes)
    np.testing.assert_array_equal(offsets, ref.block_offsets)
    assert total == int(bits.astype(np.int64).sum())


def _assert_same_stream(got, ref):
    assert got.num_symbols == ref.num_symbols
    for field in ("widths", "code_bytes", "block_offsets"):
        x, y = getattr(got, field), getattr(ref, field)
        assert x.dtype == y.dtype, field
        np.testing.assert_array_equal(x, y, err_msg=field)


@pytest.mark.parametrize("threads", [0, 1, 8])
@pytest.mark.parametrize("name", NAMES)
def test_hybrid_matches_jax_native(name, threads):
    data = DATASETS[name]
    got = encode_cuda.encode_symbols_hybrid(data, 64, threads, device="cpu")
    _assert_same_stream(got, jnative.encode_symbols(data, 64))


@pytest.mark.parametrize("tail", [1, 5, 17, 63])
def test_hybrid_tail_bits_match_jax_native(tail):
    data = DATASETS["skewed"][: 64 * 200 + tail]
    got = encode_cuda.encode_symbols_hybrid(data, device="cpu")
    _assert_same_stream(got, jnative.encode_symbols(data, 64))


@pytest.mark.parametrize("n", [1, 40, 63])
def test_hybrid_shorter_than_a_block_goes_to_the_host(n):
    data = np.arange(n, dtype=np.uint8) * 3
    before = dict(encode_cuda.launches)
    got = encode_cuda.encode_symbols_hybrid(data, device="cpu")
    _assert_same_stream(got, jnative.encode_symbols(data, 64))
    assert got.block_offsets.size == 0
    assert encode_cuda.launches == before


def test_hybrid_rejects_what_the_reference_rejects():
    with pytest.raises(ValueError, match="block_size=64 only"):
        encode_cuda.encode_symbols_hybrid(np.zeros(32, np.uint8),
                                          block_size=16, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        encode_cuda.encode_symbols_hybrid(np.zeros(0, np.uint8), device="cpu")


@pytest.mark.parametrize("k", [2, 4, 16])
def test_blocks_ending_on_a_word_boundary(k):
    # k equally frequent symbols: every code is log2(k) bits, every block
    # 64*log2(k) bits, a whole number of words; the spare word stays zero
    rng = np.random.default_rng(k)
    data = np.tile(np.arange(k, dtype=np.uint8) * 9, 64 * 40 // k)
    rng.shuffle(data)
    widths, codes = _table(data)
    bits = 64 * int(np.log2(k))
    wmax = bits // 32 + 2
    rows = encode_cuda.encode_rows_plain(
        *_staged(data.reshape(-1, 64), widths, codes), wmax=wmax)
    assert (rows[:, wmax] == bits).all() and (rows[:, wmax - 1] == 0).all()
    got = encode_cuda.encode_symbols_hybrid(data, device="cpu")
    _assert_same_stream(got, jnative.encode_symbols(data, 64))


def test_encode_rows_drops_bits_past_wmax_words():
    data = DATASETS["uniform"][: 64 * 50]
    widths, codes = _table(data)
    args = _staged(data.reshape(-1, 64), widths, codes)
    full = encode_cuda.encode_rows_plain(*args, wmax=20)
    for wmax in (1, 3, 7):
        cut = encode_cuda.encode_rows_plain(*args, wmax=wmax)
        assert torch.equal(cut[:, :wmax], full[:, :wmax])
        assert torch.equal(cut[:, wmax], full[:, 20])


def test_two_frames_round_trip_through_the_port_decoder():
    rng = np.random.default_rng(3)
    yy, xx = np.mgrid[0:24, 0:40]
    frames = np.stack([
        np.clip(100 + 60 * np.sin((xx + 5 * i) / 9) * np.cos(yy / 7)
                + rng.normal(0, 2, (24, 40)), 0, 255).astype(np.uint8)
        for i in range(2)])
    payload = np.concatenate([native.delta_encode(
        blocks.image_to_blocks(f).ravel(), 64) for f in frames])
    stream = encode_cuda.encode_symbols_hybrid(payload, device="cpu")
    _assert_same_stream(stream, frame_stream.encode_frames_shared(frames))
    out = frame_stream.decode_frames_shared(stream, 2, 24, 40, CodecConfig(),
                                            device="cpu")
    np.testing.assert_array_equal(out.numpy(), frames)
