"""Parity of the port's decode ops (metalhuffman_tpu_torch.ops.decode_cuda:
the image kernel B1, the packed-block kernel B2 and their end bits) with the
JAX package's Pallas decode, run in interpret mode on the CPU.

Every comparison is exact byte equality: the codec is lossless integer
arithmetic, so the tolerance is 0.
"""

import dataclasses

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native
from metalhuffman_tpu.core import blocks, container
from metalhuffman_tpu.models import CodecConfig, frame_stream
from metalhuffman_tpu.ops import decode_pallas
from metalhuffman_tpu_torch.ops import decode_cuda

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)


def _frames(t, h, w, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def _histograms():
    """(name, 256 symbol counts): random, skewed and degenerate tables."""
    rng = np.random.default_rng(1234)
    hists = []
    for i in range(8):
        f = rng.integers(0, 1000, 256)
        f[rng.random(256) < 0.1 * i] = 0  # 0..70% of symbols absent
        hists.append((f"random{i}", f))
    for i, ratio in enumerate((0.3, 0.5, 0.6, 0.7, 0.8, 0.9)):
        n = 20 + 30 * i
        f = np.zeros(256, np.int64)
        f[rng.permutation(256)[:n]] = np.maximum(
            1, 1e12 * ratio ** np.arange(n)).astype(np.int64)
        hists.append((f"geometric{ratio}", f))
    lap = np.minimum(np.arange(256), 256 - np.arange(256))
    for scale in (2.0, 8.0, 30.0):
        hists.append((f"laplace{scale}",
                      (1e6 * np.exp(-lap / scale)).astype(np.int64) + 1))
    one = np.zeros(256, np.int64)
    one[77] = 5
    two = np.zeros(256, np.int64)
    two[[3, 200]] = [1, 9]
    fib = np.zeros(256, np.int64)
    fib[:40] = [int(((1 + 5 ** 0.5) / 2) ** k) + 1 for k in range(40)]
    hists += [("one-symbol", one), ("two-symbol", two), ("flat", np.ones(256)),
              ("fibonacci-16-deep", fib)]
    return hists


HISTOGRAMS = _histograms()


def test_table_set_covers_edges():
    depths = [int(native.code_lengths(np.asarray(f, np.int64)).max())
              for _, f in HISTOGRAMS]
    assert len(HISTOGRAMS) >= 20
    assert 1 in depths and 16 in depths


@pytest.mark.parametrize("name,freqs", HISTOGRAMS, ids=[n for n, _ in HISTOGRAMS])
def test_canonical_meta_matches_jax(name, freqs):
    widths = native.code_lengths(np.asarray(freqs, np.int64))
    ours = decode_cuda.canonical_meta(widths)
    ref = decode_pallas.canonical_meta(widths)
    assert ours.bounds == ref.bounds
    assert ours.adj == tuple(int(v) for v in np.cumsum(ref.adj_inc))
    pair = ref.pair_table[0].astype(np.int64)
    order = np.empty(256, np.int64)
    order[0::2] = pair & 0xFF
    order[1::2] = (pair >> 8) & 0xFF
    np.testing.assert_array_equal(ours.symbols, order)


# One Laplacian table over all 256 symbols (the shape of delta residuals)
# encodes every decode case below: the Pallas kernel is specialised per table
# and per 128-lane groups per block row (h2), so a shared table keeps the
# interpret-mode compiles to one per mode. The shapes of PALLAS_SHAPES all
# have h2 = 2 and share that compile; the one h2 = 1 shape is held to its
# source frames (the Pallas kernel decodes them losslessly as well), and
# test_torch_frame_stream holds an h2 = 1 batch against Pallas.
_LAP = np.minimum(np.arange(256), 256 - np.arange(256))
TABLE = native.code_lengths((1000 * np.exp(-_LAP / 30.0)).astype(np.int64) + 1)
SHAPES = [(2, 16, 1024), (1, 8, 2048), (1, 48, 1920), (2, 20, 1212)]
PALLAS_SHAPES = SHAPES[1:]
MODES = {"delta": {}, "delta2d": {"delta2d": True}, "none": {"delta": False}}


def _stream(frames, cfg):
    """Shared-table stream of ``frames`` under the fixed TABLE."""
    payload = []
    for f in frames:
        blk = blocks.image_to_blocks(f).ravel()
        if cfg.delta2d:
            blk = native.delta2d_encode(blk, 8)
        elif cfg.delta:
            blk = native.delta_encode(blk, 64)
        payload.append(blk)
    s = native.encode_symbols(np.concatenate(payload), widths=TABLE)
    return container.EncodedStream(
        s.num_symbols, s.widths, s.code_bytes, s.block_offsets,
        predictor="2d" if cfg.delta2d else "left")


@pytest.mark.parametrize("mode", list(MODES))
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_decode_images_plain_matches_pallas(shape, mode):
    t, h, w = shape
    frames = _frames(t, h, w, seed=sum(shape))
    cfg = CodecConfig(backend="pallas", interpret=True, **MODES[mode])
    stream = _stream(frames, cfg)

    ref = frames
    if shape in PALLAS_SHAPES:
        prep = frame_stream.prepare_shared(stream, t, h, w, cfg)
        assert prep.h2 == 2  # the image-emission kernel (decode_tiles_images)
        ref = frame_stream.frames_from_raw(
            frame_stream.decode_shared_step(prep, cfg, raw=True), t, h, w,
            w_pad=prep.w_pad, bh=prep.bh)
        np.testing.assert_array_equal(ref, frames)

    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    bh, bw = blocks.block_grid(h, w)
    out = decode_cuda.decode_images_plain(
        torch.from_numpy(words), torch.from_numpy(offsets),
        decode_cuda.stage_code(stream.widths, "cpu"),
        num_frames=t, bh=bh, bw=bw, delta=cfg.delta and not cfg.delta2d,
        delta2d=cfg.delta2d)
    assert out.shape == (t, bh * 8, bw * 8) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out[:, :h, :w].numpy(), ref)


def test_decode_images_routes_cpu_tensors_to_plain():
    frames = _frames(2, 24, 40, seed=3)
    cfg = CodecConfig()
    stream = _stream(frames, cfg)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            decode_cuda.stage_code(stream.widths, "cpu"))
    geo = dict(num_frames=2, bh=3, bw=5, delta=True)
    before = dict(decode_cuda.launches)
    out = decode_cuda.decode_images(*args, **geo)
    assert decode_cuda.launches == before
    assert torch.equal(out, decode_cuda.decode_images_plain(*args, **geo))
    np.testing.assert_array_equal(out[:, :24, :40].numpy(), frames)


def test_prepare_stream_pads_for_the_last_refill():
    frames = _frames(1, 8, 8, seed=4)
    stream = _stream(frames, CodecConfig())
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    total_bits = 8 * (stream.code_bytes.size - 2)
    last_group = total_bits - 4  # each of the last 4 symbols takes >= 1 bit
    assert (last_group >> 5) + 2 < words.size
    assert words.dtype == np.int32 and offsets.dtype == np.int32
    np.testing.assert_array_equal(words[-decode_cuda.PAD_WORDS:], 0)


def test_decode_images_plain_end_bits_equal_block_end_targets():
    frames = _frames(2, 24, 40, seed=5)
    cfg = CodecConfig()
    stream = _stream(frames, cfg)
    payload = np.concatenate([native.delta_encode(
        blocks.image_to_blocks(f).ravel(), 64) for f in frames])
    total_bits = int(TABLE.astype(np.int64)[payload].sum())  # exact
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            decode_cuda.stage_code(stream.widths, "cpu"))
    geo = dict(num_frames=2, bh=3, bw=5, delta=True)
    img, end = decode_cuda.decode_images(*args, **geo, emit_end=True)
    assert torch.equal(img, decode_cuda.decode_images(*args, **geo))
    assert end.dtype == torch.int32 and end.shape == (30,)
    targets = decode_pallas.block_end_targets(stream.block_offsets, total_bits)
    np.testing.assert_array_equal(end.numpy(), targets)
    np.testing.assert_array_equal(
        decode_cuda.block_end_targets(stream.block_offsets, total_bits), targets)
    assert not decode_cuda.check_block_ends(end.numpy(), targets).any()


# -- the packed-block kernel (B2) against decode_tiles -----------------------
#
# One stream per num_steps, on a 6-symbol geometric table (widths 1..5): the
# compare chain and a varying refill position at interpret-compile costs the
# suite can carry. JAX's delta decode at 256 steps costs minutes of interpret
# compile on any table, so at 256 the 1-D delta is held to JAX's no-delta
# decode accumulated mod 256 (and to the source symbols).

B2_STEPS = (4, 16, 64, 256)
B2_CASES = [(n, d) for n in B2_STEPS for d in ("delta", "none")]


def _b2_symbols(steps):
    rng = np.random.default_rng(steps)
    p = 0.5 ** np.arange(6)
    return rng.choice(6, steps * 120, p=p / p.sum()).astype(np.uint8)


def _corrupt(stream, seed):
    """Flip 3 seeded bits inside the code bytes (length unchanged)."""
    rng = np.random.default_rng(seed)
    code = stream.code_bytes.copy()
    pos = rng.choice(8 * (code.size - 2), 3, replace=False)
    np.bitwise_xor.at(code, pos // 8, (128 >> (pos % 8)).astype(np.uint8))
    return dataclasses.replace(stream, code_bytes=code)


@pytest.fixture(scope="module")
def b2():
    """steps -> (symbols, stream); and a memo of JAX checked decodes."""
    streams = {}
    for n in B2_STEPS:
        sym = _b2_symbols(n)
        streams[n] = (sym, native.encode_symbols(sym, block_size=n))
    memo = {}

    def jax_checked(stream, n, delta):
        key = (stream.code_bytes.tobytes(), n, delta)
        if key not in memo:
            blk, err = decode_pallas.decode_stream_checked(
                stream, delta=delta, block_size=n, interpret=True)
            memo[key] = (np.asarray(blk), np.asarray(err))
        return memo[key]

    return streams, jax_checked


def _plain(stream, n, delta):
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    return decode_cuda.decode_blocks(
        torch.from_numpy(words), torch.from_numpy(offsets),
        decode_cuda.stage_code(stream.widths, "cpu"), num_steps=n,
        delta=delta, emit_end=True)


def _plain_err(stream, n, end):
    """The port's mask: end bits vs targets, last block in its window."""
    err = decode_cuda.check_block_ends(
        end.numpy(), decode_cuda.block_end_targets(stream.block_offsets, None))
    lo, hi = decode_cuda.last_block_window(stream, n)
    err[-1] = not lo <= int(end[-1]) <= hi
    return err


@pytest.mark.parametrize("n,mode", B2_CASES, ids=lambda v: str(v))
def test_decode_blocks_plain_matches_pallas(b2, n, mode):
    streams, jax_checked = b2
    sym, stream = streams[n]
    delta = mode == "delta"
    out, end = _plain(stream, n, delta)
    assert out.shape == (sym.size // n, n) and out.dtype == torch.uint8
    src = sym.reshape(-1, n)
    if delta:
        src = (np.cumsum(src, 1) & 0xFF).astype(np.uint8)
    np.testing.assert_array_equal(out.numpy(), src)
    if delta and n == 256:
        ref, ref_err = jax_checked(stream, n, False)
        ref = (np.cumsum(ref, 1, dtype=np.int64) & 0xFF).astype(np.uint8)
    else:
        ref, ref_err = jax_checked(stream, n, delta)
    np.testing.assert_array_equal(out.numpy(), ref)
    # clean: the end bits hit every target, as the JAX check finds
    err = _plain_err(stream, n, end)
    assert not err.any() and not ref_err.any()
    targets = decode_cuda.block_end_targets(stream.block_offsets, None)
    np.testing.assert_array_equal(end.numpy()[:-1], targets[:-1])


@pytest.mark.parametrize("n", B2_STEPS)
def test_decode_blocks_corrupt_mask_matches_pallas(b2, n):
    streams, jax_checked = b2
    _sym, stream = streams[n]
    flagged = 0
    for seed in range(3):
        bad = _corrupt(stream, 100 * n + seed)
        _out, end = _plain(bad, n, False)
        err = _plain_err(bad, n, end)
        _ref, ref_err = jax_checked(bad, n, False)
        np.testing.assert_array_equal(err, ref_err)
        flagged += int(err.sum())
    assert flagged  # desyncs happened, and both checks saw the same ones


def test_decode_blocks_selection_order_and_repeats():
    sym = _b2_symbols(16)
    stream = native.encode_symbols(sym, block_size=16)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    sel = np.random.default_rng(0).integers(0, offsets.size, 200)
    out = decode_cuda.decode_blocks(
        torch.from_numpy(words), torch.from_numpy(offsets[sel].copy()),
        decode_cuda.stage_code(stream.widths, "cpu"), num_steps=16,
        delta=True)
    src = (np.cumsum(sym.reshape(-1, 16), 1) & 0xFF).astype(np.uint8)
    np.testing.assert_array_equal(out.numpy(), src[sel])


def test_decode_blocks_routes_cpu_tensors_to_plain():
    sym = _b2_symbols(4)
    stream = native.encode_symbols(sym, block_size=4)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            decode_cuda.stage_code(stream.widths, "cpu"))
    before = dict(decode_cuda.launches)
    out = decode_cuda.decode_blocks(*args, num_steps=4, delta=False)
    assert decode_cuda.launches == before
    assert torch.equal(out, decode_cuda.decode_blocks_plain(
        *args, num_steps=4, delta=False))


def test_decode_blocks_delta2d_at_64_matches_images():
    # the in-kernel 2-D predictor of B2 equals B1's on the same 8x8 blocks
    frames = _frames(1, 16, 24, seed=6)
    cfg = CodecConfig(delta2d=True)
    stream = _stream(frames, cfg)
    _meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            decode_cuda.stage_code(stream.widths, "cpu"))
    out, end = decode_cuda.decode_blocks(*args, num_steps=64, delta=False,
                                         delta2d=True, emit_end=True)
    img, img_end = decode_cuda.decode_images(
        *args, num_frames=1, bh=2, bw=3, delta=False, delta2d=True,
        emit_end=True)
    np.testing.assert_array_equal(out.numpy(), blocks.image_to_blocks(img[0]))
    assert torch.equal(end, img_end)
