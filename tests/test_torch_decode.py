"""Parity of the port's decode op (metalhuffman_tpu_torch.ops.decode_cuda)
with the JAX package's Pallas decode, run in interpret mode on the CPU.

Every comparison is exact byte equality: the codec is lossless integer
arithmetic, so the tolerance is 0.
"""

import numpy as np
import pytest
import torch

from metalhuffman_tpu import native
from metalhuffman_tpu.core import blocks, container
from metalhuffman_tpu.models import CodecConfig, frame_stream
from metalhuffman_tpu.ops import decode_pallas
from metalhuffman_tpu_torch.ops import decode_cuda


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

    meta, words, offsets = decode_cuda.prepare_stream(stream)
    bh, bw = blocks.block_grid(h, w)
    out = decode_cuda.decode_images_plain(
        torch.from_numpy(words), torch.from_numpy(offsets),
        torch.from_numpy(meta.symbols), meta.bounds, meta.adj,
        num_frames=t, bh=bh, bw=bw, delta=cfg.delta and not cfg.delta2d,
        delta2d=cfg.delta2d)
    assert out.shape == (t, bh * 8, bw * 8) and out.dtype == torch.uint8
    np.testing.assert_array_equal(out[:, :h, :w].numpy(), ref)


def test_decode_images_routes_cpu_tensors_to_plain():
    frames = _frames(2, 24, 40, seed=3)
    cfg = CodecConfig()
    stream = _stream(frames, cfg)
    meta, words, offsets = decode_cuda.prepare_stream(stream)
    args = (torch.from_numpy(words), torch.from_numpy(offsets),
            torch.from_numpy(meta.symbols), meta.bounds, meta.adj)
    geo = dict(num_frames=2, bh=3, bw=5, delta=True)
    before = decode_cuda.launches
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
