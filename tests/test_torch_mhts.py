"""Slice-level parity of the port with the JAX package on the per-frame-table
MHTS container: encode and container I/O, the record walk and its
truncation errors, the one-frame-at-a-time reader with its end-bit check,
mixed predictors, and the batch decode (one kernel launch per frame, each
with its own lookup table, into one output).

The JAX side runs its host C++ decoder (``backend="native"``) except in one
case, the batch decode, which runs its jnp path (``backend="xla"``). The
port runs its plain PyTorch path on CPU tensors, and in the routing tests
its CUDA path up to the C call. Every comparison is exact.
"""

import dataclasses
import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu.models import image_codec as jic
from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import decode_cuda

NATIVE = JaxConfig(backend="native")
CONFIGS = {
    "none": {"delta": False},
    "delta": {},
    "zero_init": {"zero_init": True},
    "delta2d": {"delta2d": True},
    "2x2": {"block_dim": 2},
    "16x16 zero_init": {"block_dim": 16, "zero_init": True},
}
H, W = 24, 40


def _frames(t, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        # a noisier frame every other frame: each frame gets its own table
        img = img + rng.normal(0, 2 + 6 * (i % 2), (h, w))
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return np.stack(out)


def _crcs(frames):
    return [zlib.crc32(f.tobytes()) for f in frames]


def _assert_streams_equal(a, b):
    assert a.num_symbols == b.num_symbols
    assert a.predictor == b.predictor
    for field in ("widths", "code_bytes", "block_offsets"):
        np.testing.assert_array_equal(getattr(a, field), getattr(b, field))
        assert getattr(a, field).dtype == getattr(b, field).dtype
    if a.block_init is None:
        assert b.block_init is None
    else:
        np.testing.assert_array_equal(a.block_init, b.block_init)


def _mhts(frames, name="delta", crcs=True):
    cfg = dataclasses.replace(NATIVE, **CONFIGS[name])
    return jfs.write_stream(jfs.encode_frames(frames, cfg), frames.shape[1],
                            frames.shape[2], cfg,
                            source_crc32s=_crcs(frames) if crcs else None)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_frames_matches_jax(name):
    frames = _frames(3, seed=len(name))
    ours = tfs.encode_frames(frames, CodecConfig(**CONFIGS[name]))
    ref = jfs.encode_frames(frames, dataclasses.replace(NATIVE,
                                                        **CONFIGS[name]))
    assert len(ours) == len(ref) == 3
    for a, b in zip(ours, ref):
        _assert_streams_equal(a, b)
    assert len({s.widths.tobytes() for s in ours}) > 1  # a table per frame
    with pytest.raises(ValueError, match="frames must be"):
        tfs.encode_frames(frames[0])


@pytest.mark.parametrize("crcs", [False, True], ids=["no-crc", "crc"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_write_stream_is_byte_identical_and_read_by_both(name, crcs):
    frames = _frames(3, seed=5)
    streams = jfs.encode_frames(frames, dataclasses.replace(NATIVE,
                                                            **CONFIGS[name]))
    ours = tfs.write_stream(streams, H, W, CodecConfig(**CONFIGS[name]),
                            source_crc32s=_crcs(frames) if crcs else None)
    assert ours == _mhts(frames, name, crcs)
    got, *geo = tfs.read_stream(ours)
    want, *ref_geo = jfs.read_stream(ours)
    assert geo == ref_geo
    for a, b in zip(got, want):
        _assert_streams_equal(a, b)
    assert tfs.read_stream_crcs(ours) == jfs.read_stream_crcs(ours) == (
        _crcs(frames) if crcs else [0, 0, 0])
    assert tfs.stream_frame_count(ours) == jfs.stream_frame_count(ours) == 3
    with pytest.raises(ValueError, match="one entry per frame"):
        tfs.write_stream(streams, H, W, source_crc32s=[1])


def test_a_cut_mhts_raises_what_jax_raises():
    frames = _frames(3, seed=6)
    blob = _mhts(frames)
    readers = {
        "read_stream": (tfs.read_stream, jfs.read_stream),
        "read_stream_crcs": (tfs.read_stream_crcs, jfs.read_stream_crcs),
        "stream_frame_count": (tfs.stream_frame_count,
                               jfs.stream_frame_count),
        "iter_stream_frames": (
            lambda b: list(tfs.iter_stream_frames(b, device="cpu")),
            lambda b: list(jfs.iter_stream_frames(b, NATIVE))),
    }
    rec = int.from_bytes(blob[8:12], "little")
    cuts = [0, 3, 5, 6, 9, 11, 12 + rec // 2, 12 + rec, 12 + rec + 2,
            len(blob) // 2, len(blob) - 1]
    for cut in cuts:
        for name, (ours, ref) in readers.items():
            try:
                want = ref(blob[:cut])
            except Exception as e:  # noqa: BLE001 - the port must raise the same
                with pytest.raises(type(e)) as got:
                    ours(blob[:cut])
                assert str(got.value) == str(e), (cut, name)
                continue
            assert name == "stream_frame_count" and ours(blob[:cut]) == want
    for bad in (b"MHTS" + bytes(4), b"MHTV" + bytes(8)):
        for name, (ours, ref) in readers.items():
            try:
                ref(bad)
            except ValueError as e:
                with pytest.raises(ValueError) as got:
                    ours(bad)
                assert str(got.value) == str(e), name
            else:
                assert ours(bad) == ref(bad)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_iter_stream_frames_matches_jax(name):
    frames = _frames(4, seed=7)
    blob = _mhts(frames, name)
    ours = list(tfs.iter_stream_frames(blob, device="cpu"))
    ref = list(jfs.iter_stream_frames(blob, NATIVE))
    assert [i for i, *_ in ours] == [0, 1, 2, 3]
    for (i, f, err, crc), (_, rf, rerr, rcrc) in zip(ours, ref):
        assert f.shape == (H, W) and f.dtype == np.uint8
        np.testing.assert_array_equal(f, rf)
        np.testing.assert_array_equal(f, frames[i])
        assert err is None and rerr is None
        assert crc == rcrc == zlib.crc32(frames[i].tobytes())


def _native_mask(stream, h, w, bd=8):
    """The JAX package's host check of every block of a stream, in stream
    order (the end-bit check computed from the decoded symbols)."""
    bh, bw = -(-h // bd), -(-w // bd)
    _, err = jic.decode_blocks_selection(
        stream, np.arange(bh * bw), bh * bd, bw * bd,
        dataclasses.replace(NATIVE, block_dim=bd), check=True)
    return err


def test_iter_stream_frames_check_matches_the_host_check():
    frames = _frames(3, seed=8)
    streams = jfs.encode_frames(frames, NATIVE)
    for _, f, err, _ in tfs.iter_stream_frames(_mhts(frames), check=True,
                                               device="cpu"):
        assert err.dtype == np.bool_ and err.size == 15 and not err.any()
    s1 = streams[1]
    rng = np.random.default_rng(8)
    flagged = 0
    for _ in range(24):
        bit = int(rng.integers(0, 8 * (s1.code_bytes.size - 2)))
        code = s1.code_bytes.copy()
        code[bit // 8] ^= 128 >> (bit % 8)
        bad = dataclasses.replace(s1, code_bytes=code)
        blob = jfs.write_stream([streams[0], bad, streams[2]], H, W, NATIVE)
        got = list(tfs.iter_stream_frames(blob, check=True, device="cpu"))
        assert not got[0][2].any() and not got[2][2].any()
        np.testing.assert_array_equal(got[1][2], _native_mask(bad, H, W))
        flagged += bool(got[1][2].any())
    assert flagged


def test_mixed_predictors_decode_per_record():
    frames = _frames(3, seed=9)
    s0 = jic.ImageCodec(NATIVE).encode(frames[0])
    s1 = jic.ImageCodec(dataclasses.replace(NATIVE, delta2d=True)).encode(
        frames[1])
    s2 = jic.ImageCodec(dataclasses.replace(NATIVE, zero_init=True)).encode(
        frames[2])
    blob = jfs.write_stream([s0, s1, s2], H, W, NATIVE)
    with pytest.raises(ValueError, match="one predictor") as ours:
        tfs.prepare_batch([s0, s1], H, W, device="cpu")
    with pytest.raises(ValueError, match="one predictor") as ref:
        jfs.prepare_batch([s0, s1], H, W, NATIVE)
    assert str(ours.value) == str(ref.value)
    for check in (False, True):
        got = [f for _, f, _, _ in tfs.iter_stream_frames(
            blob, check=check, device="cpu")]
        np.testing.assert_array_equal(np.stack(got), frames)
    ref = [f for _, f, _, _ in jfs.iter_stream_frames(blob, NATIVE)]
    np.testing.assert_array_equal(np.stack(ref), frames)
    got, *_ = tfs.decode_range(blob, 0, 3, device="cpu")
    np.testing.assert_array_equal(got, frames)


def test_decode_batch_matches_jax_xla():
    frames = _frames(3, 16, 24, seed=10)
    streams = jfs.encode_frames(frames, NATIVE)
    jprep = jfs.prepare_batch(streams, 16, 24, JaxConfig(backend="xla"))
    ref = np.asarray(jfs.decode_batch(jprep, JaxConfig(backend="xla")))
    prep = tfs.prepare_batch(streams, 16, 24, device="cpu")
    out = tfs.decode_batch(prep)
    assert out.shape == (3, 16, 24) and out.is_contiguous()
    np.testing.assert_array_equal(out.numpy(), ref)
    np.testing.assert_array_equal(ref, frames)


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_batch_every_block_size_and_precoder(name):
    frames = _frames(4, 20, 36, seed=11)  # padded at every block size
    cfg = CodecConfig(**CONFIGS[name])
    blob = tfs.write_stream(tfs.encode_frames(frames, cfg), 20, 36, cfg)
    streams, *_ = tfs.read_stream(blob)
    out = tfs.decode_batch(tfs.prepare_batch(streams, 20, 36, cfg,
                                             device="cpu"), cfg)
    np.testing.assert_array_equal(out.numpy(), frames)
    ref, *_ = jfs.decode_range(blob, 0, 4, NATIVE)
    np.testing.assert_array_equal(out.numpy(), ref)
    with pytest.raises(ValueError, match="block_dim"):
        tfs.decode_batch(tfs.prepare_batch(streams, 20, 36, cfg,
                                           device="cpu"),
                         CodecConfig(block_dim=4 if cfg.block_dim != 4 else 8))


def test_prepare_batch_stages_a_table_per_frame_in_one_tensor():
    frames = _frames(4, seed=12)
    streams = tfs.encode_frames(frames)
    prep = tfs.prepare_batch(streams, H, W, device="cpu")
    assert len(prep.frames) == 4 and prep.init_b is None
    storages = set()
    for f, s in zip(prep.frames, streams):
        want = decode_cuda.lookup_entries(decode_cuda.canonical_meta(s.widths))
        np.testing.assert_array_equal(f.table.entries.numpy().view(np.uint16),
                                      want)
        assert f.table.entries.data_ptr() % 16 == 0
        for x in (f.words, f.offsets, f.symbols, f.table.entries):
            storages.add(x.untyped_storage().data_ptr())
        np.testing.assert_array_equal(f.symbols.numpy(),
                                      decode_cuda.canonical_meta(
                                          s.widths).symbols)
    assert len(storages) == 4  # words, offsets, symbols, tables
    with pytest.raises(ValueError, match="blocks"):
        tfs.prepare_batch(streams, H, W + 8, device="cpu")
    with pytest.raises(ValueError, match="empty"):
        tfs.prepare_batch([], H, W, device="cpu")


@pytest.fixture
def as_cuda(monkeypatch):
    """CPU tensors routed as CUDA ones, with the launch recorded instead of
    made: the wrappers' CUDA path, up to the C call, without a card."""
    calls = []
    real = decode_cuda._check_inputs
    monkeypatch.setattr(decode_cuda, "_check_inputs",
                        lambda *a: "cuda" if real(*a) == "cpu" else "?")
    monkeypatch.setattr(_build, "launch",
                        lambda name, device, *args: calls.append((name, args)))
    return calls


@pytest.mark.parametrize("bd", [8, 4])
def test_decode_batch_launches_once_per_frame_with_its_table(as_cuda, bd):
    frames = _frames(3, seed=13)
    cfg = CodecConfig(block_dim=bd)
    prep = tfs.prepare_batch(tfs.encode_frames(frames, cfg), H, W, cfg,
                             device="cpu")
    before = dict(decode_cuda.launches)
    out = tfs.decode_batch(prep, cfg)
    assert out.shape == (3, H, W)
    kernel = "decode_images" if bd == 8 else "decode_blocks"
    assert [name for name, _ in as_cuda] == [kernel] * 3
    assert decode_cuda.launches[kernel] == before[kernel] + 3
    nb = prep.bh * prep.bw
    outs = []
    for f, (_, args) in zip(prep.frames, as_cuda):
        assert args[0] == f.words.data_ptr() and args[1] == f.words.numel()
        assert args[2] == f.offsets.data_ptr() and args[3] == nb
        k = 6 if bd == 8 else 5  # the table follows the geometry
        assert args[k : k + 2] == (f.table.entries.data_ptr(),
                                   f.table.entries.numel())
        outs.append(args[k + 4])
    # one output: each launch writes the next frame's rows of it
    step = {8: (prep.bh * 8) * (prep.bw * 8), 4: nb * 16}[bd]
    assert [p - outs[0] for p in outs] == [0, step, 2 * step]


def test_decode_wrappers_write_into_out():
    frames = _frames(2, 16, 24, seed=14)
    stream = tfs.encode_frames_shared(frames)
    prep = tfs.prepare_shared(stream, 2, 16, 24, device="cpu")
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    geo = dict(num_frames=2, bh=2, bw=3, delta=True)
    out = torch.empty((2, 16, 24), dtype=torch.uint8)
    got, end = decode_cuda.decode_images(*args, **geo, emit_end=True, out=out)
    assert got is out and end.shape == (12,)
    np.testing.assert_array_equal(out.numpy(), frames)
    blk = torch.empty((12, 64), dtype=torch.uint8)
    assert decode_cuda.decode_blocks(*args, num_steps=64, delta=True,
                                     out=blk) is blk
    np.testing.assert_array_equal(
        blk.numpy(), decode_cuda.decode_blocks(*args, num_steps=64,
                                               delta=True).numpy())
    for bad in (torch.empty((2, 16, 16), dtype=torch.uint8),
                torch.empty((2, 16, 24), dtype=torch.int32),
                torch.empty((2, 24, 16), dtype=torch.uint8).transpose(1, 2),
                torch.empty(2 * 16 * 24 + 1, dtype=torch.uint8)[1:].view(
                    2, 16, 24)):
        with pytest.raises(ValueError, match="out must be"):
            decode_cuda.decode_images(*args, **geo, out=bad)
    # 2x2 blocks store 4 bytes at a time: 4-byte alignment is enough
    small = torch.empty(12 * 4 + 4, dtype=torch.uint8)[4:].view(12, 4)
    cfg = CodecConfig(block_dim=2)
    s2 = tfs.encode_frames_shared(frames[:, :4, :6], cfg)
    p2 = tfs.prepare_shared(s2, 2, 4, 6, cfg, device="cpu")
    decode_cuda.decode_blocks(p2.words, p2.offsets, p2.symbols, p2.bounds,
                              p2.adj, num_steps=4, delta=True, out=small)
    with pytest.raises(ValueError, match="4-byte aligned"):
        decode_cuda.decode_blocks(
            p2.words, p2.offsets, p2.symbols, p2.bounds, p2.adj, num_steps=4,
            delta=True,
            out=torch.empty(12 * 4 + 2, dtype=torch.uint8)[2:].view(12, 4))
