"""Slice-level parity of the port with the JAX package on segmented (MHV2)
video: segment sizing, the segmented encode and its overflow halving, the
MHV2 container and its per-frame CRC extension (FCRC), the top-level
``encode_video``/``decode_video``, the two-in-flight streaming decode and the
checked decode.

The JAX side runs its host C++ decoder (``backend="native"``) except in one
case, the checked decode, which needs its device path (Pallas in interpret
mode). The port runs its plain PyTorch path on CPU tensors. Every comparison
is exact.
"""

import dataclasses
import struct
import subprocess
import sys
import zlib
from pathlib import Path

import numpy as np
import pytest
import torch

import metalhuffman_tpu
import metalhuffman_tpu_torch
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import frame_stream as jfs
from metalhuffman_tpu_torch import native
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models.config import CodecConfig

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
CONFIGS = {
    "none": {"delta": False},
    "delta": {},
    "zero_init": {"zero_init": True},
    "delta2d": {"delta2d": True},
    "zero_init_delta2d": {"zero_init": True, "delta2d": True},
    "4x4": {"block_dim": 4},
}
H, W = 16, 32
#: two 16x32 frames per segment (8,192 symbols at 10 bits per symbol)
TWO_FRAMES = 2 * H * W * 10


def _frames(t, h=H, w=W, seed=0):
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    out = []
    for i in range(t):
        img = 100 + 60 * np.sin((xx + 5 * i) / 17.0) * np.cos(yy / 13.0)
        out.append(np.clip(img + rng.normal(0, 2, (h, w)), 0, 255).astype(np.uint8))
    return np.stack(out)


def _native(**kw):
    return JaxConfig(backend="native", **kw)


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


def _assert_segments_equal(ours, ref):
    assert [t for _, t in ours] == [t for _, t in ref]
    for (a, _), (b, _) in zip(ours, ref):
        _assert_streams_equal(a, b)


def _mhv2(frames, name="delta", fcrc=False):
    """A JAX-written MHV2 blob of ``frames``, two frames per segment."""
    cfg = _native(**CONFIGS[name])
    segs = jfs.encode_frames_segmented(frames, cfg, max_segment_bits=TWO_FRAMES)
    return jfs.write_segmented(
        segs, frames.shape[1], frames.shape[2], cfg,
        source_crc32=zlib.crc32(frames.tobytes()),
        frame_crcs=jfs.compute_frame_crcs(frames) if fcrc else None)


@pytest.mark.parametrize("num_frames,frame_symbols,max_bits", [
    (1, 64, 1 << 32), (150, 2048 * 1536, (1 << 32) - 1024),
    (137, 2048 * 1536, (1 << 32) - 1024), (136, 2048 * 1536, (1 << 32) - 1024),
    (7, 512, 512 * 10 * 3), (5, 512, 100), (0, 64, 1 << 20),
    (1000, 1920 * 1088, (1 << 32) - 1024)])
def test_segment_frame_counts_match_jax(num_frames, frame_symbols, max_bits):
    ours = tfs.segment_frame_counts(num_frames, frame_symbols, max_bits)
    assert ours == jfs.segment_frame_counts(num_frames, frame_symbols, max_bits)
    assert sum(ours) == num_frames
    assert tfs._SEG_BITS_PER_SYMBOL == jfs._SEG_BITS_PER_SYMBOL


def test_full_screen_clips_split_at_136_frames():
    # 2048x1536: (2^32 - 1024) // (3,145,728 x 10) = 136 frames per segment
    assert tfs.segment_frame_counts(150, 2048 * 1536) == [136, 14]
    assert tfs.segment_frame_counts(137, 2048 * 1536) == [136, 1]
    assert tfs.segment_frame_counts(136, 2048 * 1536) == [136]


@pytest.mark.parametrize("name", list(CONFIGS))
def test_encode_frames_segmented_matches_jax(name):
    frames = _frames(5, seed=len(name))
    ours = tfs.encode_frames_segmented(frames, CodecConfig(**CONFIGS[name]),
                                       max_segment_bits=TWO_FRAMES)
    ref = jfs.encode_frames_segmented(frames, _native(**CONFIGS[name]),
                                      max_segment_bits=TWO_FRAMES)
    assert [t for _, t in ours] == [2, 2, 1]
    _assert_segments_equal(ours, ref)


def test_encode_frames_segmented_refuses_what_jax_refuses():
    for bad in (np.zeros((2, 4), np.uint8), np.zeros((0, 8, 8), np.uint8)):
        for encode, cfg in ((tfs.encode_frames_segmented, CodecConfig()),
                            (jfs.encode_frames_segmented, _native())):
            with pytest.raises(ValueError):
                encode(bad, cfg)
    with pytest.raises(ValueError, match="zero_init requires delta"):
        tfs.encode_frames_segmented(_frames(1),
                                    CodecConfig(delta=False, zero_init=True))


def test_overflow_raises_value_error_and_segments_halve(monkeypatch):
    # the port's encoder raises ValueError(OVERFLOW_ERROR) on a stream past
    # 2^32 bits, as the JAX package's does; here any payload over 2 frames
    # overflows, so segments of 5 halve into 2, 1 (retry), 2
    frames = _frames(5, seed=3)
    real = native.encode_symbols
    limit = 2 * H * W

    def capped(data, *args, **kwargs):
        if np.asarray(data).size > limit:
            raise ValueError(native.OVERFLOW_ERROR)
        return real(data, *args, **kwargs)

    monkeypatch.setattr(native, "encode_symbols", capped)
    with pytest.raises(ValueError, match="2\\^32 bits"):
        tfs.encode_frames_shared(frames)
    segs = tfs.encode_frames_segmented(frames, max_segment_bits=5 * H * W * 10)
    assert [t for _, t in segs] == [2, 1, 2]
    ref = jfs.encode_frames_shared

    def capped_ref(f, cfg):
        if len(f) > 2:
            raise ValueError("overflow")
        return ref(f, cfg)

    monkeypatch.setattr(jfs, "encode_frames_shared", capped_ref)
    _assert_segments_equal(
        segs, jfs.encode_frames_segmented(frames, _native(),
                                          max_segment_bits=5 * H * W * 10))
    out = metalhuffman_tpu_torch.decode_video(
        tfs.write_segmented(segs, H, W, source_crc32=zlib.crc32(
            frames.tobytes())), "cpu")
    np.testing.assert_array_equal(out, frames)
    # one frame over the limit: nothing to split, the error stands
    limit = 0
    with pytest.raises(ValueError, match="2\\^32 bits"):
        tfs.encode_frames_segmented(frames[:2], max_segment_bits=1)


@pytest.mark.parametrize("fcrc", [False, True], ids=["no-fcrc", "fcrc"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_write_segmented_is_byte_identical_and_read_by_both(name, fcrc):
    frames = _frames(5, seed=7)
    segs = jfs.encode_frames_segmented(frames, _native(**CONFIGS[name]),
                                       max_segment_bits=TWO_FRAMES)
    crc = zlib.crc32(frames.tobytes())
    fcrcs = jfs.compute_frame_crcs(frames) if fcrc else None
    ours = tfs.write_segmented(segs, H, W, CodecConfig(**CONFIGS[name]),
                               source_crc32=crc, frame_crcs=fcrcs)
    ref = jfs.write_segmented(segs, H, W, _native(**CONFIGS[name]),
                              source_crc32=crc, frame_crcs=fcrcs)
    assert ours == ref
    got, *geo = tfs.read_segmented(ref)
    want, *ref_geo = jfs.read_segmented(ours)
    assert geo == ref_geo == [5, H, W, CONFIGS[name].get("block_dim", 8),
                              name != "none"]
    _assert_segments_equal(got, want)
    assert tfs.source_crc32(ours) == jfs.source_crc32(ours) == crc
    if fcrc:
        np.testing.assert_array_equal(tfs.read_frame_crcs(ours),
                                      jfs.read_frame_crcs(ours))
        np.testing.assert_array_equal(tfs.compute_frame_crcs(frames), fcrcs)
    else:
        assert tfs.read_frame_crcs(ours) is None


def test_write_segmented_refuses_what_jax_refuses():
    frames = _frames(2, seed=8)
    a = tfs.encode_frames_shared(frames[:1])
    b = tfs.encode_frames_shared(frames[1:], CodecConfig(zero_init=True))
    for write, cfg in ((tfs.write_segmented, CodecConfig()),
                       (jfs.write_segmented, _native())):
        with pytest.raises(ValueError, match="empty"):
            write([], H, W, cfg)
        with pytest.raises(ValueError, match="share one"):
            write([(a, 1), (b, 1)], H, W, cfg)


def _cut_points(blob: bytes) -> dict:
    """Where to cut an MHV2 blob: in the header, in segment 1's header,
    core, offsets and root bytes (zero-init only), in the CRC trailer, in
    the FCRC table."""
    mode = blob[17]  # after magic, (T, H, W) u32 and block_dim u8
    pos = 22
    spans = []
    for _ in range(struct.unpack_from("<I", blob, 18)[0]):
        _t, nb, core_len = struct.unpack_from("<III", blob, pos)
        spans.append((pos, nb, core_len))
        pos += 12 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
    seg, nb, core_len = spans[1]
    index = seg + 12 + core_len
    cuts = {"header": 15, "segment header": seg + 6,
            "core": seg + 12 + core_len // 2, "index": index + 2 * nb,
            "crc": pos + 2, "fcrc": len(blob) - 3}
    if mode in (2, 4):
        cuts["block_init"] = index + 4 * nb + nb // 2
    return cuts


@pytest.mark.parametrize("name", ["delta", "zero_init"])
def test_read_segmented_of_a_cut_blob_matches_jax(name):
    frames = _frames(5, seed=9)
    blob = _mhv2(frames, name, fcrc=True)
    for where, at in _cut_points(blob).items():
        cut = blob[:at]
        for read in ("read_segmented", "source_crc32", "read_frame_crcs"):
            try:
                ref = getattr(jfs, read)(cut)
            except Exception as e:  # noqa: BLE001 - the port must raise the same
                with pytest.raises(type(e)) as ours:
                    getattr(tfs, read)(cut)
                assert str(ours.value) == str(e), (where, read)
                continue
            got = getattr(tfs, read)(cut)
            if read == "read_segmented":
                _assert_segments_equal(got[0], ref[0])
                assert got[1:] == ref[1:]
            elif read == "read_frame_crcs" and ref is not None:
                np.testing.assert_array_equal(got, ref)
            else:
                assert got == ref, (where, read)
    # only the trailers may go: the rest raises in both readers
    with pytest.raises(ValueError):
        tfs.read_segmented(blob[: _cut_points(blob)["index"]])
    with pytest.raises(struct.error):
        tfs.read_segmented(blob[: _cut_points(blob)["segment header"]])


def test_frame_crc_helpers_match_jax():
    frames = _frames(4, seed=10)
    fcrcs = tfs.compute_frame_crcs(frames)
    assert fcrcs.dtype == np.uint32
    np.testing.assert_array_equal(fcrcs, jfs.compute_frame_crcs(frames))
    for verify in (tfs.verify_frame_crcs, jfs.verify_frame_crcs):
        verify(frames, None)
        verify(frames[1:3], fcrcs, base=1)
        with pytest.raises(ValueError, match="shorter than the stream"):
            verify(frames, fcrcs[:3])
        bad = frames.copy()
        bad[2, 5, 5] ^= 1
        with pytest.raises(ValueError, match="decoded frame 2 fails"):
            verify(bad, fcrcs)
    # MHTV carries the extension too, after its CRC trailer
    stream = tfs.encode_frames_shared(frames)
    blob = tfs.write_shared(stream, 4, H, W, source_crc32=7, frame_crcs=fcrcs)
    assert blob == jfs.write_shared(stream, 4, H, W, _native(),
                                    source_crc32=7, frame_crcs=fcrcs)
    np.testing.assert_array_equal(tfs.read_frame_crcs(blob), fcrcs)
    assert tfs.source_crc32(blob) == 7
    with pytest.raises(ValueError, match="truncated FCRC"):
        tfs.read_frame_crcs(blob[:-2])
    with pytest.raises(ValueError, match="MHTV/MHV2"):
        tfs.source_crc32(b"MHTS" + bytes(8))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_decode_video_mhv2_matches_jax(name):
    frames = _frames(5, seed=11)
    blob = _mhv2(frames, name)
    ours = metalhuffman_tpu_torch.decode_video(blob, "cpu")
    np.testing.assert_array_equal(ours, metalhuffman_tpu.decode_video(
        blob, _native()))
    np.testing.assert_array_equal(ours, frames)


def test_decode_video_mhv2_source_crc_mismatch_raises():
    frames = _frames(5, seed=12)
    blob = bytearray(_mhv2(frames, fcrc=True))
    at = tfs._trailer_offset(bytes(blob))
    blob[at] ^= 0xFF
    for decode in (lambda b: metalhuffman_tpu_torch.decode_video(b, "cpu"),
                   lambda b: metalhuffman_tpu.decode_video(b, _native())):
        with pytest.raises(ValueError, match="CRC-32 mismatch"):
            decode(bytes(blob))


@pytest.mark.parametrize("fcrc", [False, True], ids=["no-fcrc", "fcrc"])
@pytest.mark.parametrize("segmented", [False, True], ids=["MHTV", "MHV2"])
def test_encode_video_matches_jax(monkeypatch, segmented, fcrc):
    frames = _frames(5, seed=13)
    if segmented:  # two 16x32 frames per segment in both packages
        for fs in (tfs, jfs):
            monkeypatch.setattr(fs, "_SEG_BITS_PER_SYMBOL",
                                ((1 << 32) - 1024) // (2 * H * W))
    ours = metalhuffman_tpu_torch.encode_video(
        frames, CodecConfig(frame_crcs=fcrc))
    ref = metalhuffman_tpu.encode_video(frames, _native(frame_crcs=fcrc))
    assert ours == ref
    assert ours[:4] == (b"MHV2" if segmented else b"MHTV")
    assert (tfs.read_frame_crcs(ours) is not None) == fcrc
    assert tfs.source_crc32(ours) == zlib.crc32(frames.tobytes())
    np.testing.assert_array_equal(
        metalhuffman_tpu_torch.decode_video(ours, "cpu"), frames)
    np.testing.assert_array_equal(
        metalhuffman_tpu.decode_video(ours, _native()), frames)


def test_encode_video_temporal_is_not_ported():
    # ported since: the temporal branch writes the JAX package's MHVT bytes
    frames = _frames(3)
    ours = metalhuffman_tpu_torch.encode_video(
        frames, CodecConfig(temporal=True, keyint=2))
    assert ours[:4] == b"MHVT"
    assert ours == metalhuffman_tpu.encode_video(
        frames, _native(temporal=True, keyint=2))
    np.testing.assert_array_equal(
        metalhuffman_tpu_torch.decode_video(ours, "cpu"), frames)


@pytest.mark.parametrize("name", ["delta", "zero_init", "4x4"])
def test_iter_frames_segmented_matches_jax(name):
    frames = _frames(5, seed=14)
    segs, *_ = tfs.read_segmented(_mhv2(frames, name))
    ours = list(tfs.iter_frames_segmented(
        segs, H, W, CodecConfig(**CONFIGS[name]), device="cpu"))
    ref = list(jfs.iter_frames_segmented(segs, H, W, _native(**CONFIGS[name])))
    assert [o.shape[0] for o in ours] == [2, 2, 1]
    for a, b in zip(ours, ref):
        assert isinstance(a, np.ndarray) and a.dtype == np.uint8
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(ours), frames)


def test_streaming_decoder_keeps_two_segments_in_flight(monkeypatch):
    frames = _frames(7, seed=15)
    segs, *_ = tfs.read_segmented(_mhv2(frames))
    events = []
    submit, result = tfs.StreamingDecoder.submit, tfs.StreamingDecoder.result

    def spy_submit(self, stream, *args):
        events.append(("submit", [s is stream for s, _ in segs].index(True)))
        return submit(self, stream, *args)

    def spy_result(self, handle):
        events.append(("result",))
        return result(self, handle)

    monkeypatch.setattr(tfs.StreamingDecoder, "submit", spy_submit)
    monkeypatch.setattr(tfs.StreamingDecoder, "result", spy_result)
    out = tfs.decode_frames_segmented(segs, H, W, device="cpu")
    np.testing.assert_array_equal(out, frames)
    assert events == [("submit", 0), ("submit", 1), ("result",),
                      ("submit", 2), ("result",), ("submit", 3), ("result",),
                      ("result",)]


def test_streaming_decoder_direct_use():
    frames = _frames(4, seed=16)
    dec = tfs.StreamingDecoder(CodecConfig(), device="cpu")
    handles = [dec.submit(tfs.encode_frames_shared(frames[i : i + 2]), 2,
                          H, W) for i in (0, 2)]
    np.testing.assert_array_equal(
        np.concatenate([dec.result(h) for h in handles]), frames)
    # 4x4 blocks: the image form (no raw output off 8x8)
    cfg = CodecConfig(block_dim=4)
    dec = tfs.StreamingDecoder(cfg, device="cpu")
    got = dec.result(dec.submit(tfs.encode_frames_shared(frames, cfg), 4,
                                H, W))
    np.testing.assert_array_equal(got, frames)
    assert tfs.decode_frames_segmented([], H, W, device="cpu").shape == (0, H, W)


@pytest.fixture(scope="module")
def checked_segments():
    """Two 2-frame segments with one table (the second repeats the first
    one's frames), so the JAX checked decode compiles once; and the same
    segments with a bit flipped in segment 1, found by the port's mask."""
    base = _frames(2, seed=17)
    frames = np.concatenate([base, base])
    segs = tfs.encode_frames_segmented(frames, max_segment_bits=TWO_FRAMES)
    assert [t for _, t in segs] == [2, 2]
    np.testing.assert_array_equal(segs[0][0].widths, segs[1][0].widths)
    s1 = segs[1][0]
    rng = np.random.default_rng(5)
    for _ in range(64):
        bit = int(rng.integers(0, 8 * (s1.code_bytes.size - 2)))
        code = s1.code_bytes.copy()
        code[bit // 8] ^= 128 >> (bit % 8)
        bad = [segs[0], (dataclasses.replace(s1, code_bytes=code), 2)]
        if next(tfs.iter_frames_segmented_checked(
                bad[1:], H, W, device="cpu"))[2].any():
            return frames, segs, bad
    raise AssertionError("64 flips, none flagged")


def test_checked_segmented_decode_matches_jax_interpret(checked_segments):
    frames, segs, bad = checked_segments
    jcfg = JaxConfig(backend="pallas", interpret=True)
    np.testing.assert_array_equal(
        tfs.decode_frames_segmented(segs, H, W, check=True, device="cpu"),
        frames)
    ours = list(tfs.iter_frames_segmented_checked(bad, H, W, device="cpu"))
    ref = list(jfs.iter_frames_segmented_checked(bad, H, W, jcfg))
    assert [si for si, _, _ in ours] == [si for si, _, _ in ref] == [0, 1]
    for (_, f, e), (_, rf, re) in zip(ours, ref):
        np.testing.assert_array_equal(f, rf)
        assert e.dtype == np.bool_
        np.testing.assert_array_equal(e, re)
    assert not ours[0][2].any() and ours[1][2].any()
    with pytest.raises(ValueError, match="in segment 1") as e_ours:
        tfs.decode_frames_segmented(bad, H, W, check=True, device="cpu")
    with pytest.raises(ValueError, match="in segment 1") as e_ref:
        jfs.decode_frames_segmented(bad, H, W, jcfg, check=True)
    assert str(e_ours.value) == str(e_ref.value)


def test_salvage_blocks_matches_jax(checked_segments):
    _frames_, _segs, bad = checked_segments
    (_, frames, err), = list(tfs.iter_frames_segmented_checked(
        bad[1:], H, W, device="cpu"))
    ref, n_ref = jfs.salvage_blocks(frames.copy(), err, 8)
    ro = frames.copy()
    ro.flags.writeable = False
    got, n = tfs.salvage_blocks(ro, err, 8)
    assert n == n_ref == int(err.sum()) > 0 and got is not ro
    np.testing.assert_array_equal(got, ref)
    clean = frames.copy()
    same, n = tfs.salvage_blocks(clean, np.zeros_like(err), 8)
    assert same is clean and n == 0


def test_port_decodes_mhv2_and_mhts_without_jax():
    code = """
import sys
sys.modules['jax'] = None
sys.modules['metalhuffman_tpu'] = None
import zlib
import numpy as np
import metalhuffman_tpu_torch
from metalhuffman_tpu_torch.models import frame_stream as fs
from metalhuffman_tpu_torch.models.config import CodecConfig
frames = np.random.default_rng(0).integers(0, 256, (5, 16, 24), dtype=np.uint8)
segs = fs.encode_frames_segmented(frames, max_segment_bits=2 * 16 * 24 * 10)
blob = fs.write_segmented(segs, 16, 24, source_crc32=zlib.crc32(frames.tobytes()),
                          frame_crcs=fs.compute_frame_crcs(frames))
assert (metalhuffman_tpu_torch.decode_video(blob, "cpu") == frames).all()
assert (fs.decode_range(blob, 1, 4, device="cpu")[0] == frames[1:4]).all()
mhts = fs.write_stream(fs.encode_frames(frames), 16, 24)
prep = fs.prepare_batch(fs.read_stream(mhts)[0], 16, 24, device="cpu")
assert (fs.decode_batch(prep).numpy() == frames).all()
assert metalhuffman_tpu_torch.encode_video(frames, CodecConfig(frame_crcs=True))[:4] == b"MHTV"
assert not any(m == "jax" or m.startswith(("jax.", "metalhuffman_tpu."))
               or m == "metalhuffman_tpu" for m in sys.modules
               if sys.modules[m] is not None)
print("ok")
"""
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
