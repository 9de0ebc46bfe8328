"""Random access into MHVT through the port's one random access,
``frame_stream.parse_range_container`` and ``decode_range_parsed``.

Gray, color (an MHTC inner) and gray16 MHVT at keyframe intervals 1, 4 and
30, with and without motion compensation, written by the port's encoder
(byte-equal to the JAX package's, ``test_torch_temporal.py``), decode on
``cpu`` and ``native`` at a group's start, at its end, across a boundary
and at the last frame, equal to the source frames and to the JAX package's
``decode_temporal_range`` on its host backend. The card's route (the fold
kernel and the per-frame CRC kernel, ``fold_cuda`` and ``crc_cuda``) runs
up to the C calls on CPU tensors, each C call replaced by its kernel's
NumPy emulation, with zlib made to raise. Then the refusals, the
``seek_frames`` counter and the marks one request records under
``torch.profiler``. Every comparison is exact.
"""

import ctypes
import dataclasses

import numpy as np
import pytest
import torch

import metalhuffman_tpu_torch as mt
from metalhuffman_tpu.models import CodecConfig as JaxConfig
from metalhuffman_tpu.models import temporal as jt
from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.models import color as tcolor
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.models import temporal as tt
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import crc_cuda, fold_cuda

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

NATIVE = JaxConfig(backend="native")
T, H, W = 34, 20, 28  # two groups at keyint 30; no multiple of 8 across
KEYINTS = (1, 4, 30)
KINDS = ("gray", "color", "u16")


def _pan(seed=3, step=(1, -2)):
    """A textured frame panned ``step`` pixels a frame, with a little noise
    (a pan the motion estimator finds)."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(H), np.arange(W), indexing="ij")
    base = np.clip(120 + 50 * np.sin(xx / 5.0) * np.cos(yy / 4.0)
                   + rng.normal(0, 12, (H, W)), 0, 255).astype(np.uint8)
    frames = np.stack([np.roll(base, (step[0] * i, step[1] * i), (0, 1))
                       for i in range(T)])
    return frames + rng.integers(0, 3, frames.shape).astype(np.uint8)


def _encode(kind, keyint, motion):
    """(MHVT blob with the true frames' CRC table, the true frames)."""
    frames = _pan()
    cfg = CodecConfig(temporal=True, keyint=keyint, motion=motion,
                      frame_crcs=True)
    if kind == "color":
        frames = np.stack([np.roll(frames, k, axis=2) // (k + 1)
                           for k in range(3)], axis=-1)
        return tt.encode_temporal_color_video(
            frames, cfg, colorspace=tcolor.CS_SUBGREEN), frames
    if kind == "u16":
        frames = (frames.astype(np.uint16) * 16
                  + (np.arange(W, dtype=np.uint16) * 97)[None, None])
        return tt.encode_temporal_gray16_video(frames, cfg), frames
    return mt.encode_video(frames, cfg), frames


@pytest.fixture(scope="module")
def blobs():
    return {(kind, k, mc): _encode(kind, k, mc) for kind in KINDS
            for k in KEYINTS for mc in (False, True)}


def _ranges(k):
    """[a, b): a group's start, a group's end, across a boundary, the last
    frame, the whole clip."""
    return [(k, k + 2), (k - 1, k), (k - 1, k + 2), (T - 1, T), (0, T)]


@pytest.mark.parametrize("device", ["cpu", "native"])
@pytest.mark.parametrize("motion", [False, True], ids=["group", "mc"])
@pytest.mark.parametrize("keyint", KEYINTS)
@pytest.mark.parametrize("kind", KINDS)
def test_ranges_match_the_source_and_jax(blobs, kind, keyint, motion,
                                         device):
    blob, frames = blobs[kind, keyint, motion]
    parsed = tfs.parse_range_container(blob)
    assert parsed[0] == "temporal"
    for a, b in _ranges(keyint):
        got, h, w = tfs.decode_range_parsed(parsed, a, b, device=device)
        assert (h, w) == (H, W) and got.dtype == frames.dtype
        np.testing.assert_array_equal(got, frames[a:b])
        np.testing.assert_array_equal(
            got, jt.decode_temporal_range(blob, a, b, NATIVE))
        np.testing.assert_array_equal(
            tfs.decode_range(blob, a, b, device=device)[0], got)
        np.testing.assert_array_equal(
            tt.decode_temporal_range(blob, a, b, device), got)
        dev, _h, _w = tfs.decode_range_parsed(parsed, a, b, to_host=False,
                                              device=device)
        assert isinstance(dev, torch.Tensor) and dev.device.type == "cpu"
        np.testing.assert_array_equal(dev.numpy(), frames[a:b])


# -- the card's route, emulated -------------------------------------------------


def _emulate_crc(device, ptr, n, t, vec, params_ptr, out_ptr):
    assert device.type == "cpu" and n % vec == 0 and ptr % vec == 0
    size = crc_cuda.MATRICES * 32 + 1
    params = np.ctypeslib.as_array(
        (ctypes.c_uint32 * size).from_address(params_ptr)).copy()
    stack = np.ctypeslib.as_array((ctypes.c_uint8 * (t * n)).from_address(ptr))
    out = np.ctypeslib.as_array((ctypes.c_uint32 * t).from_address(out_ptr))
    out[:] = crc_cuda.emulate(stack, n, t, params)


def _emulate_fold(device, ptr, h, row_bytes, elem_bytes, vec, rows, shared,
                  table_ptr):
    assert device.type == "cpu" and ptr % vec == 0
    table = np.ctypeslib.as_array(
        (ctypes.c_int32 * fold_cuda.TABLE_INTS).from_address(table_ptr)).copy()
    g, n = fold_cuda.TABLE_GROUPS, int(table[0])
    frames = int((table[1 : 1 + n] + table[1 + g : 1 + g + n]).max())
    stack = np.ctypeslib.as_array(
        (ctypes.c_uint8 * (frames * h * row_bytes)).from_address(ptr))
    fold_cuda.emulate(stack.reshape(frames, h, row_bytes), table, vec,
                      elem_bytes)


@pytest.fixture
def as_card(monkeypatch):
    """CPU tensors folded and hashed as CUDA ones: each C call runs its
    kernel's emulation and is recorded by name; zlib raises."""
    calls = []

    def launch(name, device, *args):
        {"frame_crc": _emulate_crc, "temporal_fold": _emulate_fold}[name](
            device, *args)
        calls.append(name)

    class NoZlib:
        @staticmethod
        def crc32(*a):
            raise AssertionError("zlib hashed frames on the card's route")

    monkeypatch.setattr(crc_cuda, "is_card", lambda x: True)
    monkeypatch.setattr(fold_cuda, "is_card", lambda x: True)
    monkeypatch.setattr(_build, "launch", launch)
    monkeypatch.setattr(tfs, "zlib", NoZlib)
    return calls


def _fold_launches(keyint, a, b):
    """F1's launches for [a, b): one table, none without a group of two
    frames in the span from the keyframe."""
    kf = keyint * (a // keyint)
    return int(any(n >= 2 for _, _, n in tt._groups(b - kf, keyint, None)))


@pytest.mark.parametrize("motion", [False, True], ids=["group", "mc"])
@pytest.mark.parametrize("keyint", KEYINTS)
@pytest.mark.parametrize("kind", KINDS)
def test_the_card_route_checks_with_c1_and_folds_with_f1(blobs, as_card,
                                                         kind, keyint,
                                                         motion):
    blob, frames = blobs[kind, keyint, motion]
    parsed = tfs.parse_range_container(blob)
    for a, b in _ranges(keyint):
        del as_card[:]
        got, *_ = tfs.decode_range_parsed(parsed, a, b, device="cpu")
        np.testing.assert_array_equal(got, frames[a:b])
        # one F1 table (none for a span of one frame), then C1 once
        want = ["temporal_fold"] * _fold_launches(keyint, a, b)
        assert as_card == want + ["frame_crc"]
        # unfetched: folded, not hashed
        del as_card[:]
        dev, *_ = tfs.decode_range_parsed(parsed, a, b, to_host=False,
                                          device="cpu")
        np.testing.assert_array_equal(dev.numpy(), frames[a:b])
        assert as_card == want


def _flip_lead(blob, frame):
    """A gray MHVT (over an MHTV) with one code byte of residual frame
    ``frame`` inverted."""
    inner, keyint, crc, mvs, fcrcs, fl = tt.unwrap(blob)
    stream, t, h, w, bd, delta = tfs.read_shared(inner)
    per = (-(-h // bd)) * (-(-w // bd))
    at = int(stream.block_offsets[frame * per + per // 2]) // 8
    code = stream.code_bytes.copy()
    code[at] ^= 0xFF
    inner = tfs.write_shared(
        dataclasses.replace(stream, code_bytes=code), t, h, w,
        CodecConfig(block_dim=bd, delta=delta),
        source_crc32=tfs.source_crc32(inner))
    return tt.wrap(inner, keyint, crc, mvs, fcrcs)


@pytest.mark.parametrize("route", ["cpu", "native", "card"])
def test_a_corrupt_lead_frame_raises(blobs, request, route):
    blob, frames = blobs["gray", 4, True]
    bad = tfs.parse_range_container(_flip_lead(blob, 4))
    if route == "card":
        request.getfixturevalue("as_card")
    device = "native" if route == "native" else "cpu"
    # frames 5 and 6 fold from the flipped keyframe 4, which is not returned
    with pytest.raises(ValueError, match="fails its recorded CRC-32"):
        tfs.decode_range_parsed(bad, 5, 7, device=device)
    # frames 0-3 lie before it
    np.testing.assert_array_equal(
        tfs.decode_range_parsed(bad, 1, 4, device=device)[0], frames[1:4])


@pytest.mark.parametrize("device", ["cpu", "native"])
def test_refusals(blobs, device):
    blob, _frames = blobs["gray", 4, True]
    parsed = tfs.parse_range_container(blob)
    for a, b in ((-1, 2), (3, 3), (5, 4), (0, T + 1), (T, T + 1)):
        with pytest.raises(ValueError, match="out of range"):
            tfs.decode_range_parsed(parsed, a, b, device=device)
        with pytest.raises(ValueError):
            jt.decode_temporal_range(blob, a, b, NATIVE)
    for cfg in (CodecConfig(), CodecConfig(temporal=True, keyint=4),
                CodecConfig(temporal=True, keyint=5, motion=True)):
        with pytest.raises(ValueError, match="disagrees with the MHVT"):
            tfs.decode_range_parsed(parsed, 1, 3, cfg, device=device)
    got, *_ = tfs.decode_range_parsed(
        parsed, 1, 3, CodecConfig(temporal=True, keyint=4, motion=True),
        device=device)
    np.testing.assert_array_equal(got, _frames[1:3])
    for cut in (len(blob) - 3, 30, 6):
        with pytest.raises(ValueError):
            tfs.parse_range_container(blob[:cut])


def test_seek_frames_counts_the_lead(blobs, monkeypatch):
    monkeypatch.setattr(tt, "seek_frames", {"asked": 0, "lead": 0})
    blob, _frames = blobs["color", 30, True]
    parsed = tfs.parse_range_container(blob)
    want = {"asked": 0, "lead": 0}
    for a, b in ((0, 1), (29, 31), (30, 33), (31, 34), (33, 34)):
        tfs.decode_range_parsed(parsed, a, b, device="cpu")
        want["asked"] += b - a
        want["lead"] += a - 30 * (a // 30)
        assert tt.seek_frames == want
    with pytest.raises(ValueError):
        tfs.decode_range_parsed(parsed, 5, T + 1, device="cpu")
    assert tt.seek_frames == want  # a refused request counts nothing
    tt.decode_temporal_range(blob, 2, 4, "native")
    assert tt.seek_frames == {"asked": want["asked"] + 2,
                              "lead": want["lead"] + 2}


@pytest.mark.parametrize("kind", KINDS)
def test_one_request_records_its_marks_in_order(blobs, kind):
    blob, frames = blobs[kind, 4, True]
    parsed = tfs.parse_range_container(blob)
    names = ("range.stage", "range.decode", "fold", "range.fetch",
             "range.crc")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        got, *_ = tfs.decode_range_parsed(parsed, 5, 7, device="cpu")
    np.testing.assert_array_equal(got, frames[5:7])
    spans = sorted((e.time_range.start, e.time_range.end, e.name)
                   for e in prof.events() if e.name in names)
    assert [n for _, _, n in spans] == list(names)
    for i, (s, _e, name) in enumerate(spans):
        assert all(sp[1] <= s for sp in spans[:i]), name
