"""The per-frame CRC-32 kernel's host side (``ops/crc_cuda.py``) and the
range request's route through it, without a card.

A CUDA kernel cannot run here, so the CUDA route runs up to the C call on
CPU tensors (``crc_cuda.is_card`` monkeypatched), and the C call is
replaced by :func:`crc_cuda.emulate`, the kernel's chunks, runs, slicing
tables and combine tree in NumPy, on the memory and the parameters the
wrapper hands it, after the C entry's own checks. Every comparison is
exact: with ``zlib.crc32``, with ``core/crc.py``'s ``crc32_combine`` and with
the host route of ``decode_range_parsed``. The kernel itself is held to
zlib on the card by ``chip_smoke.py`` phase O.
"""

import ctypes
import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.core import crc as crc_core
from metalhuffman_tpu_torch.models import frame_stream as tfs
from metalhuffman_tpu_torch.ops import crc_cuda

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

H, W = 24, 40
SIZES = [1, 15, 16, 17, 4095, 40 * 72, 48 * 64, 1536 * 2048]


def _emulated_launch(name, device, ptr, n, t, vec, params_ptr, out_ptr):
    """The C entry's checks, then the NumPy emulation on the memory the
    wrapper passed, writing the output it passed."""
    assert name == "frame_crc" and device.type == "cpu"
    assert n >= 1 and t >= 1 and vec in (16, 8, 4, 2, 1)
    assert n % vec == 0 and ptr % vec == 0
    chunks = -(-n // crc_cuda.CHUNK_BYTES)
    assert chunks <= crc_cuda.MAX_CHUNKS and t * chunks < 2**31
    size = crc_cuda.MATRICES * 32 + 1
    params = np.ctypeslib.as_array(
        (ctypes.c_uint32 * size).from_address(params_ptr)).copy()
    stack = np.ctypeslib.as_array((ctypes.c_uint8 * (t * n)).from_address(ptr))
    out = np.ctypeslib.as_array((ctypes.c_uint32 * t).from_address(out_ptr))
    out[:] = crc_cuda.emulate(stack, n, t, params)


@pytest.fixture
def as_card(monkeypatch):
    """CPU tensors routed as CUDA ones; each launch is run by
    :func:`_emulated_launch` and recorded as (frames, frame bytes, access
    width)."""
    calls = []

    def launch(name, device, ptr, n, t, vec, *rest):
        _emulated_launch(name, device, ptr, n, t, vec, *rest)
        calls.append((t, n, vec))

    monkeypatch.setattr(crc_cuda, "is_card", lambda x: True)
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.fixture
def no_kernel(monkeypatch):
    """The kernel's C call raises: a route that must not reach it."""
    def refuse(*a, **k):
        raise AssertionError("the frame CRC kernel was launched")

    monkeypatch.setattr(_build, "launch", refuse)


def _stack(t, n, seed, offset=0):
    """A (t, n) uint8 tensor of random bytes whose first frame starts
    ``offset`` bytes into its storage."""
    rng = np.random.default_rng(seed)
    buf = torch.from_numpy(rng.integers(0, 256, offset + t * n, np.uint8))
    return buf[offset:].view(t, n)


def _zlib(frames) -> list:
    return [zlib.crc32(f.numpy().tobytes()) for f in frames]


@pytest.mark.parametrize("t", [1, 3, 8])
@pytest.mark.parametrize("n", SIZES)
def test_emulation_equals_zlib(n, t):
    x = _stack(t, n, seed=n + t)
    got = crc_cuda.emulate(x.numpy().ravel(), n, t, crc_cuda.kernel_params(n))
    assert got.dtype == np.uint32
    assert got.tolist() == _zlib(x)


@pytest.mark.parametrize("offset", [1, 2, 4, 8, 12])
@pytest.mark.parametrize("n", [17, 40 * 72, 4095, 48 * 64])
def test_misaligned_stacks_through_the_wrapper(as_card, n, offset):
    x = _stack(3, n, seed=offset, offset=offset)
    got = crc_cuda.frame_crcs(x)
    assert got.dtype == torch.uint32 and got.shape == (3,)
    assert got.numpy().tolist() == _zlib(x)
    assert as_card == [(3, n, crc_cuda.access_width(n, x.data_ptr()))]


def test_access_width_by_alignment():
    assert crc_cuda.access_width(48 * 64, 256) == 16
    assert crc_cuda.access_width(48 * 64, 264) == 8
    assert crc_cuda.access_width(40 * 72, 260) == 4
    assert crc_cuda.access_width(4095, 256) == 1
    assert crc_cuda.access_width(4094, 256) == 2
    assert crc_cuda.access_width(16, 3) == 1


def test_matrices_equal_crc32_combine():
    rng = np.random.default_rng(3)
    v = rng.integers(0, 2**32, 4, dtype=np.uint64).astype(np.uint32)
    params = crc_cuda.kernel_params(1536 * 2048)
    mats = params[:-1].reshape(crc_cuda.MATRICES, 32)
    for k in range(crc_cuda.MATRICES):
        want = [crc_core.crc32_combine(int(c), 0, crc_cuda.RUN_BYTES << k)
                for c in v]
        assert crc_cuda.gf2_apply(mats[k], v).tolist() == want
    assert crc_core.zeros_matrices(1, 1)[0] == [
        crc_core.crc32_combine(1 << i, 0, 1) for i in range(32)]
    for n in (1, 17, 4095, 1536 * 2048):
        assert int(crc_cuda.kernel_params(n)[-1]) == zlib.crc32(bytes(n))
    with pytest.raises(ValueError, match="power of two"):
        crc_core.zeros_matrices(3, 1)


def test_slicing_tables_are_zlibs():
    tab = crc_cuda.slicing_tables()
    for k in (0, 1, 7, 15):
        for byte in (0, 1, 0x80, 0xFF):
            # raw CRC from state 0 of the byte and k zero bytes
            data = bytes([byte]) + bytes(k)
            raw = zlib.crc32(data) ^ zlib.crc32(bytes(k + 1))
            assert int(tab[k][byte]) == raw


def test_wrapper_refuses_what_the_kernel_does_not_take(as_card):
    x = _stack(2, 64, seed=0)
    with pytest.raises(ValueError, match="uint8"):
        crc_cuda.frame_crcs(x.to(torch.int16))
    with pytest.raises(ValueError, match="contiguous"):
        crc_cuda.frame_crcs(x.view(2, 8, 8)[:, :, :4])
    with pytest.raises(ValueError, match="contiguous"):
        crc_cuda.frame_crcs(x[0])
    with pytest.raises(ValueError, match="at least one byte"):
        crc_cuda.frame_crcs(torch.zeros(2, 0, dtype=torch.uint8))
    assert crc_cuda.frame_crcs(x[:0]).shape == (0,)
    # sizes past what the kernel takes, on the meta device: no memory
    big = crc_cuda.MAX_CHUNKS * crc_cuda.CHUNK_BYTES
    with pytest.raises(ValueError, match="bytes exceed the frame CRC's 3"):
        crc_cuda.frame_crcs(torch.empty(1, big + 1, dtype=torch.uint8,
                                        device="meta"))
    with pytest.raises(ValueError, match="grid of 2"):
        crc_cuda.frame_crcs(torch.empty(2**31 // crc_cuda.MAX_CHUNKS, big,
                                        dtype=torch.uint8, device="meta"))
    assert as_card == []


def test_wrapper_refuses_a_cpu_tensor(no_kernel):
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        crc_cuda.frame_crcs(_stack(1, 16, seed=0))


# -- the range request's CUDA route ------------------------------------------


def _frames(t, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (H, W), np.uint8)
    smooth = np.clip(100 + 60 * np.sin(np.arange(W) / 7.0)[None, :]
                     + rng.normal(0, 3, (H, W)), 0, 255).astype(np.uint8)
    img = np.where(np.arange(W)[None, :] < W // 2, base, smooth)
    return np.stack([np.roll(img, (3 * i, 5 * i), (0, 1)) for i in range(t)])


@pytest.fixture(scope="module")
def clip():
    """Five frames as MHTV and MHV2 with a per-frame CRC table (MHV2 two
    frames a segment) and as MHTS with each record's CRC."""
    frames = _frames(5, seed=1)
    t = len(frames)
    crc = zlib.crc32(frames.tobytes())
    fcrcs = tfs.compute_frame_crcs(frames)
    segs = tfs.encode_frames_segmented(frames,
                                       max_segment_bits=2 * H * W * 10)
    assert [n for _, n in segs] == [2, 2, 1]
    return frames, {
        "MHTV": tfs.write_shared(tfs.encode_frames_shared(frames), t, H, W,
                                 source_crc32=crc, frame_crcs=fcrcs),
        "MHV2": tfs.write_segmented(segs, H, W, source_crc32=crc,
                                    frame_crcs=fcrcs),
        "MHTS": tfs.write_stream(tfs.encode_frames(frames), H, W,
                                 source_crc32s=[zlib.crc32(f.tobytes())
                                                for f in frames]),
    }


def _range(blob, a, b, **kw):
    return tfs.decode_range_parsed(tfs.parse_range_container(blob), a, b,
                                   device="cpu", **kw)[0]


# MHV2 ranges (1, 3) and (1, 5) straddle segments [0, 2), [2, 4), [4, 5)
@pytest.mark.parametrize("a,b", [(0, 5), (1, 3), (1, 5), (4, 5)])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_cuda_route_returns_the_host_routes_frames(clip, as_card, container,
                                                   a, b):
    frames, blobs = clip
    got = _range(blobs[container], a, b)
    assert isinstance(got, np.ndarray) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, frames[a:b])
    # one launch over the request's frames; MHTS one a frame
    want = [(1, H * W)] * (b - a) if container == "MHTS" else [(b - a, H * W)]
    assert [(t, n) for t, n, _ in as_card] == want


def _flip_decoded(monkeypatch, call, frame):
    """Decode ``call`` (counted from 0) returns its frames with one byte of
    ``frame`` (counted in that call's output) flipped."""
    decode = tfs.decode_shared_step
    calls = []

    def flipped(prep, config=None, raw=False):
        out = decode(prep, config, raw)
        if len(calls) == call:
            out = out.clone()
            out[frame, 5, 7] ^= 0x10
        calls.append(out.shape[0])
        return out

    monkeypatch.setattr(tfs, "decode_shared_step", flipped)


def _break_table(blob, container, frame):
    blob = bytearray(blob)
    if container == "MHTS":
        pos = 8  # frame's MHT1 record: its CRC at header bytes 18..22
        for _ in range(frame):
            pos += 4 + int.from_bytes(blob[pos : pos + 4], "little")
        blob[pos + 4 + 18] ^= 0xFF
    else:
        blob[tfs._trailer_offset(bytes(blob)) + 4 + 8 + 4 * frame] ^= 0xFF
    return bytes(blob)


@pytest.mark.parametrize("route", ["host", "card"])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_a_flipped_byte_raises_on_both_routes(clip, request, monkeypatch,
                                              container, route):
    _frames_, blobs = clip
    if route == "card":
        request.getfixturevalue("as_card")
    # frame 3 of the range 2..5: the second frame of MHTV's one decode and
    # of MHV2's segment [2, 4), MHTS's second one-frame decode
    _flip_decoded(monkeypatch, *((1, 0) if container == "MHTS" else (0, 1)))
    with pytest.raises(ValueError, match="decoded frame 3 fails its recorded "
                                         "CRC-32 — the stream is corrupt"):
        _range(blobs[container], 2, 5)


@pytest.mark.parametrize("route", ["host", "card"])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_a_wrong_table_entry_raises_on_both_routes(clip, request, container,
                                                   route):
    frames, blobs = clip
    if route == "card":
        request.getfixturevalue("as_card")
    blob = _break_table(blobs[container], container, 3)
    with pytest.raises(ValueError,
                       match="decoded frame 3 fails its recorded CRC-32 — "
                             "the stream is corrupt"):
        _range(blob, 2, 5)
    # frames the request does not return are not checked
    np.testing.assert_array_equal(_range(blob, 0, 3), frames[:3])
    # the device form skips the check
    dev = _range(blob, 2, 5, to_host=False)
    np.testing.assert_array_equal(dev.numpy(), frames[2:5])


@pytest.mark.parametrize("route", ["host", "card"])
@pytest.mark.parametrize("container", ["MHTV", "MHV2"])
def test_a_short_table_raises_corrupt_container(clip, request, container,
                                                route):
    _frames_, blobs = clip
    if route == "card":
        request.getfixturevalue("as_card")
    kind, payload, fcrcs = tfs.parse_range_container(blobs[container])
    with pytest.raises(ValueError, match="corrupt container"):
        tfs.decode_range_parsed((kind, payload, fcrcs[:4]), 2, 5,
                                device="cpu")


def test_mhts_records_without_a_crc_launch_nothing(clip, as_card):
    frames, _blobs = clip
    blob = tfs.write_stream(tfs.encode_frames(frames), H, W)
    np.testing.assert_array_equal(_range(blob, 1, 4), frames[1:4])
    assert as_card == []


def test_containers_without_a_table_launch_nothing(clip, as_card):
    frames, _blobs = clip
    blob = tfs.write_shared(tfs.encode_frames_shared(frames), 5, H, W)
    np.testing.assert_array_equal(_range(blob, 1, 4), frames[1:4])
    assert as_card == []


@pytest.mark.parametrize("device", ["cpu", "native"])
@pytest.mark.parametrize("container", ["MHTV", "MHV2", "MHTS"])
def test_cpu_and_native_routes_never_launch(clip, no_kernel, container,
                                            device):
    frames, blobs = clip
    before = dict(crc_cuda.launches)
    got, *_ = tfs.decode_range(blobs[container], 1, 5, device=device)
    np.testing.assert_array_equal(got, frames[1:5])
    assert crc_cuda.launches == before
