"""The MHVT fold kernel's host side (``ops/fold_cuda.py``), without a card.

A CUDA kernel cannot run here, so the CUDA route runs up to the C call on
CPU tensors (``fold_cuda.is_card`` monkeypatched), and the C call is
replaced by :func:`fold_cuda.emulate`, the kernel's walk in NumPy, on the
memory and the table the wrapper hands it: the group tables, the cumulative
row shifts, the column shifts, the pointers and the access width it builds
are held to the host folds (``temporal_decode``, ``temporal_decode_mc``)
and the JAX package's (``temporal_decode_jax``, ``temporal_decode_mc_jax``).
Every comparison is exact. The kernel itself is held to the plain fold on
the card by ``chip_smoke.py`` phase G.
"""

import ctypes

import numpy as np
import pytest
import torch

import metalhuffman_tpu_torch as mt
from metalhuffman_tpu.models import temporal as jt
from metalhuffman_tpu_torch import _build
from metalhuffman_tpu_torch.models import temporal as tt
from metalhuffman_tpu_torch.models.config import CodecConfig
from metalhuffman_tpu_torch.ops import fold_cuda

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

H, W = 9, 20
G = fold_cuda.TABLE_GROUPS


def _table_at(address: int) -> np.ndarray:
    return np.ctypeslib.as_array(
        (ctypes.c_int32 * fold_cuda.TABLE_INTS).from_address(address)).copy()


@pytest.fixture
def as_card(monkeypatch):
    """CPU tensors routed as CUDA ones; each launch is run by the NumPy
    emulation on the memory the wrapper passed, after the C entry's own
    checks, and recorded as (width, rows, table, shared)."""
    calls = []

    def launch(name, device, ptr, h, row_bytes, elem_bytes, vec, rows,
               shared, table_ptr):
        assert name == "temporal_fold" and device.type == "cpu"
        table = _table_at(table_ptr)
        n = int(table[0])
        assert 1 <= n <= G and rows >= 1 and elem_bytes in (1, 2)
        assert vec >= elem_bytes and row_bytes % vec == 0 and ptr % vec == 0
        assert shared in (0, 1)
        assert not shared or (2 * rows * (-(-row_bytes // 16) * 16)
                              <= fold_cuda.SMEM_MAX)
        frames = int((table[1 : 1 + n] + table[1 + G : 1 + G + n]).max())
        assert frames <= fold_cuda.TABLE_FRAMES
        stack = np.ctypeslib.as_array(
            (ctypes.c_uint8 * (frames * h * row_bytes)).from_address(ptr))
        fold_cuda.emulate(stack.reshape(frames, h, row_bytes), table, vec,
                          elem_bytes)
        calls.append((vec, rows, table, shared))

    monkeypatch.setattr(fold_cuda, "is_card", lambda x: True)
    monkeypatch.setattr(_build, "launch", launch)
    return calls


@pytest.fixture
def no_plain(monkeypatch):
    """The plain folds raise: a CUDA-routed fold must not reach them."""
    def refuse(*a, **k):
        raise AssertionError("the plain fold ran on the CUDA route")

    monkeypatch.setattr(tt, "fold_plain", refuse)
    monkeypatch.setattr(tt, "roll_groups", refuse)


def _res(kind, t, seed):
    rng = np.random.default_rng(seed)
    shape = (t, H, W, 3) if kind == "color" else (t, H, W)
    top = 1 << 16 if kind == "u16" else 256
    return rng.integers(0, top, shape).astype(
        np.uint16 if kind == "u16" else np.uint8)


def _vectors(kind, t, seed):
    """Zero vectors, small ones of both signs, or ones past the frame's
    size of both signs."""
    rng = np.random.default_rng(seed)
    if kind == "zero":
        return np.zeros((t, 2), np.int16)
    span = (4, 4) if kind == "negative" else (5 * H, 5 * W)
    mvs = np.stack([rng.integers(-span[0], span[0] + 1, t),
                    rng.integers(-span[1], span[1] + 1, t)], 1)
    if kind == "negative":
        mvs[1:] = -np.abs(mvs[1:]) - 1
    else:
        mvs[1] = (H + 2, -W - 3)
    return mvs.astype(np.int16)


def _launches(t, keyint, fl):
    """Tables (launches) of one fold: none without a group of 2 frames."""
    return int(any(n >= 2 for _, _, n in tt._groups(t, keyint, fl)))


# keyint 1 (nothing to fold); a short last group; fewer frames than keyint;
# a short first and a short last group; a first group of one frame
GROUPINGS = [(1, None, 6), (3, None, 10), (8, None, 5), (8, 3, 20),
             (3, 1, 8)]


@pytest.mark.parametrize("vectors", ["zero", "negative", "oversized"])
@pytest.mark.parametrize("kind", ["u8", "color", "u16"])
@pytest.mark.parametrize("keyint,fl,t", GROUPINGS)
def test_cuda_route_matches_the_host_and_jax_folds(as_card, no_plain, kind,
                                                    vectors, keyint, fl, t):
    res = _res(kind, t, seed=keyint * 100 + t)
    mvs = _vectors(vectors, t, seed=t)
    want = tt.temporal_decode_mc(res, keyint, mvs, fl)
    np.testing.assert_array_equal(
        np.asarray(jt.temporal_decode_mc_jax(res, keyint, mvs, fl)), want)
    x = torch.from_numpy(res.copy())
    assert tt.temporal_fold_mc(x, keyint, mvs, fl) is x  # in place
    np.testing.assert_array_equal(x.numpy(), want)
    assert len(as_card) == _launches(t, keyint, fl)
    if vectors == "zero":
        want = tt.temporal_decode(res, keyint, fl)
        np.testing.assert_array_equal(
            np.asarray(jt.temporal_decode_jax(res, keyint, fl)), want)
        x = torch.from_numpy(res.copy())
        assert tt.temporal_fold(x, keyint, fl) is x
        np.testing.assert_array_equal(x.numpy(), want)
        assert len(as_card) == 2 * _launches(t, keyint, fl)


def test_the_table_of_a_call(as_card):
    # 20 frames, a first group of 3, keyint 8: groups [0, 3), [3, 11),
    # [11, 19) and the lone keyframe 19, in one table
    mvs = np.zeros((20, 2), np.int16)
    mvs[1:] = (-2, 7)
    mvs[4] = (H + 1, -W - 1)
    x = torch.from_numpy(_res("color", 20, seed=3))
    tt.temporal_fold_mc(x, 8, mvs, 3)
    ((vec, rows, table, shared),) = as_card
    assert table[0] == 3
    assert table[1:4].tolist() == [0, 3, 11]
    assert table[1 + G : 4 + G].tolist() == [3, 8, 8]
    cy = table[1 + 2 * G :]
    sx = table[1 + 2 * G + fold_cuda.TABLE_FRAMES :]
    assert cy[1:3].tolist() == [H - 2, H - 4]  # cumulative, mod H
    assert cy[4:6].tolist() == [1, H - 1]  # from keyframe 3: H+1, then -2
    assert sx[1] == sx[5] == 7 * 3  # its own vector's column, in bytes
    assert sx[4] == (W - 1) * 3  # -W-1 mod W
    assert (vec, rows, shared) == (4, H, 1)  # a 60-byte row: 4-byte accesses


@pytest.mark.parametrize("kind", ["u8", "u16"])
@pytest.mark.parametrize("keyint,fl,t,tables", [
    (300, None, 300, 2),  # one group of 300 frames: pieces of 256 and 45
    (2, None, 260, 2),  # 130 groups of 2 frames: 128 in the first table
    (300, 5, 320, 3),  # 5 frames; 300 in two pieces, the second with 15
    (8, 3, 300, 2),  # groups of 3 and 8: whole groups up to frame 251
    (4, 2, 23, 1),  # everything in one table
])
def test_spans_split_across_tables(as_card, no_plain, kind, keyint, fl, t,
                                   tables):
    res = _res(kind, t, seed=t)
    mvs = _vectors("oversized", t, seed=t)
    x = torch.from_numpy(res.copy())
    assert tt.temporal_fold_mc(x, keyint, mvs, fl) is x
    np.testing.assert_array_equal(
        x.numpy(), tt.temporal_decode_mc(res, keyint, mvs, fl))
    assert len(as_card) == tables


@pytest.mark.parametrize("offset,vec", [(0, 16), (1, 1), (2, 2), (4, 4),
                                        (8, 8), (16, 16)])
def test_the_access_width_follows_the_alignment(as_card, offset, vec):
    # a (T, 7, 16) stack ``offset`` bytes into a 16-byte aligned storage
    t = 7
    res = np.random.default_rng(offset).integers(0, 256, (t, 7, 16)).astype(
        np.uint8)
    store = torch.zeros(res.size + 16, dtype=torch.uint8)
    assert store.data_ptr() % 16 == 0
    x = store[offset : offset + res.size].view(res.shape)
    x.copy_(torch.from_numpy(res))
    mvs = np.random.default_rng(1).integers(-20, 20, (t, 2)).astype(np.int16)
    tt.temporal_fold_mc(x, 3, mvs)
    np.testing.assert_array_equal(x.numpy(),
                                  tt.temporal_decode_mc(res, 3, mvs))
    assert [c[0] for c in as_card] == [vec]
    assert [c[3] for c in as_card] == [1]


@pytest.mark.parametrize("h,row_bytes,ptr,want", [
    (1536, 2048, 0, (16, 8, True)),  # the benchmark's frames: 1,024 chunks
    (1080, 5760, 0, (16, 2, True)),  # 1920x3 colour rows
    (768, 1366, 0, (2, 1, True)),  # a width no multiple of 4
    (1536, 4096, 8, (8, 2, True)),  # u16 rows at an 8-byte address
    (3, 2048, 0, (16, 3, True)),  # fewer rows than a block takes
    (4, 16400, 0, (16, 1, True)),  # more chunks than a block loads at once
    (2, 116224, 0, (16, 1, True)),  # the widest rows two buffers hold
    (2, 116240, 0, (16, 1, False)),  # wider: out[s-1] from device memory
    (3, 174339, 0, (1, 1, False)),  # 58,113 px x 3, odd
])
def test_fold_geometry(h, row_bytes, ptr, want):
    vec, rows, shared = fold_cuda.fold_geometry(h, row_bytes, ptr)
    assert (vec, rows, shared) == want
    assert not shared or (2 * rows * (-(-row_bytes // 16) * 16)
                          <= fold_cuda.SMEM_MAX)


@pytest.mark.parametrize("w,dtype,vec", [(116240, np.uint8, 16),
                                         (58113, np.uint16, 2)])
def test_rows_wider_than_two_buffers_are_refused(as_card, no_plain, w, dtype,
                                                 vec):
    # rows past the shared memory of two buffers fold all the same, with the
    # previous frame read back from device memory
    t, h = 6, 2
    rng = np.random.default_rng(w)
    res = rng.integers(0, np.iinfo(dtype).max + 1, (t, h, w)).astype(dtype)
    mvs = np.stack([rng.integers(-3, 4, t), rng.integers(-30000, 30001, t)],
                   1).astype(np.int16)
    x = torch.from_numpy(res.copy())
    tt.temporal_fold_mc(x, 4, mvs)
    np.testing.assert_array_equal(x.numpy(),
                                  tt.temporal_decode_mc(res, 4, mvs))
    assert [(c[0], c[1], c[3]) for c in as_card] == [(vec, 1, 0)]


def _noncontiguous():
    return torch.from_numpy(_res("u8", 6, 1)).transpose(1, 2)


@pytest.mark.parametrize("call,match", [
    (lambda: tt.temporal_fold(_noncontiguous(), 2), "contiguous"),
    (lambda: tt.temporal_fold_mc(_noncontiguous(), 2, np.zeros((6, 2))),
     "contiguous"),
    (lambda: tt.temporal_fold(torch.zeros((6, H, W), dtype=torch.int32), 2),
     "uint8/uint16"),
    (lambda: tt.temporal_fold_mc(torch.zeros((6, H, W), dtype=torch.int16),
                                 2, np.zeros((6, 2))), "uint8/uint16"),
    (lambda: tt.temporal_fold_mc(torch.zeros((6, H, W), dtype=torch.uint8),
                                 2, np.zeros((5, 2))), "motion table length"),
    (lambda: tt.temporal_fold_mc(torch.zeros((6, H, W), dtype=torch.uint8),
                                 2, np.zeros((6, 1))), "motion table length"),
    (lambda: tt.temporal_fold(torch.zeros((6, H, W), dtype=torch.uint8), 0),
     "keyint"),
    (lambda: tt.temporal_fold_mc(torch.zeros((6, H, W), dtype=torch.uint8),
                                 0, np.zeros((6, 2))), "keyint"),
])
def test_the_cuda_route_refuses_as_the_folds_do(as_card, call, match):
    with pytest.raises(ValueError, match=match):
        call()
    assert as_card == []


def test_the_wrapper_takes_cuda_tensors_alone():
    x = torch.zeros((4, H, W), dtype=torch.uint8)
    with pytest.raises(ValueError, match="needs a CUDA tensor"):
        fold_cuda.fold(x, tt._groups(4, 2, None))
    with pytest.raises(ValueError, match="no fold for tensors on meta"):
        tt.temporal_fold(torch.empty((4, H, W), dtype=torch.uint8,
                                     device="meta"), 2)


def _pan(t, h=16, w=24, seed=0):
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return np.stack([np.roll(base, (i, -2 * i), (0, 1)) for i in range(t)])


@pytest.mark.parametrize("kind", ["gray", "motion", "color", "u16"])
def test_every_temporal_decode_surface_takes_the_kernel(as_card, no_plain,
                                                        kind):
    frames = _pan(11)
    cfg = CodecConfig(temporal=True, keyint=4, motion=kind != "gray",
                      frame_crcs=True)
    if kind == "color":
        frames = np.stack([frames, frames // 2, 255 - frames], -1)
        blob = tt.encode_temporal_color_video(frames, cfg)
    elif kind == "u16":
        frames = frames.astype(np.uint16) * 257
        blob = tt.encode_temporal_gray16_video(frames, cfg)
    else:
        blob = mt.encode_video(frames, cfg)
    np.testing.assert_array_equal(tt.decode_temporal_video(blob, "cpu"),
                                  frames)
    np.testing.assert_array_equal(
        tt.decode_temporal_range(blob, 5, 10, "cpu"), frames[5:10])
    chunks = list(tt.iter_temporal_video(blob, "cpu", chunk_frames=3))
    np.testing.assert_array_equal(np.concatenate([c for _, c in chunks]),
                                  frames)
    # three whole-video folds; a range and each chunk fold from a keyframe
    launches = 1 + 1 + len(chunks)
    if kind != "gray":  # an MC region decodes a range
        np.testing.assert_array_equal(
            tt.decode_temporal_video_region(blob, 2, 7, 3, 5, 8, 9, True,
                                            device="cpu"),
            frames[2:7, 3:11, 5:14])
        launches += 1
    assert len(as_card) == launches


def test_constants_match_the_kernel_source():
    src = _build.KERNELS["temporal_fold"].read_text()
    for name, value in (("kThreads", fold_cuda.THREADS),
                        ("kChunksPerThread", fold_cuda.CHUNKS_PER_THREAD),
                        ("kTableFrames", fold_cuda.TABLE_FRAMES),
                        ("kTableGroups", fold_cuda.TABLE_GROUPS),
                        ("kSmemMax", fold_cuda.SMEM_MAX)):
        assert f"constexpr int {name} = {value};" in src
    assert len(_build._ARGTYPES["temporal_fold"]) == 9
    assert "decode_images_kernel" not in src  # fold_roofline counts it apart
