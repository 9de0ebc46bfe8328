"""The generators: the same for one seed, different across seeds, and every
seed given the same sizes."""

import itertools

import numpy as np
import pytest

from benchmark import clips, loops

CONTENT = {"picture": "bridge_2048x1536", "pan_px": [4, 8]}
BIG = 2**31 + 12345


def test_picture_is_the_photo():
    img = clips.picture("bridge_2048x1536")
    assert img.shape == (1536, 2048) and img.dtype == np.uint8
    # the committed photo of the reference, as the port's tests load it
    from PIL import Image

    from benchmark.harness import REPO

    png = np.asarray(Image.open(REPO / "tests" / "assets" /
                                "bridge_2048x1536.png").convert("L"))
    assert np.array_equal(img, png)


@pytest.mark.parametrize("seed", [0, 7, BIG, 2**40 + 1])
def test_pan_of_the_configuration(seed):
    dy, dx = clips.pan(seed, (4, 8))
    assert abs(dy) == 4 and abs(dx) == 8
    assert clips.pan(seed, (4, 8)) == (dy, dx)


def test_pans_differ_across_seeds():
    pans = {clips.pan(s, (4, 8)) for s in range(40)}
    assert pans == {(4, 8), (4, -8), (-4, 8), (-4, -8)}


def test_every_seed_decodes_the_same_content():
    # a pan's direction flips the clip: the same pixels, the same work
    base, _ = clips.clip(CONTENT, 40, 56, 5, 0)
    for seed in range(1, 12):
        frames, _ = clips.clip(CONTENT, 40, 56, 5, seed)
        assert any(np.array_equal(frames, base[:, ::fy, ::fx])
                   for fy in (1, -1) for fx in (1, -1))


def test_clip_is_a_pan_of_the_picture():
    frames, (dy, dx) = clips.clip(CONTENT, 40, 56, 5, BIG)
    again, _ = clips.clip(CONTENT, 40, 56, 5, BIG)
    other, _ = clips.clip(CONTENT, 40, 56, 5, BIG + 1)
    assert frames.shape == (5, 40, 56) and np.array_equal(frames, again)
    assert not np.array_equal(frames, other)
    img = clips.picture("bridge_2048x1536")[:40, :56]
    assert np.array_equal(frames[0], img[::-1 if dy > 0 else 1,
                                         ::-1 if dx > 0 else 1])
    # each frame is the last one shifted by the pan, where both show it
    ys = slice(max(dy, 0), 40 + min(dy, 0))
    xs = slice(max(dx, 0), 56 + min(dx, 0))
    for i in range(1, 5):
        rolled = np.roll(frames[i - 1], (dy, dx), axis=(0, 1))
        assert np.array_equal(frames[i][ys, xs], rolled[ys, xs])
        # new content comes in at the edges: no circular shift
        assert not np.array_equal(frames[i], rolled)


def test_clip_tiles_past_the_picture():
    frames, _ = clips.clip(CONTENT, 1600, 2100, 1, 3)
    assert frames.shape == (1, 1600, 2100)


MIX = {"kind": "range", "clip_frames": 60, "frames": [1, 8]}


def _requests(seed, n):
    return list(itertools.islice(loops.range_requests(MIX, seed), n))


def test_range_requests_seeded_and_balanced():
    a = _requests(BIG, 800)
    assert a == _requests(BIG, 800)
    assert a != _requests(BIG + 1, 800)
    for block in range(0, 800, 8):
        sizes = sorted(b - s for s, b in a[block:block + 8])
        assert sizes == list(range(1, 9))
    assert all(0 <= s < b <= 60 for s, b in a)
    starts = [s for s, b in a if b - s == 1]
    assert min(starts) < 10 and max(starts) > 49


def test_sample_points_and_rotations():
    pts = loops.sample_points(BIG, 8)
    assert pts == sorted(pts) and pts == loops.sample_points(BIG, 8)
    assert pts != loops.sample_points(BIG + 1, 8)
    assert all(0 <= p < 1 for p in pts)
    orders = loops.rotation_orders({"clip_frames": 30, "rotations": 2,
                                    "rotation_frames": 8})
    assert orders[0].tolist() == list(range(30))
    assert orders[1].tolist() == list(range(22, 30)) + list(range(22))
