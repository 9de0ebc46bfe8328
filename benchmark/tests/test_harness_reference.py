"""The plain reference on frames it did not make: random frames, random
motion, and the port's own transforms at tiny sizes as a second witness."""

import numpy as np
import pytest

from benchmark.reference import plain

RNG = np.random.default_rng(5)


def test_reference_imports_nothing_of_the_port():
    import ast
    import inspect

    tree = ast.parse(inspect.getsource(plain))
    names = {a.name.split(".")[0] for n in ast.walk(tree)
             if isinstance(n, (ast.Import, ast.ImportFrom))
             for a in getattr(n, "names", [])}
    mods = {n.module.split(".")[0] for n in ast.walk(tree)
            if isinstance(n, ast.ImportFrom) and n.module}
    assert (names | mods) <= {"numpy", "__future__", "annotations"}


def test_raw_layout_pads_with_zeros():
    fr = RNG.integers(0, 256, (3, 13, 21), np.uint8)
    raw = plain.raw_layout(fr, 8)
    assert raw.shape == (3, 16, 24)
    assert np.array_equal(raw[:, :13, :21], fr)
    assert not raw[:, 13:].any() and not raw[:, :, 21:].any()


@pytest.mark.parametrize("keyint", [1, 3, 8])
def test_fold_inverts_residuals(keyint):
    fr = RNG.integers(0, 256, (11, 12, 20), np.uint8)
    mvs = RNG.integers(-30, 30, (11, 2))
    res = plain.residuals(fr, keyint, mvs)
    assert np.array_equal(plain.fold(res, keyint, mvs), fr)
    assert np.array_equal(res[::keyint], fr[::keyint])


def test_residuals_match_the_port():
    from metalhuffman_tpu_torch.models import temporal

    fr = RNG.integers(0, 256, (10, 16, 24), np.uint8)
    mvs = RNG.integers(-5, 6, (10, 2)).astype(np.int16)
    mvs[::4] = 0
    want, _ = temporal.temporal_encode_mc(fr, 4, mvs)
    assert np.array_equal(plain.residuals(fr, 4, mvs), want)


def test_motion_predicts_a_panned_clip():
    from benchmark import clips

    content = {"picture": "bridge_2048x1536", "pan_px": [1, 16]}
    clip, pan = clips.clip(content, 40, 64, 9, 2**31 + 7)
    order = np.roll(np.arange(9), 4)
    fr = clip[order]
    mvs = plain.motion(order, pan, fr.shape[1:])
    res = plain.residuals(fr, 8, mvs)
    # a predicted frame is exact but for the strips entering at its edges;
    # the jump at the rotation predicts far less
    dy, dx = pan
    keep = np.ones(fr.shape[1:], bool)
    keep[:max(dy, 0)] = keep[fr.shape[1] + min(dy, 0):] = False
    keep[:, :max(dx, 0)] = keep[:, fr.shape[2] + min(dx, 0):] = False
    for i in [1, 2, 3, 5, 6, 7]:
        assert not res[i][keep].any() and res[i][~keep].any()
    assert np.count_nonzero(res[4]) > 2 * np.count_nonzero(res[1])


@pytest.mark.parametrize("temporal", [False, True])
def test_answers_and_control(temporal):
    codec = {"temporal": temporal, "motion": temporal, "keyint": 4,
             "block_dim": 8}
    base = RNG.integers(0, 256, (16, 24), np.uint8)
    order = np.arange(6)
    fr = np.stack([np.roll(base, (2 * i, -i), axis=(0, 1)) for i in order])
    ans = plain.staged_answer(codec, fr, order, (2, -1))
    assert np.array_equal(ans, fr)
    lossy = plain.staged_answer(codec, fr, order, (2, -1), lossy=True)
    assert lossy.shape == fr.shape and np.count_nonzero(lossy != fr) > 0
    assert np.array_equal(plain.range_answer(fr, 1, 4), fr[1:4])
    assert not np.array_equal(plain.range_answer(fr, 1, 4, lossy=True),
                              fr[1:4])
