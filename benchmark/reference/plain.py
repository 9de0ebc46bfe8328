"""What the window's answers must be, worked out again from the seed's clip.

The codec is lossless, so a decode's answer is fixed by the frames that
were encoded; this module works it out in plain NumPy from those frames
alone, with nothing the port derived from them (no stream, table, staged
tensor or motion vector of the port):

- a batch decode at 8x8 blocks answers the frames laid out as whole
  blocks, zero-padded (the kernel's raw layout);
- an MHVT decode answers the fold of its residuals: the reference computes
  the residuals and its own motion vectors (the clip's known pan, per
  frame pair) and folds them back frame by frame;
- a range request [a, b) answers frames [a, b).

:func:`control` is the same work one precision below the configuration's
8-bit samples: every sample (or residual) keeps its top 7 bits. It stands
in the port's place to show that the comparison fails it.
"""

from __future__ import annotations

import numpy as np


def raw_layout(frames: np.ndarray, block_dim: int) -> np.ndarray:
    """(T, H, W) frames -> (T, bh*bd, bw*bd), zero past the frame."""
    t, h, w = frames.shape
    ph, pw = -(-h // block_dim) * block_dim, -(-w // block_dim) * block_dim
    out = np.zeros((t, ph, pw), np.uint8)
    out[:, :h, :w] = frames
    return out


def motion(order: np.ndarray, pan: tuple[int, int],
           shape: tuple[int, int]) -> np.ndarray:
    """(T, 2) per-frame (dy, dx) taking frame ``order[i-1]`` of a clip
    panned by ``pan`` a frame onto frame ``order[i]``, wrapped to the frame
    (it predicts every pixel but the strips that enter at the edges)."""
    step = np.diff(np.asarray(order, np.int64), prepend=order[0])
    mv = step[:, None] * np.asarray(pan, np.int64)[None, :]
    return mv % np.asarray(shape, np.int64)


def _key(i: int, keyint: int) -> bool:
    return i % keyint == 0


def residuals(frames: np.ndarray, keyint: int, mvs: np.ndarray) -> np.ndarray:
    """Keyframes literal, every other frame minus its predecessor rolled by
    its vector (wrapping mod 256)."""
    res = frames.copy()
    for i in range(1, frames.shape[0]):
        if not _key(i, keyint):
            res[i] = frames[i] - np.roll(frames[i - 1], tuple(mvs[i]),
                                         axis=(0, 1))
    return res


def fold(res: np.ndarray, keyint: int, mvs: np.ndarray) -> np.ndarray:
    """The inverse of :func:`residuals`, one frame after another."""
    out = res.copy()
    for i in range(1, res.shape[0]):
        if not _key(i, keyint):
            out[i] = res[i] + np.roll(out[i - 1], tuple(mvs[i]), axis=(0, 1))
    return out


def _drop_bit(x: np.ndarray) -> np.ndarray:
    return x & np.uint8(0xFE)


def staged_answer(codec: dict, frames: np.ndarray, order: np.ndarray,
                  pan: tuple[int, int], lossy: bool = False) -> np.ndarray:
    """The answer of one staged call on ``frames`` (the clip's frames in
    ``order``); ``lossy`` computes it at 7 bits (the control)."""
    if codec["temporal"]:
        keyint = codec["keyint"]
        mvs = motion(order, pan, frames.shape[1:])
        res = residuals(frames, keyint, mvs)
        return fold(_drop_bit(res) if lossy else res, keyint, mvs)
    return raw_layout(_drop_bit(frames) if lossy else frames, 8)


def range_answer(frames: np.ndarray, a: int, b: int,
                 lossy: bool = False) -> np.ndarray:
    """The answer of a range request [a, b)."""
    out = frames[a:b]
    return _drop_bit(out) if lossy else out
