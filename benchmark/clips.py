"""The clips every cell decodes, made from ``--seed`` on the host.

A clip is a still picture under a constant camera pan: a window of the
frame's size moves (``pan_px`` = (dy, dx)) pixels a frame across a canvas,
the picture mirrored at its edges, so new content enters at the two edges
the pan moves towards (``bench.photo_frames`` pans 8 px on both axes but
wraps the picture round, which a motion search predicts exactly). The
seed draws the pan's direction on each axis: the clip is the same path
across the canvas, flipped upside down or left to right, so every seed
decodes the same content and does the same work. The picture is one of
``assets/``: the 2048x1536 gray BigBridge photo of the reference
(``Shared/HuffRenderFrame.m:593-613``), stored as its row-wise left
differences, zlib-compressed, so that loading it needs NumPy alone. It is
tiled or cropped to the configuration's frame size.
"""

from __future__ import annotations

import zlib
from pathlib import Path

import numpy as np

ASSETS = Path(__file__).resolve().parent / "assets"
#: name -> (height, width, CRC-32 of the picture's bytes)
PICTURES = {"bridge_2048x1536": (1536, 2048, 2761371111)}


def picture(name: str) -> np.ndarray:
    """The (H, W) uint8 picture ``assets/<name>.zdelta``; raises when its
    bytes do not match the recorded CRC-32."""
    h, w, crc = PICTURES[name]
    diff = np.frombuffer(zlib.decompress((ASSETS / f"{name}.zdelta")
                                         .read_bytes()), np.uint8)
    img = np.cumsum(diff.reshape(h, w), axis=1, dtype=np.uint8)
    if zlib.crc32(img.tobytes()) != crc:
        raise ValueError(f"asset {name} does not match its CRC-32")
    return img


def pan(seed: int, pan_px: tuple[int, int]) -> tuple[int, int]:
    """The seed's (dy, dx) pixels a frame: ``pan_px``, each axis with the
    seed's sign."""
    signs = np.random.default_rng([seed, 1]).choice([-1, 1], size=2)
    return int(signs[0] * pan_px[0]), int(signs[1] * pan_px[1])


def clip(content: dict, height: int, width: int, frames: int,
         seed: int) -> tuple[np.ndarray, tuple[int, int]]:
    """(T, H, W) uint8 frames of the configuration's ``content`` under the
    seed's pan -> (frames, (dy, dx)): frame ``i`` is frame ``i - 1``
    shifted by (dy, dx) where both show the canvas."""
    img = picture(content["picture"])
    reps = (-(-height // img.shape[0]), -(-width // img.shape[1]))
    img = np.tile(img, reps)[:height, :width]
    dy, dx = pan(seed, tuple(content["pan_px"]))
    sy, sx = (frames - 1) * abs(dy), (frames - 1) * abs(dx)
    # the window moves down and right across the canvas, so the content
    # moves up and left; a flip turns that into the seed's direction
    canvas = np.pad(img, ((0, sy), (0, sx)), mode="reflect")
    out = np.stack([canvas[i * abs(dy):i * abs(dy) + height,
                           i * abs(dx):i * abs(dx) + width]
                    for i in range(frames)])
    return out[:, ::-1 if dy > 0 else 1, ::-1 if dx > 0 else 1], (dy, dx)
