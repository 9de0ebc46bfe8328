"""Test and benchmark frames of the port (counterpart of ``bench.py``'s
``synthetic_frame`` and ``photo_frames`` and of
``metalhuffman_tpu/utils/fixtures.py``'s ``bridge`` config).

The same formulas and seeds as ``bench.py``, so the port's smoke run and
probes decode the workloads the JAX package's bench and scratch scripts
timed (``tests/test_torch_guards.py`` holds them equal).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

#: the committed 2048x1536 grayscale bridge photo (a source checkout's asset)
PHOTO = Path(__file__).resolve().parents[2] / "tests" / "assets" / "bridge_2048x1536.png"


def synthetic_frame(h: int, w: int, seed: int = 0, phase: int = 0) -> np.ndarray:
    """Smooth gradients + mild noise (delta+Huffman compresses it to ~55%,
    like a natural photo); ``phase`` pans the gradient between frames."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    base = 96 + 80 * np.sin((xx + 3 * phase) / 97.0) * np.cos(yy / 71.0) + xx * 0.01
    img = base + rng.normal(0, 3.0, (h, w))
    return np.clip(img, 0, 255).astype(np.uint8)


def synthetic(t: int, h: int, w: int) -> np.ndarray:
    """(T, H, W) synthetic frames, frame ``i`` at phase ``i``."""
    return np.stack([synthetic_frame(h, w, seed=0, phase=i) for i in range(t)])


def photo() -> np.ndarray:
    """The committed 2048x1536 grayscale bridge photo, (1536, 2048) uint8."""
    from PIL import Image

    return np.asarray(Image.open(PHOTO).convert("L"))


def photo_frames(h: int, w: int, t: int) -> np.ndarray:
    """(T, H, W) photographic frames: the bridge photo, tiled to (H, W) and
    panned 8 px per frame in both axes."""
    img = photo()
    reps = (-(-h // img.shape[0]), -(-w // img.shape[1]))
    img = np.tile(img, reps)[:h, :w]
    return np.stack([np.roll(img, (8 * i, 8 * i), axis=(0, 1))
                     for i in range(t)])
