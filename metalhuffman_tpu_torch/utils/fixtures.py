"""Test and benchmark frames of the port: a copy of
``metalhuffman_tpu/utils/fixtures.py`` (the reference's fixture configs,
rebuilt, and :func:`render_frame`) and the counterparts of ``bench.py``'s
``synthetic_frame`` and ``photo_frames``.

The reference enumerates its inputs in ``HuffRenderFrame.h:5-23`` and
constructs them in ``HuffRenderFrame.m:129-622``: tiny hand-written grids,
identity patterns, sparse nearly-constant frames (skewed code tables),
synthetic scale tests at 2048/4096, random noise and real photos. Each
config is a named generator of an equivalent frame; ``bridge`` and
``bridge_512`` load the committed photos under ``tests/assets/``.

The same formulas and seeds as the JAX package and ``bench.py``, so the
port's examples, smoke run and probes decode the workloads the JAX package
encodes and timed (``tests/test_torch_fixtures.py`` and
``tests/test_torch_guards.py`` hold them equal).
"""

from __future__ import annotations

from collections.abc import Callable
from pathlib import Path

import numpy as np

#: committed real-photo assets (absent only in stripped installs)
ASSET_DIR = Path(__file__).resolve().parents[2] / "tests" / "assets"


def asset_path(name: str) -> Path:
    """Path of a committed test asset; raises if the asset tree is missing."""
    p = ASSET_DIR / name
    if not p.exists():
        raise FileNotFoundError(
            f"asset {name!r} not found under {ASSET_DIR} (source checkout "
            "required for real-photo fixtures)"
        )
    return p


#: the committed 2048x1536 grayscale bridge photo
PHOTO = asset_path("bridge_2048x1536.png")


def _real_photo(name: str) -> np.ndarray:
    from . import imageio

    return imageio.load_grayscale(str(asset_path(name)))


Maker = Callable[[], np.ndarray]


def _increasing(h: int, w: int, start: int = 0, step: int = 1) -> np.ndarray:
    return (start + step * np.arange(h * w)).astype(np.uint8).reshape(h, w)


def _ident(n: int, levels: int = 256) -> np.ndarray:
    """Identity-style pattern: row-major ramp wrapped to ``levels`` values."""
    return (np.arange(n * n) % levels).astype(np.uint8).reshape(n, n)


def _sparse(h: int, w: int, density: float, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    img = np.zeros((h, w), np.uint8)
    mask = rng.random((h, w)) < density
    img[mask] = rng.integers(1, 256, int(mask.sum()), np.uint8)
    return img


def _photo_like(h: int, w: int, seed: int) -> np.ndarray:
    """Multi-scale smooth structure + texture noise; compresses like a photo."""
    rng = np.random.default_rng(seed)
    yy, xx = np.meshgrid(np.arange(h), np.arange(w), indexing="ij")
    img = (
        110
        + 70 * np.sin(xx / (w / 9.0)) * np.cos(yy / (h / 7.0))
        + 30 * np.sin((xx + 2 * yy) / 41.0)
        + rng.normal(0, 4.0, (h, w))
    )
    return np.clip(img, 0, 255).astype(np.uint8)


#: name -> frame generator (lazy; large configs only build on demand).
CONFIGS: dict[str, Maker] = {
    # tiny hand-written grids (HuffRenderFrame.m:135-217)
    "4x4_increasing1": lambda: _increasing(4, 4),
    "4x4_increasing2": lambda: _increasing(4, 4, start=128, step=3),
    "4x8_increasing1": lambda: _increasing(4, 8),
    "2x8_increasing1": lambda: _increasing(2, 8),
    # non-square with partial edge blocks (HuffRenderFrame.m:219-321)
    "6x4_not_square": lambda: _increasing(6, 4),
    # identity patterns (HuffRenderFrame.m:323-401)
    "8x8_ident": lambda: _ident(8),
    "16x8_ident": lambda: (np.arange(16 * 8) % 256).astype(np.uint8).reshape(16, 8),
    "16x16_ident": lambda: _ident(16),
    # sparse/degenerate nearly-all-zero frames -> skewed code tables
    # (HuffRenderFrame.m:402-460)
    "16x16_ident2": lambda: _sparse(16, 16, 0.05, seed=2),
    "16x16_ident3": lambda: _sparse(16, 16, 0.01, seed=3),
    # synthetic scale tests (HuffRenderFrame.m:462-494)
    "8x8_ident_2048": lambda: _ident(2048),
    "8x8_ident_4096": lambda: _ident(4096),
    # worst-case incompressible noise (HuffRenderFrame.m:496-525)
    "large_random": lambda: np.random.default_rng(7).integers(
        0, 256, (2048, 1536), np.uint8
    ),
    # real-image analogs at the reference asset dimensions (:527-613)
    "image1": lambda: _photo_like(512, 512, seed=11),
    "image2": lambda: _photo_like(2048, 2048, seed=12),
    "image3": lambda: _photo_like(1536, 2048, seed=13),
    "image4": lambda: _photo_like(1536, 2048, seed=14),  # BigBridge analog
    # real photographic content (the committed assets)
    "bridge": lambda: _real_photo("bridge_2048x1536.png"),
    "bridge_512": lambda: _real_photo("bridge_512x512.png"),
}

#: configs small enough for exhaustive unit testing
SMALL_CONFIGS = (
    "4x4_increasing1", "4x4_increasing2", "4x8_increasing1", "2x8_increasing1",
    "6x4_not_square", "8x8_ident", "16x8_ident", "16x16_ident",
    "16x16_ident2", "16x16_ident3",
)

#: large configs (scale/perf tests)
LARGE_CONFIGS = (
    "8x8_ident_2048", "8x8_ident_4096", "large_random",
    "image1", "image2", "image3", "image4", "bridge", "bridge_512",
)


def render_frame(config: str, path: str | None = None) -> np.ndarray:
    """Build the named test frame, or load a grayscale image from ``path``."""
    if path is not None:
        from . import imageio

        return imageio.load_grayscale(path)
    try:
        return CONFIGS[config]()
    except KeyError:
        raise ValueError(
            f"unknown config {config!r}; choose from {sorted(CONFIGS)}"
        ) from None


# -- the bench's frames (bench.py) ---------------------------------------------


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
