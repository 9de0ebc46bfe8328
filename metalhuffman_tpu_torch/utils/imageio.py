"""Image file IO (copy of ``metalhuffman_tpu/utils/imageio.py``).

The reference converts PNGs to 8-bit grayscale through CoreGraphics
(``HuffRenderFrame.m:67-127``) and carries a vestigial TGA parser
(``AAPLImage.m:14-160``). Here: PIL-based load/save for gray, color and
16-bit images, plus a dependency-free raw ``.gray`` format and a minimal
TGA reader (8-bit grayscale / 24-bit BGR) for parity with the reference's
loader.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np


def load_grayscale(path: str | Path) -> np.ndarray:
    """Load any PIL-supported image as (H, W) uint8 grayscale (BT.601 luma,
    matching the reference's CoreGraphics gray conversion)."""
    path = Path(path)
    if path.suffix == ".gray":
        return load_raw_gray(path)
    if path.suffix.lower() == ".tga":
        return tga_to_grayscale(load_tga(path))
    from PIL import Image

    return np.asarray(Image.open(path).convert("L"))


def save_grayscale(img: np.ndarray, path: str | Path) -> None:
    path = Path(path)
    img = np.asarray(img, dtype=np.uint8)
    if path.suffix == ".gray":
        save_raw_gray(img, path)
        return
    from PIL import Image

    Image.fromarray(img, mode="L").save(path)


def load_color(path: str | Path) -> np.ndarray:
    """Load an image keeping color: (H, W, 3) RGB or (H, W, 4) RGBA uint8.

    Unlike the reference (which throws color away through its CoreGraphics
    gray conversion, ``HuffRenderFrame.m:93-127``), the color pipeline keeps
    every channel; alpha is preserved only when the file actually carries it.
    Grayscale files come back as (H, W, 3) via channel replication.
    """
    path = Path(path)
    if path.suffix == ".gray":
        g = load_raw_gray(path)
        return np.repeat(g[..., None], 3, axis=-1)
    if path.suffix.lower() == ".tga":
        img = load_tga(path)
        if img.ndim == 2:
            return np.repeat(img[..., None], 3, axis=-1)
        return img[..., ::-1].copy()  # BGR -> RGB
    from PIL import Image

    im = Image.open(path)
    has_alpha = (im.mode in ("RGBA", "LA", "PA")
                 or (im.mode == "P" and "transparency" in im.info))
    return np.asarray(im.convert("RGBA" if has_alpha else "RGB"))


def save_color(img: np.ndarray, path: str | Path) -> None:
    """Save (H, W, 3) RGB / (H, W, 4) RGBA uint8 to any PIL-supported format."""
    from PIL import Image

    img = np.asarray(img, dtype=np.uint8)
    if img.ndim != 3 or img.shape[2] not in (3, 4):
        raise ValueError("expected (H, W, 3) or (H, W, 4) uint8")
    mode = "RGBA" if img.shape[2] == 4 else "RGB"
    Image.fromarray(img, mode=mode).save(path)


def load_gray16(path: str | Path) -> np.ndarray:
    """Load a 16-bit grayscale image: .npy (uint16) or 16-bit PNG/TIFF."""
    path = Path(path)
    if path.suffix == ".npy":
        arr = np.load(path)
        if arr.dtype != np.uint16:
            raise ValueError("expected a uint16 .npy array")
        return arr
    from PIL import Image

    im = Image.open(path)
    arr = np.asarray(im)
    if arr.dtype == np.uint16:
        return arr
    if arr.dtype == np.int32:  # PIL mode "I" for 16-bit PNGs
        return arr.astype(np.uint16)
    raise ValueError(f"{path} is not a 16-bit grayscale image ({arr.dtype})")


def save_gray16(img: np.ndarray, path: str | Path) -> None:
    """Save (H, W) uint16 as .npy or a 16-bit PNG."""
    path = Path(path)
    img = np.asarray(img, dtype=np.uint16)
    if path.suffix == ".npy":
        np.save(path, img)
        return
    from PIL import Image

    Image.fromarray(img, mode="I;16").save(path)


# -- raw .gray: trivial dependency-free container -----------------------------

_GRAY_MAGIC = b"GRY1"


def save_raw_gray(img: np.ndarray, path: str | Path) -> None:
    h, w = img.shape
    Path(path).write_bytes(
        _GRAY_MAGIC + struct.pack("<II", h, w) + np.ascontiguousarray(img).tobytes()
    )


def load_raw_gray(path: str | Path) -> np.ndarray:
    data = Path(path).read_bytes()
    if data[:4] != _GRAY_MAGIC:
        raise ValueError("not a GRY1 file")
    h, w = struct.unpack_from("<II", data, 4)
    return np.frombuffer(data, np.uint8, h * w, 12).reshape(h, w).copy()


# -- minimal TGA reader (reference: AAPLImage.m:14-160) -----------------------


def load_tga(path: str | Path) -> np.ndarray:
    """Read an uncompressed TGA: returns (H, W) uint8 gray or (H, W, 3) BGR."""
    data = Path(path).read_bytes()
    if len(data) < 18:
        raise ValueError("truncated TGA header")
    id_len = data[0]
    cmap_type = data[1]
    img_type = data[2]
    w, h = struct.unpack_from("<HH", data, 12)
    bpp = data[16]
    descriptor = data[17]
    if cmap_type != 0:
        raise ValueError("color-mapped TGA not supported")
    if img_type not in (2, 3):
        raise ValueError(f"unsupported TGA image type {img_type} (no RLE)")
    off = 18 + id_len
    if bpp == 8:
        img = np.frombuffer(data, np.uint8, h * w, off).reshape(h, w).copy()
    elif bpp in (24, 32):
        c = bpp // 8
        img = np.frombuffer(data, np.uint8, h * w * c, off).reshape(h, w, c)[..., :3].copy()
    else:
        raise ValueError(f"unsupported TGA depth {bpp}")
    if not (descriptor & 0x20):  # origin at bottom-left -> flip vertically
        img = img[::-1].copy()
    return img


def tga_to_grayscale(img: np.ndarray) -> np.ndarray:
    if img.ndim == 2:
        return img
    b, g, r = img[..., 0].astype(np.float64), img[..., 1].astype(np.float64), img[..., 2].astype(np.float64)
    return np.clip(0.299 * r + 0.587 * g + 0.114 * b, 0, 255).astype(np.uint8)
