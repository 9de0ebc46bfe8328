"""Multi-channel (color) and 16-bit grayscale images and videos: planar
channels over the shared-table video containers (MHTC).

Counterpart of ``metalhuffman_tpu/models/color.py``. Each channel is a
grayscale plane, and the planes ride the video containers (one canonical
table for all of them, one decode launch per batch or segment). A uint16
image splits into (hi, lo) byte planes. On disk:

    "MHTC" | u8 channels | u8 layout | u8 kind | u8 colorspace | inner blob

- ``layout``: 0 = single image (inner frames = C planes), 1 = video (inner
  frames = T*C planes, frame-major: frame t's planes are contiguous).
- ``kind``: 0 = uint8 channels, 1 = uint16 grayscale as (hi, lo) planes
  (``channels`` is 2).
- ``colorspace``: 0 = identity, 1 = sub-green (planes carry R-G, G, B-G mod
  256; alpha untouched), a reversible byte-preserving decorrelation.
- ``inner``: an MHTV, or a segmented MHV2, of the planes, with the CRC-32 of
  the planes.

The host half (the wrapper, the sub-green transform, the numpy plane fold)
is a copy of the JAX package's; :func:`fold_video_planes_torch` is the
device fold the temporal decode runs before its group fold. Every decode
takes ``device`` (default ``"cuda"``) and goes through the port's
``decode_video``, ``decode_range`` and ``decode_video_region``.
"""

from __future__ import annotations

import struct

import numpy as np
import torch

from . import frame_stream
from .config import CodecConfig

COLOR_MAGIC = b"MHTC"

LAYOUT_IMAGE = 0
LAYOUT_VIDEO = 1

KIND_U8 = 0
KIND_U16 = 1

CS_IDENTITY = 0
CS_SUBGREEN = 1


def wrap(inner: bytes, channels: int, layout: int, kind: int = KIND_U8,
         colorspace: int = CS_IDENTITY) -> bytes:
    """Wrap an inner video container blob in the MHTC header."""
    if not 1 <= channels <= 255:
        raise ValueError("channels must be in 1..255")
    return (COLOR_MAGIC
            + struct.pack("<BBBB", channels, layout, kind, colorspace)
            + inner)


def unwrap(blob: bytes):
    """MHTC blob -> (inner_bytes, channels, layout, kind, colorspace)."""
    if blob[:4] != COLOR_MAGIC:
        raise ValueError("not an MHTC container")
    if len(blob) < 8:
        raise ValueError("truncated MHTC container (header incomplete)")
    channels, layout, kind, colorspace = struct.unpack_from("<BBBB", blob, 4)
    if layout not in (LAYOUT_IMAGE, LAYOUT_VIDEO):
        raise ValueError(f"unknown MHTC layout {layout}")
    if kind not in (KIND_U8, KIND_U16):
        raise ValueError(f"unknown MHTC kind {kind}")
    if colorspace not in (CS_IDENTITY, CS_SUBGREEN):
        raise ValueError(f"unknown MHTC colorspace {colorspace}")
    return blob[8:], channels, layout, kind, colorspace


def to_subgreen(img: np.ndarray) -> np.ndarray:
    """(..., C>=3) uint8 -> sub-green: (R-G, G, B-G) mod 256, alpha
    untouched."""
    out = img.copy()
    out[..., 0] = img[..., 0] - img[..., 1]  # uint8 wraps mod 256
    out[..., 2] = img[..., 2] - img[..., 1]
    return out


def from_subgreen(img: np.ndarray) -> np.ndarray:
    """Inverse of :func:`to_subgreen`."""
    out = img.copy()
    out[..., 0] = img[..., 0] + img[..., 1]
    out[..., 2] = img[..., 2] + img[..., 1]
    return out


def _apply_cs(img: np.ndarray, colorspace: int) -> np.ndarray:
    if colorspace == CS_SUBGREEN:
        if img.shape[-1] < 3:
            raise ValueError("sub-green needs at least 3 channels")
        return to_subgreen(img)
    return img


def _invert_cs(img: np.ndarray, colorspace: int) -> np.ndarray:
    return from_subgreen(img) if colorspace == CS_SUBGREEN else img


def _check_planes(n: int, channels: int, kind: int) -> None:
    """The plane count against the declared channels and kind, on host
    metadata (the same messages as the JAX package)."""
    if kind == KIND_U16:
        if channels != 2 or n % 2:
            raise ValueError(
                f"u16 container needs hi/lo plane pairs (got {n} planes, "
                f"channels={channels})")
    elif channels == 0 or n % channels:
        raise ValueError(
            f"MHTC inner frame count ({n}) is not a multiple of the "
            f"declared {channels} channels")


def fold_video_planes(planes: np.ndarray, channels: int, kind: int,
                      colorspace: int) -> np.ndarray:
    """(N, H, W) uint8 planes -> (T, H, W, C) uint8 or (T, H, W) uint16:
    the inverse of the planar layout, on the host."""
    n, h, w = planes.shape
    _check_planes(n, channels, kind)
    if kind == KIND_U16:
        pairs = planes.reshape(n // 2, 2, h, w).astype(np.uint16)
        return (pairs[:, 0] << 8) | pairs[:, 1]
    out = planes.reshape(n // channels, channels, h, w).transpose(0, 2, 3, 1)
    return _invert_cs(out, colorspace)


def fold_video_planes_torch(planes: torch.Tensor, channels: int, kind: int,
                            colorspace: int) -> torch.Tensor:
    """:func:`fold_video_planes` on the tensor's device: (N, H, W) uint8 ->
    (T, H, W, C) uint8 or (T, H, W) uint16, contiguous.

    Checks the plane count on host metadata before any device work. The
    u16 frames are the (lo, hi) bytes interleaved and viewed as 16 bits
    (little-endian, as CPUs and CUDA cards are), one copy and no
    arithmetic; the sub-green inverse is two wrapping uint8 adds in place
    on the interleaved copy.
    """
    n, h, w = planes.shape
    _check_planes(n, channels, kind)
    if kind == KIND_U16:
        pairs = planes.reshape(n // 2, 2, h, w)
        le = torch.stack((pairs[:, 1], pairs[:, 0]), dim=-1)  # (T, H, W, 2)
        return le.view(torch.uint16).view(n // 2, h, w)
    out = planes.reshape(n // channels, channels, h, w).permute(
        0, 2, 3, 1).contiguous()
    if colorspace == CS_SUBGREEN:
        out[..., 0].add_(out[..., 1])  # uint8 wraps mod 256
        out[..., 2].add_(out[..., 1])
    return out


# -- stream-level API (no container) ------------------------------------------


def encode_color(img: np.ndarray, config: CodecConfig | None = None):
    """(H, W, C) uint8 -> (EncodedStream with shared table, C)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, C) uint8")
    planes = np.moveaxis(img, -1, 0)  # (C, H, W)
    return frame_stream.encode_frames_shared(planes, config), img.shape[2]


def decode_color(stream, height: int, width: int, channels: int,
                 config: CodecConfig | None = None, *,
                 device="cuda") -> np.ndarray:
    """Shared-table stream -> (H, W, C) uint8, the planes decoded on
    ``device``."""
    planes = frame_stream.decode_frames_shared(
        stream, channels, height, width, config, device=device)
    return np.moveaxis(planes.cpu().numpy(), 0, -1)


# -- container-level API -------------------------------------------------------


def _encode_planes(planes: np.ndarray, config) -> bytes:
    """(N, H, W) uint8 planes -> MHTV/MHV2 inner blob with source CRC-32."""
    from .. import encode_video

    return encode_video(np.ascontiguousarray(planes), config)


def _decode_planes(inner: bytes, device) -> np.ndarray:
    """Inner MHTV/MHV2 blob -> (N, H, W) uint8 planes, decoded on
    ``device`` and checked against the inner's CRC-32."""
    from .. import decode_video

    return decode_video(inner, device)


def encode_color_to_bytes(img: np.ndarray, config: CodecConfig | None = None,
                          colorspace: int = CS_IDENTITY) -> bytes:
    """(H, W, C) uint8 -> MHTC container (planes as inner frames)."""
    img = np.asarray(img)
    if img.ndim != 3 or img.dtype != np.uint8:
        raise ValueError("expected (H, W, C) uint8")
    planes = np.moveaxis(_apply_cs(img, colorspace), -1, 0)
    return wrap(_encode_planes(planes, config), img.shape[2], LAYOUT_IMAGE,
                colorspace=colorspace)


def decode_color_from_bytes(blob: bytes, device="cuda") -> np.ndarray:
    """MHTC (or legacy bare MHTV) container -> (H, W, C) uint8,
    CRC-verified."""
    if blob[:4] == COLOR_MAGIC:
        inner, channels, layout, kind, cs = unwrap(blob)
        if layout != LAYOUT_IMAGE or kind != KIND_U8:
            raise ValueError(
                "MHTC blob is not a u8 color image (use the video/gray16 "
                "decoder matching its layout/kind)")
        planes = _decode_planes(inner, device)
        if planes.shape[0] != channels:
            raise ValueError("MHTC channel count disagrees with inner frames")
    else:
        # legacy: a bare MHTV whose frame count is the channel count
        planes, cs = _decode_planes(blob, device), CS_IDENTITY
    return _invert_cs(np.moveaxis(planes, 0, -1), cs)


def encode_color_video_to_bytes(
    frames: np.ndarray, config: CodecConfig | None = None,
    colorspace: int = CS_IDENTITY,
) -> bytes:
    """(T, H, W, C) uint8 -> MHTC video container (T*C planes,
    frame-major)."""
    frames = np.asarray(frames)
    if frames.ndim != 4 or frames.dtype != np.uint8:
        raise ValueError("expected (T, H, W, C) uint8")
    t, h, w, c = frames.shape
    planes = _apply_cs(frames, colorspace).transpose(0, 3, 1, 2).reshape(
        t * c, h, w)
    return wrap(_encode_planes(planes, config), c, LAYOUT_VIDEO,
                colorspace=colorspace)


def decode_color_video_from_bytes(blob: bytes, device="cuda") -> np.ndarray:
    """MHTC video container -> (T, H, W, C) uint8, CRC-verified."""
    inner, channels, layout, kind, cs = unwrap(blob)
    if layout != LAYOUT_VIDEO or kind != KIND_U8:
        raise ValueError("MHTC blob is not a u8 color video")
    return fold_video_planes(_decode_planes(inner, device), channels,
                             kind, cs)


# -- 16-bit grayscale (depth maps) as hi/lo byte planes ------------------------


def encode_gray16_to_bytes(img: np.ndarray,
                           config: CodecConfig | None = None) -> bytes:
    """(H, W) or (T, H, W) uint16 -> MHTC kind=1 container."""
    img = np.asarray(img)
    if img.dtype != np.uint16 or img.ndim not in (2, 3):
        raise ValueError("expected (H, W) or (T, H, W) uint16")
    video = img.ndim == 3
    stack = img if video else img[None]
    hi = (stack >> 8).astype(np.uint8)
    lo = (stack & 0xFF).astype(np.uint8)
    t, h, w = stack.shape
    planes = np.stack([hi, lo], axis=1).reshape(t * 2, h, w)
    return wrap(_encode_planes(planes, config), 2,
                LAYOUT_VIDEO if video else LAYOUT_IMAGE, KIND_U16)


def decode_gray16_from_bytes(blob: bytes, device="cuda") -> np.ndarray:
    """MHTC kind=1 container -> (H, W) or (T, H, W) uint16, CRC-verified."""
    inner, channels, layout, kind, cs = unwrap(blob)
    if kind != KIND_U16 or channels != 2:
        raise ValueError("MHTC blob is not a 16-bit grayscale container")
    out = fold_video_planes(_decode_planes(inner, device), channels, kind, cs)
    if layout == LAYOUT_VIDEO:
        return out
    if out.shape[0] != 1:
        raise ValueError(
            f"single-image u16 container carries {out.shape[0]} planes pairs")
    return out[0]


# -- random access -------------------------------------------------------------


def decode_color_frame(blob: bytes, n: int, device="cuda") -> np.ndarray:
    """Frame ``n`` of an MHTC video -> (H, W, C) uint8, or (H, W) uint16 for
    kind=1; only that frame's planes decode (``frame_stream.decode_range``,
    checked against an inner per-frame CRC table where there is one)."""
    inner, channels, layout, kind, cs = unwrap(blob)
    if layout != LAYOUT_VIDEO:
        raise ValueError("MHTC blob is a single image (no frame axis)")
    planes, _h, _w = frame_stream.decode_range(
        inner, n * channels, (n + 1) * channels, device=device)
    return fold_video_planes(planes, channels, kind, cs)[0]


def decode_color_video_region(blob: bytes, a: int, b: int, y0: int, x0: int,
                              rh: int, rw: int, check: bool = False, *,
                              device="cuda") -> np.ndarray:
    """The (rh, rw) crop of frames [a, b) of an MHTC video -> (b-a, rh, rw, C)
    uint8 or (b-a, rh, rw) uint16.

    The planes are per-pixel transforms, so the crop commutes with the fold:
    only the region's blocks of the frames' planes decode
    (``frame_stream.decode_video_region``); ``check`` runs the end-bit check
    over exactly those blocks.
    """
    inner, channels, layout, kind, cs = unwrap(blob)
    if layout != LAYOUT_VIDEO:
        raise ValueError("MHTC blob is a single image (no frame axis)")
    planes = frame_stream.decode_video_region(
        inner, a * channels, b * channels, y0, x0, rh, rw, check=check,
        device=device)
    return fold_video_planes(planes, channels, kind, cs)


def describe(blob: bytes) -> str:
    """One-line human description of the MHTC wrapper."""
    _, channels, layout, kind, cs = unwrap(blob)
    what = "u16 grayscale (hi/lo planes)" if kind == KIND_U16 else \
        f"{channels}-channel u8"
    shape = "video" if layout == LAYOUT_VIDEO else "image"
    space = ", sub-green" if cs == CS_SUBGREEN else ""
    return f"MHTC: {what} {shape}{space}"
