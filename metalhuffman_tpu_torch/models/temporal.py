"""Temporal (inter-frame) prediction for video: the MHVT wrapper container.

Counterpart of ``metalhuffman_tpu/models/temporal.py``. Frame ``t`` is stored
as its wrapping difference from frame ``t-1`` (mod 2^8, or 2^16 for u16
frames), with a literal keyframe every ``keyint`` frames, or, with motion
compensation, from frame ``t-1`` circularly shifted by a per-frame global
vector. The residual frames are ordinary frames in an ordinary inner video
container (MHTV, MHV2, or an MHTC of color or u16 planes). On disk::

    "MHVT" | u16 keyint | u16 flags | u32 inner_len
           | [flags bit 2: u64 inner_len (the u32 field is 0), > 4 GiB]
           | [flags bit 3: u16 first_len, a SHORT first keyframe group]
           | [flags bit 0: u32 T + T x (i16 dy, i16 dx) motion table]
           | [flags bit 1: u32 T + T x u32 per-TRUE-frame CRC-32 table]
           | inner video container (MHTV / MHV2 / MHTC video)
           | u32 source_crc32 of the TRUE frames (0 = unrecorded)

With flags bit 4 (the streaming trailer layout) the u64 inner length always
follows the header and the two tables sit after the inner, before the
source CRC. :func:`unwrap` reads both layouts; :func:`wrap` writes both.

The host half (the container, the numpy transforms, motion estimation, the
encoders and the ``--best`` searches) is a copy of the JAX package's. The
decode runs on ``device``: the inner through the decode kernels
(``frame_stream.decode_container_device``, or
``decode_range_parsed(..., to_host=False)``),
the plane fold (``color.fold_video_planes_torch``), then the group fold
(:func:`temporal_fold`) or the motion-compensated fold
(:func:`temporal_fold_mc`) on the true frames, then one fetch and the CRCs.
The JAX package's packed-word folds exist because a TPU lane is 32 bits
wide and has no byte addressing; a CUDA card addresses bytes, so the port
folds byte and 16-bit frames directly. With ``device="native"`` the inner
decodes on the host C++ decoder and the folds are the numpy ones
(:func:`temporal_decode`, :func:`temporal_decode_mc`,
``color.fold_video_planes``), as on the JAX package's native backend.
"""

from __future__ import annotations

import dataclasses
import math
import struct
import zlib

import numpy as np
import torch

from .. import native
from ..core import blocks
from ..utils.profiling import mark
from . import color, frame_stream
from .config import CodecConfig

TEMPORAL_MAGIC = b"MHVT"

_HEADER = "<HHI"  # keyint, flags, inner_len
_HEADER_SIZE = 4 + struct.calcsize(_HEADER)

FLAG_MOTION = 1  #: per-frame global motion vectors present
#: per-TRUE-frame CRC-32 table present (random access verifies exactly the
#: frames it reconstructs)
FLAG_FRAME_CRCS = 2
#: u64 inner length follows the header (u32 field is 0), for inners beyond
#: 4 GiB
FLAG_INNER64 = 4
#: u16 first-keyframe-group length follows (< keyint), written by the JAX
#: package's arbitrary-start ``surgery.extract_video``
FLAG_FIRST_LEN = 8
#: STREAMING (trailer) layout: a u64 inner length follows the header and the
#: motion / frame-CRC tables sit after the inner; never with FLAG_INNER64
FLAG_TRAILER = 16
_KNOWN_FLAGS = (FLAG_MOTION | FLAG_FRAME_CRCS | FLAG_INNER64
                | FLAG_FIRST_LEN | FLAG_TRAILER)

_MOTION_TABLE_ERROR = ("corrupt MHVT container (motion table length "
                       "disagrees with the frame count)")


def _group_start(i: int, keyint: int, first_len: int) -> int:
    """Index of the keyframe opening the group containing frame ``i``
    (keyframes sit at 0, first_len, first_len + keyint, ...)."""
    if i < first_len:
        return 0
    return first_len + ((i - first_len) // keyint) * keyint


# -- the transform on the host -------------------------------------------------


def temporal_encode(frames: np.ndarray, keyint: int = 8) -> np.ndarray:
    """(T, ...) unsigned frames -> residuals: keyframes literal, the rest
    ``frame[t] - frame[t-1]`` (wrapping mod 2^bits)."""
    frames = np.asarray(frames)
    if frames.ndim < 3:
        raise ValueError("frames must be (T, H, W[, C])")
    if frames.dtype not in (np.uint8, np.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    res = frames.copy()
    res[1:] -= frames[:-1]  # unsigned wraparound IS the mod-2^bits residual
    res[keyint::keyint] = frames[keyint::keyint]  # literal keyframes
    return res


def temporal_decode(residuals: np.ndarray, keyint: int = 8,
                    first_len: int | None = None) -> np.ndarray:
    """Inverse of :func:`temporal_encode` on the host: a per-group wrapping
    running sum. ``first_len`` (default ``keyint``) is the length of the
    first keyframe group."""
    residuals = np.asarray(residuals)
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    fl = keyint if first_len is None else first_len
    out = np.empty_like(residuals)
    for i in range(residuals.shape[0]):
        key = i == 0 or (i >= fl and (i - fl) % keyint == 0)
        out[i] = residuals[i] if key else (out[i - 1] + residuals[i])
    return out


# -- global motion compensation on the host -------------------------------------
#
# The predictor of a non-key frame is the previous frame circularly shifted
# by one integer vector (np.roll, exactly invertible), so panning cancels and
# only the wrapped border rows and columns mispredict.


def _luma(frame: np.ndarray) -> np.ndarray:
    """Estimation field: float32 luma (channel mean for color stacks)."""
    f = frame.astype(np.float32)
    return f.mean(axis=-1) if f.ndim == 3 else f


def _mc_cost(prev: np.ndarray, cur: np.ndarray, mv: tuple,
             step: int = 4) -> int:
    """Wrapping-residual magnitude of predictor roll(prev, mv), subsampled."""
    pred = np.roll(prev, mv, axis=(0, 1)) if mv != (0, 0) else prev
    m = 65536 if prev.dtype == np.uint16 else 256
    r = (cur[::step, ::step].astype(np.int32)
         - pred[::step, ::step].astype(np.int32)) % m
    return int(np.minimum(r, m - r).sum())


def estimate_motion(prev: np.ndarray, cur: np.ndarray,
                    max_shift: int = 256) -> tuple[int, int]:
    """Integer global motion (dy, dx) with ``cur ~= roll(prev, (dy, dx))``.

    Phase correlation on the luma field (2x2-downsampled when both sides
    are even and at least 64), the doubled peak refined over its +-1 px
    neighbourhood with the exact wrapping-residual cost; kept only when it
    beats zero motion on that cost.
    """
    a, b = _luma(prev), _luma(cur)
    down = a.shape[0] % 2 == 0 and a.shape[1] % 2 == 0 and min(a.shape) >= 64
    if down:
        a = a.reshape(a.shape[0] // 2, 2, a.shape[1] // 2, 2).mean((1, 3))
        b = b.reshape(b.shape[0] // 2, 2, b.shape[1] // 2, 2).mean((1, 3))
    fa = np.fft.rfft2(a)
    fb = np.fft.rfft2(b)
    cross = fb * np.conj(fa)
    cross /= np.abs(cross) + 1e-6
    corr = np.fft.irfft2(cross, a.shape)
    peak = np.unravel_index(int(np.argmax(corr)), corr.shape)
    dy = peak[0] - (a.shape[0] if peak[0] > a.shape[0] // 2 else 0)
    dx = peak[1] - (a.shape[1] if peak[1] > a.shape[1] // 2 else 0)
    if down:
        dy, dx = 2 * dy, 2 * dx
    if abs(dy) > max_shift or abs(dx) > max_shift or (
            not down and (dy, dx) == (0, 0)):
        return (0, 0)
    if down:
        cands = [(dy + ey, dx + ex) for ey in (-1, 0, 1) for ex in (-1, 0, 1)]
        cands = [c for c in cands
                 if abs(c[0]) <= max_shift and abs(c[1]) <= max_shift]
        dy, dx = min(cands, key=lambda c: _mc_cost(prev, cur, c))
        if (dy, dx) == (0, 0):
            return (0, 0)
    if _mc_cost(prev, cur, (int(dy), int(dx))) < _mc_cost(prev, cur, (0, 0)):
        return (int(dy), int(dx))
    return (0, 0)


def temporal_encode_mc(frames: np.ndarray, keyint: int = 8,
                       mvs: np.ndarray | None = None):
    """Motion-compensated residuals ``frame[t] - roll(frame[t-1], mv[t])``
    -> ``(residuals, mvs)``, ``mvs`` a (T, 2) int16 array of per-frame
    (dy, dx), estimated per non-key frame unless given; keyframes are
    literal and carry (0, 0)."""
    frames = np.asarray(frames)
    if frames.ndim < 3:
        raise ValueError("frames must be (T, H, W[, C])")
    if frames.dtype not in (np.uint8, np.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    t = frames.shape[0]
    if mvs is None:
        mvs = np.zeros((t, 2), np.int16)
        for i in range(1, t):
            if i % keyint:
                mvs[i] = estimate_motion(frames[i - 1], frames[i])
    else:
        mvs = np.asarray(mvs, np.int16).reshape(t, 2)
    res = frames.copy()
    for i in range(1, t):
        if i % keyint == 0:
            continue  # literal keyframe
        mv = (int(mvs[i, 0]), int(mvs[i, 1]))
        pred = (np.roll(frames[i - 1], mv, axis=(0, 1)) if mv != (0, 0)
                else frames[i - 1])
        res[i] = frames[i] - pred  # unsigned wraparound
    return res, mvs


def temporal_decode_mc(residuals: np.ndarray, keyint: int,
                       mvs: np.ndarray,
                       first_len: int | None = None) -> np.ndarray:
    """Inverse of :func:`temporal_encode_mc` on the host (sequential within a
    group: each predictor is the previous reconstructed frame, rolled)."""
    residuals = np.asarray(residuals)
    mvs = np.asarray(mvs)
    if mvs.ndim != 2 or mvs.shape != (residuals.shape[0], 2):
        raise ValueError(_MOTION_TABLE_ERROR)
    fl = keyint if first_len is None else first_len
    out = np.empty_like(residuals)
    for i in range(residuals.shape[0]):
        if i == 0 or (i >= fl and (i - fl) % keyint == 0):
            out[i] = residuals[i]
            continue
        mv = (int(mvs[i, 0]), int(mvs[i, 1]))
        pred = (np.roll(out[i - 1], mv, axis=(0, 1)) if mv != (0, 0)
                else out[i - 1])
        out[i] = residuals[i] + pred
    return out


# -- the folds on the device ----------------------------------------------------


def _fold_view(res: torch.Tensor) -> torch.Tensor:
    """The view the folds add in: uint16 folds as the same bits viewed
    int16, which wraps alike (torch has no uint16 add)."""
    if res.dtype not in (torch.uint8, torch.uint16):
        raise ValueError("temporal prediction needs uint8/uint16 frames")
    if not res.is_contiguous():
        raise ValueError("the folds work in place on a contiguous tensor")
    return res.view(torch.int16) if res.dtype == torch.uint16 else res


def _groups(t: int, keyint: int, first_len: int | None):
    """The keyframe groups of ``t`` frames as (start, groups, length)
    spans: ``groups`` whole groups of ``length`` frames from ``start``. A
    short first group is a span of its own (the reference front-pads it
    with zero frames instead, which costs a copy of the stack), and so is
    a short last group."""
    if keyint < 1:
        raise ValueError("keyint must be >= 1")
    fl = first_len if first_len else keyint
    spans = []
    start = 0
    if fl != keyint:
        spans.append((0, 1, min(fl, t)))
        start = min(fl, t)
    whole = (t - start) // keyint
    if whole:
        spans.append((start, whole, keyint))
    rest = t - start - whole * keyint
    if rest:
        spans.append((start + whole * keyint, 1, rest))
    return spans


def temporal_fold(res: torch.Tensor, keyint: int,
                  first_len: int | None = None) -> torch.Tensor:
    """Group fold on the tensor's device, in place: (T, ...) uint8 or uint16
    residuals become the frames, wrapping in the element type (the
    counterpart of the JAX package's ``temporal_decode_jax``); returns
    ``res``.

    ``keyint - 1`` slot adds over each (groups, keyint, ...) view, every
    add touching one frame slot of every group; the keyframe slot is left
    as it is.
    """
    x = _fold_view(res)
    for start, g, n in _groups(x.shape[0], keyint, first_len):
        grp = x[start : start + g * n].view((g, n) + tuple(x.shape[1:]))
        for s in range(1, n):
            grp[:, s].add_(grp[:, s - 1])
    return res


def roll_groups(prev: torch.Tensor, dy: torch.Tensor,
                dx: torch.Tensor) -> torch.Tensor:
    """``np.roll(prev[g], (dy[g], dx[g]), axis=(0, 1))`` for every g at once:
    (G, H, W, ...) -> a new (G, H, W, ...) tensor.

    One gather by broadcast row and column indices, (G, H, 1) rows
    ``(y - dy) mod H`` and (G, 1, W) columns ``(x - dx) mod W``, so each
    group rolls by its own vector and no full (G, H, W) index is built.
    Negative and oversized vectors wrap as ``np.roll`` wraps them.
    """
    g, h, w = prev.shape[:3]
    dev = prev.device
    rows = torch.remainder(torch.arange(h, device=dev)[None, :]
                           - dy[:, None], h)
    cols = torch.remainder(torch.arange(w, device=dev)[None, :]
                           - dx[:, None], w)
    gi = torch.arange(g, device=dev)[:, None, None]
    return prev[gi, rows[:, :, None], cols[:, None, :]]


def temporal_fold_mc(res: torch.Tensor, keyint: int, mvs,
                     first_len: int | None = None) -> torch.Tensor:
    """Motion-compensated fold on the tensor's device, in place: ``out[i] =
    res[i] + roll(out[i-1], mv[i])`` within each keyframe group, on
    (T, H, W) or (T, H, W, C) uint8 or (T, H, W) uint16 true frames (the
    counterpart of the JAX package's ``temporal_decode_mc_jax``); returns
    ``res``.

    Sequential within a group, vectorised across groups: each slot rolls
    every group's previous frame by its own vector (:func:`roll_groups`) and
    adds the residuals in place. A slot whose vectors are all zero (known on
    the host) is a plain add. The frames must be the true (H, W) extent: a
    roll over a padded extent would wrap pixels through the pad.
    """
    mvs = np.asarray(mvs)
    t = res.shape[0]
    if mvs.ndim != 2 or mvs.shape != (t, 2):
        raise ValueError(_MOTION_TABLE_ERROR)
    x = _fold_view(res)
    h, w = x.shape[1], x.shape[2]
    mv = mvs.astype(np.int64) % np.array([h, w])  # np.roll's wrap
    mv_dev = torch.from_numpy(mv).to(x.device)
    for start, g, n in _groups(t, keyint, first_len):
        grp = x[start : start + g * n].view((g, n) + tuple(x.shape[1:]))
        mvg = mv[start : start + g * n].reshape(g, n, 2)
        dvg = mv_dev[start : start + g * n].view(g, n, 2)
        for s in range(1, n):
            if mvg[:, s].any():
                grp[:, s].add_(roll_groups(grp[:, s - 1], dvg[:, s, 0],
                                           dvg[:, s, 1]))
            else:
                grp[:, s].add_(grp[:, s - 1])
    return res


# -- container -------------------------------------------------------------------


def wrap(inner: bytes, keyint: int, source_crc32: int = 0,
         mvs: np.ndarray | None = None,
         frame_crcs: np.ndarray | None = None,
         first_len: int | None = None,
         trailer: bool = False) -> bytes:
    """Wrap an inner video container blob in the MHVT header + CRC trailer
    (the header layout, or with ``trailer`` the streaming layout)."""
    if not 1 <= keyint <= 0xFFFF:
        raise ValueError("keyint must be in 1..65535")
    flags = FLAG_TRAILER if trailer else 0
    extra = b""
    inner_len32 = len(inner)
    if trailer:
        inner_len32 = 0
        extra += struct.pack("<Q", len(inner))
    elif len(inner) > 0xFFFFFFFF:
        flags |= FLAG_INNER64
        inner_len32 = 0
        extra += struct.pack("<Q", len(inner))
    if first_len is not None and first_len != keyint:
        if not 1 <= first_len < keyint:
            raise ValueError("first_len must be in 1..keyint")
        flags |= FLAG_FIRST_LEN
        extra += struct.pack("<H", first_len)
    mv_blob = b""
    if mvs is not None:
        mvs = np.asarray(mvs, np.int16).reshape(-1, 2)
        flags |= FLAG_MOTION
        mv_blob = struct.pack("<I", mvs.shape[0]) + mvs.astype("<i2").tobytes()
    fc_blob = b""
    if frame_crcs is not None:
        fc = np.asarray(frame_crcs, np.uint32).reshape(-1)
        flags |= FLAG_FRAME_CRCS
        fc_blob = struct.pack("<I", fc.shape[0]) + fc.astype("<u4").tobytes()
    tables = mv_blob + fc_blob
    head = TEMPORAL_MAGIC + struct.pack(_HEADER, keyint, flags, inner_len32)
    body = (head + extra + inner + tables if trailer
            else head + extra + tables + inner)
    return body + struct.pack("<I", source_crc32 & 0xFFFFFFFF)


def _parse_tables(blob: bytes, pos: int, flags: int):
    """Parse the motion / frame-CRC tables at ``pos`` -> (mvs, fcrcs, pos)
    (before the inner in the header layout, after it in the trailer
    layout)."""
    mvs = None
    if flags & FLAG_MOTION:
        if len(blob) < pos + 4:
            raise ValueError("truncated MHVT container (motion table)")
        (t,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        if len(blob) < pos + 4 * t:
            raise ValueError("truncated MHVT container (motion table)")
        mvs = np.frombuffer(blob, dtype="<i2", count=2 * t,
                            offset=pos).reshape(t, 2).copy()
        pos += 4 * t
    fcrcs = None
    if flags & FLAG_FRAME_CRCS:
        if len(blob) < pos + 4:
            raise ValueError("truncated MHVT container (frame CRC table)")
        (t,) = struct.unpack_from("<I", blob, pos)
        pos += 4
        if len(blob) < pos + 4 * t:
            raise ValueError("truncated MHVT container (frame CRC table)")
        fcrcs = np.frombuffer(blob, dtype="<u4", count=t, offset=pos).copy()
        pos += 4 * t
    return mvs, fcrcs, pos


def unwrap(blob: bytes):
    """MHVT blob -> (inner, keyint, source_crc32, mvs_or_None,
    frame_crcs_or_None, first_len), from either layout. ``first_len`` is
    ``keyint`` unless the container records a short first group."""
    if blob[:4] != TEMPORAL_MAGIC:
        raise ValueError("not an MHVT container")
    if len(blob) < _HEADER_SIZE:
        raise ValueError("truncated MHVT container (header incomplete)")
    keyint, flags, inner_len = struct.unpack_from(_HEADER, blob, 4)
    if keyint < 1:
        raise ValueError("corrupt MHVT container (keyint 0)")
    if flags & ~_KNOWN_FLAGS:
        raise ValueError(
            f"unsupported MHVT container (unknown flags 0x{flags:04x} — "
            "written by a newer format revision?)")
    trailer = bool(flags & FLAG_TRAILER)
    if trailer and flags & FLAG_INNER64:
        raise ValueError(
            "corrupt MHVT container (trailer layout carries its own u64 "
            "inner length; INNER64 must not combine with it)")
    pos = _HEADER_SIZE
    if trailer or flags & FLAG_INNER64:
        if len(blob) < pos + 8:
            raise ValueError("truncated MHVT container (u64 inner length)")
        (inner_len,) = struct.unpack_from("<Q", blob, pos)
        pos += 8
    first_len = keyint
    if flags & FLAG_FIRST_LEN:
        if len(blob) < pos + 2:
            raise ValueError("truncated MHVT container (first_len field)")
        (first_len,) = struct.unpack_from("<H", blob, pos)
        pos += 2
        if not 1 <= first_len <= keyint:
            raise ValueError(
                "corrupt MHVT container (first keyframe group length "
                f"{first_len} outside 1..keyint={keyint})")
    if trailer:
        end = pos + inner_len
        if len(blob) < end:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        inner = blob[pos:end]
        mvs, fcrcs, tpos = _parse_tables(blob, end, flags)
        if len(blob) < tpos + 4:
            raise ValueError(
                "truncated MHVT container (inner/trailer missing)")
        (crc,) = struct.unpack_from("<I", blob, tpos)
        return inner, keyint, crc, mvs, fcrcs, first_len
    mvs, fcrcs, pos = _parse_tables(blob, pos, flags)
    end = pos + inner_len
    if len(blob) < end + 4:
        raise ValueError("truncated MHVT container (inner/trailer missing)")
    (crc,) = struct.unpack_from("<I", blob, end)
    return blob[pos:end], keyint, crc, mvs, fcrcs, first_len


def _inner_config(config: CodecConfig | None) -> CodecConfig:
    """The config of the inner (residual) encode: no temporal, no motion,
    and no inner per-frame CRC table (the wrapper records the TRUE frames'
    table, the one random access verifies)."""
    return dataclasses.replace(config or CodecConfig(), temporal=False,
                               motion=False, frame_crcs=False)


def _crc(frames: np.ndarray) -> int:
    return zlib.crc32(np.ascontiguousarray(frames).tobytes()) & 0xFFFFFFFF


def _frame_crcs(frames: np.ndarray, cfg: CodecConfig):
    """(T,) uint32 per-TRUE-frame CRC table, or None unless cfg asks."""
    if not cfg.frame_crcs:
        return None
    return frame_stream.compute_frame_crcs(frames)


def _verify_frame_crcs(frames, fcrcs, base: int = 0) -> None:
    """Check reconstructed frames [base, base+len) against the CRC table."""
    frame_stream.verify_frame_crcs(frames, fcrcs, base)


def _inner_frame_count(inner: bytes):
    """TRUE frame count recorded in the inner container header (or None):
    planes / channels for a u8 MHTC inner, planes / 2 for u16."""
    div = 1
    if inner[:4] == color.COLOR_MAGIC:
        inner2, ch, _layout, kind, _cs = color.unwrap(inner)
        div = 2 if kind == color.KIND_U16 else ch
        inner = inner2
    if inner[:4] in (frame_stream.SHARED_MAGIC,
                     frame_stream.SEGMENTED_MAGIC):
        (t,) = struct.unpack_from("<I", inner, 4)
        return t // div if div else None
    return None


def _plane_inner(inner: bytes):
    """(the MHTV/MHV2 of the residual planes, (channels, kind, colorspace)
    for an MHTC inner, else None)."""
    if inner[:4] != color.COLOR_MAGIC:
        return inner, None
    inner2, ch, layout, kind, cs = color.unwrap(inner)
    if layout != color.LAYOUT_VIDEO:
        raise ValueError("MHVT inner MHTC container is not a video")
    return inner2, (ch, kind, cs)


# -- encoders ---------------------------------------------------------------------


def _residuals(frames: np.ndarray, cfg: CodecConfig,
               mvs: np.ndarray | None = None):
    """(residual stack, mvs-or-None) per the config's motion flag; ``mvs``
    supplies vectors estimated earlier."""
    if cfg.motion:
        return temporal_encode_mc(frames, cfg.keyint, mvs)
    return temporal_encode(frames, cfg.keyint), None


def encode_temporal_video(frames: np.ndarray,
                          config: CodecConfig | None = None,
                          mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W) uint8 -> MHVT wrapping an MHTV/MHV2 residual stream
    (host encode), with motion compensation under ``config.motion``."""
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    res, mvs = _residuals(frames, cfg, mvs)
    return wrap(encode_video(res, _inner_config(cfg)), cfg.keyint,
                source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def encode_temporal_color_video(frames: np.ndarray,
                                config: CodecConfig | None = None,
                                colorspace: int | None = None,
                                mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W, C) uint8 -> MHVT wrapping an MHTC residual video."""
    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    res, mvs = _residuals(frames, cfg, mvs)
    cs = color.CS_IDENTITY if colorspace is None else colorspace
    inner = color.encode_color_video_to_bytes(res, _inner_config(cfg),
                                              colorspace=cs)
    return wrap(inner, cfg.keyint, source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def encode_temporal_gray16_video(frames: np.ndarray,
                                 config: CodecConfig | None = None,
                                 mvs: np.ndarray | None = None) -> bytes:
    """(T, H, W) uint16 -> MHVT wrapping an MHTC kind=1 residual video (the
    residual is taken mod 65536 on the u16 frames, then split)."""
    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3 or frames.dtype != np.uint16:
        raise ValueError("expected (T, H, W) uint16")
    res, mvs = _residuals(frames, cfg, mvs)
    inner = color.encode_gray16_to_bytes(res, _inner_config(cfg))
    return wrap(inner, cfg.keyint, source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


# -- the --best searches (host work) --------------------------------------------


def _precoders(cfg: CodecConfig) -> list:
    """The none, delta and delta2d variants of ``cfg``."""
    return [
        dataclasses.replace(cfg, delta=False, delta2d=False, zero_init=False),
        dataclasses.replace(cfg, delta=True, delta2d=False),
        dataclasses.replace(cfg, delta=True, delta2d=True),
    ]


def _best_precoder(frames: np.ndarray, cfg: CodecConfig) -> CodecConfig:
    """Smallest of none/delta/delta2d measured on the actual payload."""

    def total(c):
        return sum(s.compressed_size
                   for s, _ in frame_stream.encode_frames_segmented(frames, c))

    return min(_precoders(cfg), key=total)


def _estimate_candidate_bits(blk: np.ndarray, cfg: CodecConfig) -> float:
    """Compressed size of a sampled BLOCKED payload under cfg's precoder:
    the production encoder run on the subsample (exact widths and table
    overhead)."""
    if cfg.delta2d:
        payload = native.delta2d_encode(blk, cfg.block_dim)
    elif cfg.delta:
        payload = native.delta_encode(blk, cfg.block_size)
    else:
        payload = blk
    return float(native.encode_symbols(
        payload, block_size=cfg.block_size).compressed_size)


def _sample_indices(t: int, keyint: int, max_samples: int = 12) -> list[int]:
    """Strided frame indices preserving the keyframe/residual mixture.

    The stride is nudged coprime with keyint: a stride that is a multiple of
    keyint would sample (almost) only keyframes.
    """
    stride = max(1, t // max_samples)
    while stride > 1 and math.gcd(stride, keyint) != 1:
        stride += 1
    idx = list(range(0, t, stride))
    if all(i % keyint == 0 for i in idx) and t > 1:
        idx.append(1)  # ensure at least one residual frame is sampled
    return idx


def _encode_mc(frames: np.ndarray, cfg: CodecConfig, res_mc: np.ndarray,
               mvs: np.ndarray) -> bytes:
    """MHVT of motion-compensated residuals already computed."""
    from .. import encode_video

    return wrap(encode_video(res_mc, _inner_config(cfg)), cfg.keyint,
                source_crc32=_crc(frames), mvs=mvs,
                frame_crcs=_frame_crcs(frames, cfg))


def encode_video_best_fast(frames: np.ndarray,
                           config: CodecConfig | None = None):
    """Subsampled :func:`encode_video_best`: estimate every (mode, precoder)
    candidate's size on a strided frame subsample, then fully encode only
    the best-ranked candidate of each of the two best modes (the second only
    when its estimate is within 5 % of the leader's) and keep the smaller
    container. Returns ``(blob, kind, used_config)`` like the full search;
    fewer than 4 frames run the full search.
    """
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    t = frames.shape[0]
    if t < 4:  # sampling cannot beat measuring on tiny inputs
        return encode_video_best(frames, cfg)
    idx = _sample_indices(t, cfg.keyint)
    modes: dict[str, list] = {}
    modes["plain"] = [frames[i] for i in idx]
    modes["temporal"] = [
        frames[i] if i % cfg.keyint == 0 else frames[i] - frames[i - 1]
        for i in idx]
    mvs_sampled = {}
    if cfg.motion:
        mc = []
        for i in idx:
            if i % cfg.keyint == 0:
                mc.append(frames[i])
                continue
            mv = estimate_motion(frames[i - 1], frames[i])
            mvs_sampled[i] = mv
            pred = (np.roll(frames[i - 1], mv, axis=(0, 1))
                    if mv != (0, 0) else frames[i - 1])
            mc.append(frames[i] - pred)
        modes["temporal+motion"] = mc
    # each mode's sample stack is blocked once; its three precoder
    # estimates share it
    blocked = {
        kind: np.concatenate(
            [blocks.image_to_blocks(np.ascontiguousarray(f),
                                    cfg.block_dim).ravel()
             for f in samples])
        for kind, samples in modes.items()}
    ranked = sorted(
        ((_estimate_candidate_bits(blocked[kind], pc), kind, pc)
         for kind in modes for pc in _precoders(cfg)),
        key=lambda r: r[0])

    def full_encode(kind: str, pc: CodecConfig):
        if kind == "plain":
            return encode_video(frames, dataclasses.replace(
                pc, temporal=False, motion=False))
        if kind == "temporal":
            return encode_temporal_video(frames, dataclasses.replace(
                pc, temporal=True, motion=False))
        # reuse the vectors the sampling pass estimated; estimate the rest
        mvs = np.zeros((t, 2), np.int16)
        for i in range(1, t):
            if i % cfg.keyint:
                mvs[i] = (mvs_sampled[i] if i in mvs_sampled
                          else estimate_motion(frames[i - 1], frames[i]))
        res_mc, mvs = temporal_encode_mc(frames, cfg.keyint, mvs)
        return _encode_mc(frames, pc, res_mc, mvs)

    finalists = []
    seen = set()
    best_bits = ranked[0][0]
    for bits, kind, pc in ranked:
        if kind in seen:
            continue  # one finalist per coding mode (its best precoder)
        # the runner-up is encoded only when its estimate is within 5 % of
        # the leader's; a clear win encodes once
        if finalists and bits > 1.05 * best_bits:
            break
        seen.add(kind)
        finalists.append((full_encode(kind, pc), kind, pc))
        if len(finalists) == 2:
            break
    return min(finalists, key=lambda c: len(c[0]))


def encode_video_best(frames: np.ndarray, config: CodecConfig | None = None):
    """Measure the coding modes, each with its best spatial precoder on its
    own payload, and keep the smallest container.

    Candidates: plain, temporal, and (with ``config.motion``) temporal with
    global motion compensation. Returns ``(blob, kind, used_config)`` with
    ``kind`` one of ``"plain" | "temporal" | "temporal+motion"``.
    """
    from .. import encode_video

    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    candidates = []
    cfg_p = _best_precoder(frames, _inner_config(cfg))
    candidates.append((encode_video(frames, cfg_p), "plain", cfg_p))
    plain_cfg = dataclasses.replace(cfg, motion=False)
    cfg_t = _best_precoder(temporal_encode(frames, cfg.keyint), plain_cfg)
    candidates.append(
        (encode_temporal_video(frames, cfg_t), "temporal", cfg_t))
    if cfg.motion:
        res_mc, mvs = temporal_encode_mc(frames, cfg.keyint)
        cfg_m = _best_precoder(res_mc, cfg)
        candidates.append((_encode_mc(frames, cfg_m, res_mc, mvs),
                           "temporal+motion", cfg_m))
    return min(candidates, key=lambda c: len(c[0]))


# -- decoders ---------------------------------------------------------------------


def _fold(res: torch.Tensor, keyint: int, mvs, first_len) -> torch.Tensor:
    """The group or the motion-compensated fold of the residuals."""
    if mvs is not None:
        return temporal_fold_mc(res, keyint, mvs, first_len)
    return temporal_fold(res, keyint, first_len)


def _fold_host(res: np.ndarray, keyint: int, mvs, first_len) -> np.ndarray:
    """:func:`_fold` on the host, for ``device="native"``."""
    if mvs is not None:
        return temporal_decode_mc(res, keyint, mvs, first_len=first_len)
    return temporal_decode(res, keyint, first_len=first_len)


def fold_planes(planes: torch.Tensor, keyint: int, mvs, first_len,
                cinfo) -> torch.Tensor:
    """An MHVT's decoded (N, H, W) uint8 residual planes -> its true frames,
    on the tensor's device: the plane fold for an MHTC inner (``cinfo`` =
    (channels, kind, colorspace), else None), then the group or the
    motion-compensated fold. ``planes`` is used up when no plane fold
    copies it (the folds work in place). Under a profiler the call starts
    with the mark ``fold``."""
    mark("fold")
    res = planes if cinfo is None else color.fold_video_planes_torch(
        planes, *cinfo)
    return _fold(res, keyint, mvs, first_len)


def decode_temporal_video(blob: bytes, device="cuda") -> np.ndarray:
    """MHVT container -> reconstructed frames ((T, H, W) u8, (T, H, W, C) u8
    or (T, H, W) u16, per the inner), decoded and folded on ``device`` and
    fetched once.

    The outer CRC of the true frames covers every inner bit and the
    wrapper's parameters. When it fails, the inner is decoded again with
    its own CRC check (``decode_video`` on the same device), to say which
    part is corrupt: the residual stream (its ``ValueError``) or the wrapper
    header. A container with no outer CRC checks the inner's CRC on the
    residual planes instead, which costs a fetch of them. Nothing is
    returned unchecked, and there is no other route.

    ``device="native"`` decodes the inner on the host C++ decoder with its
    own CRC check, folds on the host, then checks the outer CRC: both CRCs,
    as the JAX package's native backend does.
    """
    from .. import decode_video

    inner, keyint, crc, mvs, fcrcs, first_len = unwrap(blob)
    if mvs is not None:
        # validate against the inner header before any device work
        t_header = _inner_frame_count(inner)
        if t_header is not None and mvs.shape[0] != t_header:
            raise ValueError(_MOTION_TABLE_ERROR)
    planes_blob, cinfo = _plane_inner(inner)
    if native.is_native(device):
        res = decode_video(planes_blob, device)  # checks the inner's CRC
        if cinfo is not None:
            res = color.fold_video_planes(res, *cinfo)
        frames = _fold_host(res, keyint, mvs, first_len)
        if crc and _crc(frames) != crc:
            raise ValueError(
                "reconstructed frames fail the MHVT source CRC-32 — corrupt "
                "container (the inner residual stream verified, so the "
                "wrapper header itself is suspect)")
        _verify_frame_crcs(frames, fcrcs)
        return frames
    planes = frame_stream.decode_container_device(planes_blob, device=device)
    if not crc:
        frame_stream.verify_source_crc32(
            planes.cpu().numpy(), frame_stream.source_crc32(planes_blob))
    frames = fold_planes(planes, keyint, mvs, first_len,
                         cinfo).cpu().numpy()
    if crc and _crc(frames) != crc:
        decode_video(planes_blob, device)  # raises on a corrupt inner
        raise ValueError(
            "reconstructed frames fail the MHVT source CRC-32 — corrupt "
            "container (the inner residual stream verified, so the wrapper "
            "header itself is suspect)")
    _verify_frame_crcs(frames, fcrcs)
    return frames


def decode_temporal_frame(blob: bytes, n: int, device="cuda") -> np.ndarray:
    """Frame ``n`` of an MHVT container: the residual frames from its
    keyframe through ``n`` decode and fold on ``device``
    (:func:`decode_temporal_range` of length 1)."""
    if n < 0:
        raise ValueError(f"frame {n} out of range")
    return decode_temporal_range(blob, n, n + 1, device)[0]


def _parse_temporal_range(blob: bytes):
    """Parse an MHVT container once for repeated range decodes: the wrapper
    fields and the pre-parsed inner (``frame_stream.
    parse_range_container``)."""
    inner, keyint, tcrc, mvs, fcrcs, first_len = unwrap(blob)
    planes_blob, cinfo = _plane_inner(inner)
    parsed = frame_stream.parse_range_container(planes_blob)
    total = _inner_frame_count(inner)
    return (keyint, tcrc, mvs, fcrcs, first_len, parsed, cinfo, total)


def decode_temporal_range(blob: bytes, a: int, b: int,
                          device="cuda") -> np.ndarray:
    """Frames [a, b) of an MHVT container: the residual frames from the
    keyframe before ``a`` through ``b-1`` decode on ``device`` (at most
    ``keyint - 1`` extra frames), fold there, and frames [a, b) are
    fetched, checked against the per-frame CRC table where there is
    one."""
    return _decode_temporal_range_parsed(_parse_temporal_range(blob), a, b,
                                         device)


def _decode_temporal_range_parsed(parts, a: int, b: int,
                                  device="cuda") -> np.ndarray:
    if not 0 <= a < b:
        raise ValueError(f"invalid frame range [{a}, {b})")
    keyint, _tcrc, mvs, fcrcs, first_len, parsed, cinfo, _total = parts
    kf = _group_start(a, keyint, first_len)
    # the span starts at a group boundary; it inherits the short first
    # group only when it starts at the very beginning of the stream
    span_fl = first_len if kf == 0 else None
    # native: the inner range is fetched (and checked against an inner
    # per-frame CRC table) and folds on the host, as in the JAX package
    host = native.is_native(device)
    if cinfo is not None:
        channels = cinfo[0]
        planes, _h, _w = frame_stream.decode_range_parsed(
            parsed, kf * channels, b * channels, to_host=host,
            device=device)
        fold = (color.fold_video_planes if host
                else color.fold_video_planes_torch)
        res = fold(planes, *cinfo)
    else:
        res, h, w = frame_stream.decode_range_parsed(
            parsed, kf, b, to_host=host, device=device)
        res = res.reshape(-1, h, w)
    if mvs is not None:
        if mvs.shape[0] < b:
            raise ValueError(
                "corrupt MHVT container (motion table shorter than the "
                "stream)")
        mvs = mvs[kf:b]
    if host:
        out = _fold_host(res, keyint, mvs, span_fl)[a - kf :]
    else:
        out = _fold(res, keyint, mvs, span_fl)[a - kf :].cpu().numpy()
    _verify_frame_crcs(out, fcrcs, base=a)
    return out


def iter_temporal_video(blob: bytes, device="cuda", chunk_frames: int = 32):
    """Yield (base, frames) chunks of an MHVT container in order, each
    decoded and folded on ``device``: chunks of at least ``chunk_frames``
    snapped up to keyframe boundaries, so no residual frame decodes twice.

    Each chunk is checked against the per-frame CRC table where there is
    one; the outer CRC is chained over the chunks and a mismatch raises
    ``ValueError`` after the last one.
    """
    parts = _parse_temporal_range(blob)  # the whole-container parse, once
    keyint, tcrc, _mvs, _fcrcs, first_len, _parsed, _cinfo, total = parts
    if total is None:
        raise ValueError("corrupt MHVT container (unrecognized inner stream)")
    crc = 0
    base = 0
    while base < total:
        end = min(base + max(int(chunk_frames), 1), total)
        if end < total:
            # snap up to the next group boundary (0, first_len,
            # first_len + keyint, ...)
            if end <= first_len:
                end = first_len
            else:
                end = first_len - ((first_len - end) // keyint) * keyint
            end = min(end, total)
        out = _decode_temporal_range_parsed(parts, base, end, device)
        crc = zlib.crc32(np.ascontiguousarray(out).tobytes(), crc)
        yield base, out
        base = end
    if tcrc and crc != tcrc:
        raise ValueError(
            "reconstructed frames fail the MHVT source CRC-32 — corrupt "
            "container")


def decode_temporal_video_region(blob: bytes, a: int, b: int, y0: int,
                                 x0: int, rh: int, rw: int,
                                 check: bool = False, *,
                                 device="cuda") -> np.ndarray:
    """The (rh, rw) crop at (y0, x0) of frames [a, b) of an MHVT video,
    reconstructed.

    The group fold is per pixel, so only the region's blocks of frames
    [keyframe(a), b) decode (on ``device``) and the crop folds on the host.
    Motion compensation rolls pixels across the crop's edge, so an MC
    container decodes the full frames of the range
    (:func:`decode_temporal_range`) and crops; its ``check=True`` needs the
    per-frame CRC table, since the end-bit check of the crop's blocks cannot
    cover that route, and is refused without one.
    """
    if not 0 <= a < b:
        raise ValueError(f"invalid frame range [{a}, {b})")
    inner, keyint, _crc_, mvs, fcrcs, first_len = unwrap(blob)
    if mvs is not None:
        if check and fcrcs is None:
            raise ValueError(
                "motion compensation rolls pixels across the crop "
                "boundary, so an MC region decodes via full-frame "
                "reconstruction — which the end-bit crop check cannot "
                "cover; a checked MC region needs the per-frame CRC "
                "table (encode with --frame-crcs)")
        out = decode_temporal_range(blob, a, b, device)
        if not (0 <= y0 and y0 + rh <= out.shape[1]
                and 0 <= x0 and x0 + rw <= out.shape[2]):
            raise ValueError("region out of bounds")
        return out[:, y0 : y0 + rh, x0 : x0 + rw]
    kf = _group_start(a, keyint, first_len)
    span_fl = first_len if kf == 0 else None
    if inner[:4] == color.COLOR_MAGIC:
        res = color.decode_color_video_region(
            inner, kf, b, y0, x0, rh, rw, check, device=device)
    else:
        res = frame_stream.decode_video_region(
            inner, kf, b, y0, x0, rh, rw, check=check, device=device)
    return temporal_decode(res, keyint, first_len=span_fl)[a - kf :]


def _describe_parts(keyint: int, crc: int, mvs, fcrcs, first_len: int,
                    flags: int) -> str:
    """The :func:`describe` line from already-unwrapped fields."""
    motion = ""
    if mvs is not None:
        moving = int((mvs != 0).any(axis=1).sum())
        motion = f", motion-compensated ({moving}/{mvs.shape[0]} frames move)"
    fc = f", per-frame CRCs ({fcrcs.shape[0]})" if fcrcs is not None else ""
    fl = (f", short first group ({first_len})"
          if first_len != keyint else "")
    layout = ", streamed (trailer) layout" if flags & FLAG_TRAILER else ""
    return (f"MHVT: temporal prediction, keyframe every {keyint}{fl}"
            f"{motion}{fc}{layout}, crc32={'recorded' if crc else 'absent'}")


def describe(blob: bytes) -> str:
    """One-line human description of the MHVT wrapper."""
    _, keyint, crc, mvs, fcrcs, first_len = unwrap(blob)
    flags = struct.unpack_from(_HEADER, blob, 4)[1]
    return _describe_parts(keyint, crc, mvs, fcrcs, first_len, flags)
