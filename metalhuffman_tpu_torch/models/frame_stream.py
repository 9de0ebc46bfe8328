"""Shared-table video decode: one canonical table, one kernel launch per batch.

Counterpart of the shared-table (MHTV) part of
``metalhuffman_tpu/models/frame_stream.py``. Encoding stays on the host (the
port's copy of the C++ encoder, byte-identical to the JAX package's), so both
packages produce and consume the very same ``EncodedStream``; decode stages
the stream as tensors on an explicit device and decodes all T frames in one
launch: :func:`..ops.decode_cuda.decode_images` for 8x8 blocks,
:func:`..ops.decode_cuda.decode_blocks` and a torch relayout for 2x2, 4x4 and
16x16.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core import blocks, container, delta as delta_mod
from ..ops import decode_cuda
from .config import CodecConfig

SHARED_MAGIC = b"MHTV"


def encode_frames_shared(
    frames: np.ndarray, config: CodecConfig | None = None
) -> container.EncodedStream:
    """(T, H, W) uint8 frames -> one EncodedStream with a shared table.

    Host code, byte-identical to the JAX package's encoder. With
    ``config.zero_init`` each block's root byte moves to the stream's
    uncoded ``block_init`` side array.
    """
    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    if (cfg.zero_init or cfg.delta2d) and not cfg.delta:
        raise ValueError("zero_init/delta2d require delta precoding")
    predictor = "2d" if cfg.delta2d else "left"
    payloads = []
    for f in frames:
        blk = blocks.image_to_blocks(f, cfg.block_dim).ravel()
        if cfg.delta2d:
            payloads.append(native.delta2d_encode(blk, cfg.block_dim))
        elif cfg.delta:
            payloads.append(native.delta_encode(blk, cfg.block_size))
        else:
            payloads.append(blk)
    payload = np.concatenate(payloads)
    init = None
    if cfg.zero_init:
        init, zeroed = delta_mod.split_zero_init(
            payload.reshape(-1, cfg.block_size))
        payload = zeroed.reshape(-1)
    stream = native.encode_symbols(payload, block_size=cfg.block_size)
    return container.EncodedStream(
        stream.num_symbols, stream.widths, stream.code_bytes,
        stream.block_offsets, block_init=init, predictor=predictor)


def _stream_mode(stream: container.EncodedStream, delta: bool) -> int:
    """Container mode byte: 0 = none, 1 = delta, 2 = delta + zero-init,
    3 = delta2d, 4 = delta2d + zero-init."""
    two_d = stream.predictor == "2d"
    if (two_d or stream.block_init is not None) and not delta:
        raise ValueError("zero-init/delta2d are delta precoding modes")
    if stream.block_init is None:
        return 3 if two_d else int(delta)
    if stream.block_init.size != stream.block_offsets.size:
        raise ValueError("block_init must have one byte per block")
    return 4 if two_d else 2


def write_shared(stream: container.EncodedStream, num_frames: int, height: int,
                 width: int, config: CodecConfig | None = None,
                 source_crc32: int = 0) -> bytes:
    """Serialize a shared-table frame sequence to the MHTV container.

    Layout: magic, (T, H, W, n_blocks) u32, block_dim u8, mode u8
    (:func:`_stream_mode`), core blob length u32 + core blob, the u32 block
    offsets, the zero-init root bytes (modes 2 and 4), and the CRC-32 of the
    source frame bytes as a u32 trailer (0 = unrecorded).
    """
    cfg = config or CodecConfig()
    mode = _stream_mode(stream, cfg.delta)
    head = SHARED_MAGIC + struct.pack(
        "<IIIIBB", num_frames, height, width, stream.block_offsets.size,
        cfg.block_dim, mode)
    core = stream.core_blob()
    tail = (b"" if mode not in (2, 4)
            else stream.block_init.astype(np.uint8).tobytes())
    return (head + struct.pack("<I", len(core)) + core
            + stream.block_offsets.astype("<u4").tobytes() + tail
            + struct.pack("<I", source_crc32 & 0xFFFFFFFF))


def read_shared(data: bytes):
    """Parse MHTV -> (stream, num_frames, height, width, block_dim, delta)."""
    if data[:4] != SHARED_MAGIC:
        raise ValueError("not an MHTV container")
    t, h, w, n_blocks, bd, mode = struct.unpack_from("<IIIIBB", data, 4)
    (core_len,) = struct.unpack_from("<I", data, 22)
    num_symbols, widths, code_bytes = container.parse_core_blob(
        data[26 : 26 + core_len])
    offsets = np.frombuffer(
        data, dtype="<u4", count=n_blocks, offset=26 + core_len
    ).astype(np.uint32)
    block_init = None
    if mode in (2, 4):
        block_init = np.frombuffer(
            data, dtype=np.uint8, count=n_blocks,
            offset=26 + core_len + 4 * n_blocks).copy()
    stream = container.EncodedStream(
        num_symbols, widths, code_bytes, offsets, block_init,
        predictor="2d" if mode in (3, 4) else "left")
    return stream, t, h, w, bd, bool(mode)


def source_crc32(data: bytes) -> int:
    """Recorded source CRC-32 of an MHTV container (0 = unrecorded)."""
    if data[:4] != SHARED_MAGIC:
        raise ValueError("not an MHTV container")
    _t, _h, _w, nb, _bd, mode = struct.unpack_from("<IIIIBB", data, 4)
    (core_len,) = struct.unpack_from("<I", data, 22)
    end = 26 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
    if len(data) >= end + 4:
        return struct.unpack_from("<I", data, end)[0]
    return 0


def verify_source_crc32(frames: np.ndarray, recorded: int) -> None:
    """Raise ValueError when decoded frames mismatch a recorded CRC-32."""
    if not recorded:
        return
    got = zlib.crc32(np.ascontiguousarray(frames).tobytes()) & 0xFFFFFFFF
    if got != recorded:
        raise ValueError(
            f"decoded payload CRC-32 mismatch (got {got:#010x}, container "
            f"records {recorded:#010x}) — the stream is corrupt")


@dataclass(frozen=True)
class PreparedShared:
    """A shared-table batch staged on one device (stage once, decode often)."""

    num_frames: int
    height: int
    width: int
    block_dim: int
    bh: int  # block rows per frame
    bw: int  # block columns per frame
    words: torch.Tensor  # (n,) int32 big-endian code words + pad words
    offsets: torch.Tensor  # (T*bh*bw,) int32 block bit offsets (u32 bits)
    symbols: torch.Tensor  # (256,) uint8 canonical symbol order
    bounds: tuple  # (16,) interval bounds
    adj: tuple  # (16,) cumulative adj per code width
    #: (T, bh*bw) uint8 zero-init root bytes; None unless the stream has them
    init_grid: torch.Tensor | None = None
    #: (T*bh*bw,) int32 expected row-local end bits in stream order (-1 =
    #: unchecked); staged only by ``prepare_shared(..., check=True)``
    end_targets: torch.Tensor | None = None
    #: byte-rounded (lo, hi) window for the LAST block's end bit (its exact
    #: end is not indexed); None when the stream has tail symbols
    last_window: tuple | None = None


def prepare_shared(stream: container.EncodedStream, num_frames: int,
                   height: int, width: int, config: CodecConfig | None = None,
                   *, device="cuda", check: bool = False) -> PreparedShared:
    """Stage a shared-table stream's decode inputs on ``device``; with
    ``check`` also the targets of :func:`decode_shared_step_checked`."""
    cfg = config or CodecConfig()
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    nb = num_frames * bh * bw
    if stream.block_offsets.size != nb:
        raise ValueError(
            f"stream has {stream.block_offsets.size} blocks, {num_frames} "
            f"frames of {height}x{width} need {nb}")
    meta, words, offsets = decode_cuda.prepare_stream(stream)
    init_grid = None
    if stream.block_init is not None:
        init_grid = torch.from_numpy(
            stream.block_init.astype(np.uint8).reshape(num_frames, bh * bw)
        ).to(device)
    end_targets = last_window = None
    if check:
        # the last block's exact end is only known up to byte rounding:
        # target -1 here, and the window below in decode_shared_step_checked
        end_targets = torch.from_numpy(
            decode_cuda.block_end_targets(stream.block_offsets, None)
        ).to(device)
        last_window = decode_cuda.last_block_window(stream, cfg.block_size)
    return PreparedShared(
        num_frames, height, width, cfg.block_dim, bh, bw,
        torch.from_numpy(words).to(device),
        torch.from_numpy(offsets).to(device),
        torch.from_numpy(meta.symbols).to(device),
        meta.bounds, meta.adj, init_grid, end_targets, last_window)


def _decode(prep: PreparedShared, cfg: CodecConfig, raw: bool,
            emit_end: bool):
    """One launch over the staged batch -> (result, end bits or None)."""
    if cfg.block_dim != prep.block_dim:
        raise ValueError(f"batch was staged for block_dim {prep.block_dim}, "
                         f"config has {cfg.block_dim}")
    # delta2d replaces the 1-D delta in the symbol chain
    kdelta = cfg.delta and not cfg.delta2d
    t, bh, bw, bd = prep.num_frames, prep.bh, prep.bw, prep.block_dim
    args = (prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj)
    end = None
    if bd == 8:
        if raw and prep.init_grid is not None:
            raise ValueError(
                "raw output cannot carry the zero-init root fold; "
                "decode zero-init streams with raw=False")
        out = decode_cuda.decode_images(
            *args, num_frames=t, bh=bh, bw=bw, delta=kdelta,
            delta2d=cfg.delta2d, emit_end=emit_end)
        if emit_end:
            out, end = out
        if raw:
            return out, end
        if prep.init_grid is not None:
            # adding each block's root byte to the whole block (mod 256)
            # equals seeding the decoder's accumulator with it; done in
            # place on the fresh kernel output
            out.view(t, bh, 8, bw, 8).add_(prep.init_grid.view(t, bh, 1, bw, 1))
        return out[:, : prep.height, : prep.width].contiguous(), end
    # other block sizes: the packed-block kernel, then a torch relayout
    blk = decode_cuda.decode_blocks(
        *args, num_steps=bd * bd, delta=kdelta, emit_end=emit_end)
    if emit_end:
        blk, end = blk
    if cfg.delta2d:  # the in-kernel 2-D reconstruction is 8x8-specific
        blk = delta_mod.delta2d_decode_blocks(blk, bd)
    if prep.init_grid is not None:
        blk.add_(prep.init_grid.view(-1, 1))  # the fold, on fresh blocks
    img = blocks.blocks_to_image_torch(
        blk.view(t, bh * bw, bd * bd), prep.height, prep.width, bd)
    return img.contiguous(), end


def decode_shared_step(prep: PreparedShared, config: CodecConfig | None = None,
                       raw: bool = False) -> torch.Tensor:
    """Decode a staged batch on its device.

    Returns a contiguous (T, H, W) uint8 tensor. With ``raw=True`` at 8x8
    blocks it returns the kernel's (T, bh*8, bw*8) output untouched
    (:func:`frames_from_raw` crops it as a view); zero-init streams need the
    image form, which folds the root bytes in after the kernel. Other block
    sizes have no raw form and always return the image form.
    """
    return _decode(prep, config or CodecConfig(), raw, emit_end=False)[0]


def decode_shared_step_checked(prep: PreparedShared,
                               config: CodecConfig | None = None,
                               raw: bool = False):
    """Decode + on-device integrity check of a staged batch.

    Requires ``prepare_shared(..., check=True)``. Returns ``(result,
    err_mask)``: ``result`` as :func:`decode_shared_step` gives it, and
    ``err_mask`` a stream-order (nb,) bool numpy array, True for a block that
    did not end at its indexed bit position (corrupt or truncated stream).
    The kernel stores one more int32 per block; the comparison runs on the
    device and only the mask comes back to the host.
    """
    if prep.end_targets is None:
        raise ValueError("prepare_shared(..., check=True) required")
    result, end = _decode(prep, config or CodecConfig(), raw, emit_end=True)
    err = decode_cuda.check_block_ends(end, prep.end_targets)
    if prep.last_window is not None and err.numel():
        # the last block's end is only indexed up to byte rounding: a
        # byte-rounded window replaces the unchecked -1 target
        lo, hi = prep.last_window
        err[-1] = (end[-1] < lo) | (end[-1] > hi)
    return result, err.cpu().numpy()


def frames_from_raw(raw: torch.Tensor, num_frames: int, height: int,
                    width: int) -> torch.Tensor:
    """Raw (T, bh*8, bw*8) output -> (T, H, W) frames, as a view (no copy)."""
    return raw[:num_frames, :height, :width]


def decode_frames_shared(stream: container.EncodedStream, num_frames: int,
                         height: int, width: int,
                         config: CodecConfig | None = None, *,
                         device="cuda") -> torch.Tensor:
    """Decode a shared-table stream -> (T, H, W) uint8 tensor on ``device``."""
    prep = prepare_shared(stream, num_frames, height, width, config,
                          device=device)
    return decode_shared_step(prep, config)
