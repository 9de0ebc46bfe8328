"""Shared-table video decode: one canonical table, one kernel launch per batch.

Counterpart of the shared-table (MHTV) part of
``metalhuffman_tpu/models/frame_stream.py``. Encoding stays on the host and
shares the JAX package's codec (``core``, the C++ ``native`` encoder), so both
packages produce and consume the very same ``EncodedStream``; decode stages
the stream as tensors on an explicit device and runs
:func:`..ops.decode_cuda.decode_images` over all T frames at once.
"""

from __future__ import annotations

import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from metalhuffman_tpu import native
from metalhuffman_tpu.core import blocks, container, delta as delta_mod

from ..ops import decode_cuda
from .config import CodecConfig

SHARED_MAGIC = b"MHTV"
#: the packed-block kernel (other block sizes) is still to be ported
_BLOCK_DIM_TODO = ("block_dim != 8 decodes through the packed-block kernel, "
                   "still to port (ROADMAP.md queue A item 6)")


def host_backend() -> str:
    """Which host encoder the codec runs: ``"native"`` (the multithreaded
    C++ library), or ``"numpy (...)"`` with the build error when that library
    could not be built -- a fallback too slow and too memory-hungry for
    full-size batches."""
    return native.backend_name()


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
    bh: int  # block rows per frame
    bw: int  # block columns per frame
    words: torch.Tensor  # (n,) int32 big-endian code words + pad words
    offsets: torch.Tensor  # (T*bh*bw,) int32 block bit offsets (u32 bits)
    symbols: torch.Tensor  # (256,) uint8 canonical symbol order
    bounds: tuple  # (16,) interval bounds
    adj: tuple  # (16,) cumulative adj per code width
    #: (T, bh*bw) uint8 zero-init root bytes; None unless the stream has them
    init_grid: torch.Tensor | None = None


def prepare_shared(stream: container.EncodedStream, num_frames: int,
                   height: int, width: int, config: CodecConfig | None = None,
                   *, device) -> PreparedShared:
    """Stage a shared-table stream's decode inputs on ``device``."""
    cfg = config or CodecConfig()
    if cfg.block_dim != 8:
        raise NotImplementedError(_BLOCK_DIM_TODO)
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
    return PreparedShared(
        num_frames, height, width, bh, bw,
        torch.from_numpy(words).to(device),
        torch.from_numpy(offsets).to(device),
        torch.from_numpy(meta.symbols).to(device),
        meta.bounds, meta.adj, init_grid)


def decode_shared_step(prep: PreparedShared, config: CodecConfig | None = None,
                       raw: bool = False) -> torch.Tensor:
    """Decode a staged batch on its device.

    Returns a contiguous (T, H, W) uint8 tensor, or with ``raw=True`` the
    kernel's (T, bh*8, bw*8) output untouched (:func:`frames_from_raw` crops
    it as a view). Zero-init streams need the image form, which folds the
    root bytes in after the kernel.
    """
    cfg = config or CodecConfig()
    if cfg.block_dim != 8:
        raise NotImplementedError(_BLOCK_DIM_TODO)
    if raw and prep.init_grid is not None:
        raise ValueError(
            "raw output cannot carry the zero-init root fold; "
            "decode zero-init streams with raw=False")
    out = decode_cuda.decode_images(
        prep.words, prep.offsets, prep.symbols, prep.bounds, prep.adj,
        num_frames=prep.num_frames, bh=prep.bh, bw=prep.bw,
        delta=cfg.delta and not cfg.delta2d, delta2d=cfg.delta2d)
    if raw:
        return out
    if prep.init_grid is not None:
        # adding each block's root byte to the whole block (mod 256) equals
        # seeding the decoder's accumulator with it; done in place on the
        # fresh kernel output
        t, bh, bw = prep.num_frames, prep.bh, prep.bw
        out.view(t, bh, 8, bw, 8).add_(
            prep.init_grid.view(t, bh, 1, bw, 1))
    return out[:, : prep.height, : prep.width].contiguous()


def frames_from_raw(raw: torch.Tensor, num_frames: int, height: int,
                    width: int) -> torch.Tensor:
    """Raw (T, bh*8, bw*8) output -> (T, H, W) frames, as a view (no copy)."""
    return raw[:num_frames, :height, :width]


def decode_frames_shared(stream: container.EncodedStream, num_frames: int,
                         height: int, width: int,
                         config: CodecConfig | None = None, *,
                         device) -> torch.Tensor:
    """Decode a shared-table stream -> (T, H, W) uint8 tensor on ``device``."""
    prep = prepare_shared(stream, num_frames, height, width, config,
                          device=device)
    return decode_shared_step(prep, config)
