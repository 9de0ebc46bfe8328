"""Video containers and their decode: one launch per shared-table batch.

Counterpart of ``metalhuffman_tpu/models/frame_stream.py``. Encoding stays on
the host (the port's copy of the C++ encoder, byte-identical to the JAX
package's), so both packages produce and consume the very same
``EncodedStream`` and containers; decode stages a stream as tensors on an
explicit device and decodes all its frames in one launch:
:func:`..ops.decode_cuda.decode_images` for 8x8 blocks,
:func:`..ops.decode_cuda.decode_blocks` and a torch relayout for every other
block size a container records, 1x1 to 255x255.

- MHTV: one shared-table stream (``write_shared``, ``read_shared``), with the
  source CRC-32 trailer and the optional per-frame CRC table (FCRC).
- MHV2: segments of whole frames, each a shared-table stream of its own that
  fits u32 block offsets (``encode_frames_segmented``, ``write_segmented``,
  ``read_segmented``), decoded two segments in flight
  (``StreamingDecoder``, ``iter_frames_segmented``).
- Random access through the offset index: ``frame_slice``,
  ``decode_frame``, ``decode_range`` and the spatio-temporal
  ``decode_video_region``.
- MHTS: one MHT1 record, and so one table, per frame (``write_stream``,
  ``read_stream``, ``iter_stream_frames``); ``decode_batch`` launches the
  kernel once per frame, each with its frame's code, into one output.
- Multi-GPU decode over a process group (``decode_shared_sharded`` with
  ``gather_shared``, ``decode_batch_sharded``): each rank decodes a
  contiguous range, then one all-gather (``parallel.shard_decode``).

Every decode takes ``device`` (default ``"cuda"``) in place of the JAX
package's ``backend``: CUDA tensors run the kernels, CPU tensors their plain
versions, and ``device="native"`` the host C++ decoder
(``native.decode_blocks``, multithreaded over block ranges; the JAX
package's ``backend="native"``). A native decode stages nothing
(:class:`PreparedNative`) and returns CPU tensors where the device routes
return tensors on their device. The end-bit check is an output of the
kernels, so the checked decodes refuse ``native``, as the JAX package's do;
the region decode checks its blocks by re-encoding them instead.
"""

from __future__ import annotations

import dataclasses
import struct
import zlib
from dataclasses import dataclass

import numpy as np
import torch

from .. import native
from ..core import blocks, container, delta as delta_mod
from ..ops import crc_cuda, decode_cuda
from ..parallel import mesh as mesh_mod, shard_decode
from ..utils.profiling import mark, span
from .config import CodecConfig

SHARED_MAGIC = b"MHTV"
SEGMENTED_MAGIC = b"MHV2"
STREAM_MAGIC = b"MHTS"
FRAME_CRC_MAGIC = b"FCRC"


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
                 source_crc32: int = 0, frame_crcs=None) -> bytes:
    """Serialize a shared-table frame sequence to the MHTV container.

    Layout: magic, (T, H, W, n_blocks) u32, block_dim u8, mode u8
    (:func:`_stream_mode`), core blob length u32 + core blob, the u32 block
    offsets, the zero-init root bytes (modes 2 and 4), the CRC-32 of the
    source frame bytes as a u32 trailer (0 = unrecorded), then the optional
    per-frame CRC table (:func:`_frame_crc_blob`).
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
            + struct.pack("<I", source_crc32 & 0xFFFFFFFF)
            + _frame_crc_blob(frame_crcs))


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


def _trailer_offset(data: bytes) -> int:
    """Byte offset of the source-CRC trailer of an MHTV/MHV2 container."""
    if data[:4] == SHARED_MAGIC:
        _t, _h, _w, nb, _bd, mode = struct.unpack_from("<IIIIBB", data, 4)
        (core_len,) = struct.unpack_from("<I", data, 22)
        return 26 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
    if data[:4] == SEGMENTED_MAGIC:
        _t, _h, _w, _bd, mode, n_seg = struct.unpack_from("<IIIBBI", data, 4)
        end = 4 + 18
        for _ in range(n_seg):
            _ft, nb, core_len = struct.unpack_from("<III", data, end)
            end += 12 + core_len + 4 * nb + (nb if mode in (2, 4) else 0)
        return end
    raise ValueError("not an MHTV/MHV2 container")


def source_crc32(data: bytes) -> int:
    """Recorded source CRC-32 of an MHTV/MHV2 container (0 = unrecorded;
    a container cut before its trailer reads as unrecorded)."""
    end = _trailer_offset(data)
    if len(data) >= end + 4:
        return struct.unpack_from("<I", data, end)[0]
    return 0


def _frame_crc_blob(frame_crcs) -> bytes:
    """Serialize the optional per-frame CRC extension (after the trailer):
    ``FCRC``, the frame count u32, one u32 CRC-32 per frame."""
    if frame_crcs is None:
        return b""
    fc = np.asarray(frame_crcs, np.uint32).reshape(-1)
    return (FRAME_CRC_MAGIC + struct.pack("<I", fc.shape[0])
            + fc.astype("<u4").tobytes())


def read_frame_crcs(data: bytes):
    """Per-frame CRC-32 table of an MHTV/MHV2 container, or None.

    The extension sits after the source-CRC trailer, where readers that
    predate it never look; with it, random access (``decode_range``)
    verifies exactly the frames it returns.
    """
    pos = _trailer_offset(data) + 4
    if len(data) < pos + 8 or data[pos : pos + 4] != FRAME_CRC_MAGIC:
        return None
    (t,) = struct.unpack_from("<I", data, pos + 4)
    if len(data) < pos + 8 + 4 * t:
        raise ValueError("truncated FCRC extension (table incomplete)")
    return np.frombuffer(data, dtype="<u4", count=t, offset=pos + 8).copy()


def compute_frame_crcs(frames) -> np.ndarray:
    """(T,) uint32 per-frame CRC-32 table of a frame stack (the recipe of
    every writer, so tables written by either package verify on both)."""
    return np.array([zlib.crc32(np.ascontiguousarray(f).tobytes())
                     for f in frames], np.uint32)


def verify_frame_crcs(frames, fcrcs, base: int = 0, crcs=None) -> None:
    """Check frames [base, base+len) against a per-frame CRC table (None
    passes). ``crcs``: the frames' CRC-32s where the caller has them
    (computed on the card by ``crc_cuda.frame_crcs``), else zlib hashes
    each frame here."""
    if fcrcs is None:
        return
    if fcrcs.shape[0] < base + len(frames):
        raise ValueError(
            "corrupt container (frame CRC table shorter than the stream)")
    for i, f in enumerate(frames):
        got = (zlib.crc32(np.ascontiguousarray(f).tobytes()) & 0xFFFFFFFF
               if crcs is None else int(crcs[i]))
        if got != int(fcrcs[base + i]):
            raise ValueError(
                f"decoded frame {base + i} fails its recorded CRC-32 — "
                "the stream is corrupt")


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
    #: (n,) int32 big-endian code words the blocks reach, + pad words
    words: torch.Tensor
    #: (T*bh*bw,) int32 block bit offsets into ``words`` (u32 bits)
    offsets: torch.Tensor
    #: the stream's code, the interval table and the kernels' lookup table
    code: decode_cuda.Code
    #: (T, bh*bw) uint8 zero-init root bytes; None unless the stream has them
    init_grid: torch.Tensor | None = None
    #: (T*bh*bw,) int32 expected row-local end bits in stream order (-1 =
    #: unchecked); staged only by ``prepare_shared(..., check=True)``
    end_targets: torch.Tensor | None = None
    #: byte-rounded (lo, hi) window for the LAST block's end bit (its exact
    #: end is not indexed); None when the stream has tail symbols
    last_window: tuple | None = None


@dataclass(frozen=True)
class PreparedNative:
    """A shared-table batch for the host C++ decoder (``device="native"``):
    nothing is staged, the stream stays on the host."""

    stream: container.EncodedStream
    num_frames: int
    height: int
    width: int
    block_dim: int


#: the refusal of a checked decode on ``device="native"``
NATIVE_CHECK_ERROR = ("the stream-integrity check runs on the device decode "
                      "path; use device='cuda'")


def prepare_shared(stream: container.EncodedStream, num_frames: int,
                   height: int, width: int, config: CodecConfig | None = None,
                   *, device="cuda",
                   check: bool = False) -> PreparedShared | PreparedNative:
    """Stage a shared-table stream's decode inputs on ``device``: the code
    words its blocks reach (all of them for a whole stream, a frame range's
    own for a :func:`frame_slice` view), the offsets and the code
    (``decode_cuda.stage_code``); with ``check`` also the targets of
    :func:`decode_shared_step_checked`.
    ``device="native"`` stages nothing and refuses ``check``."""
    cfg = config or CodecConfig()
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    nb = num_frames * bh * bw
    if stream.block_offsets.size != nb:
        raise ValueError(
            f"stream has {stream.block_offsets.size} blocks, {num_frames} "
            f"frames of {height}x{width} need {nb}")
    if native.is_native(device):
        if check:
            raise ValueError(NATIVE_CHECK_ERROR)
        return PreparedNative(stream, num_frames, height, width,
                              cfg.block_dim)
    window, base = decode_cuda.code_window(stream, cfg.block_size)
    words, _ = decode_cuda.stage_words([window], device)
    # the offsets go up as they are and are rebased to the window there (u32
    # bits in int32, so the subtraction wraps as u32 does): no host pass
    offsets = torch.from_numpy(np.asarray(
        stream.block_offsets, dtype=np.uint32).view(np.int32)).to(device) - (
            base - (1 << 32) if base >= 1 << 31 else base)
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
        num_frames, height, width, cfg.block_dim, bh, bw, words, offsets,
        decode_cuda.stage_code(stream.widths, device), init_grid, end_targets,
        last_window)


def _decode_native(prep: PreparedNative, cfg: CodecConfig) -> np.ndarray:
    """The host C++ decode of a batch -> contiguous (T, H, W) uint8: every
    block decoded with its precoder undone, the zero-init roots added, then
    the blocks laid out as frames."""
    stream, t, bd = prep.stream, prep.num_frames, prep.block_dim
    blk = native.decode_blocks(
        stream, delta=cfg.delta and not cfg.delta2d,
        block_size=cfg.block_size, delta2d=cfg.delta2d)
    if stream.block_init is not None:
        blk = delta_mod.apply_block_init(blk, stream.block_init)
    bh, bw = blocks.block_grid(prep.height, prep.width, bd)
    img = blk.reshape(t, bh, bw, bd, bd).transpose(0, 1, 3, 2, 4).reshape(
        t, bh * bd, bw * bd)
    return np.ascontiguousarray(img[:, : prep.height, : prep.width])


def _images(cfg: CodecConfig, grid: tuple[int, int, int]):
    """The grid of (frames, block rows, block columns) that B1 writes a
    launch's blocks on at their image positions, or None where B2 decodes
    them: B1 takes 8x8 blocks, B2 every other size."""
    return grid if cfg.block_dim == 8 else None


def _precoder(cfg: CodecConfig) -> tuple[bool, bool]:
    """The (delta, delta2d) that a decode kernel undoes under ``cfg``:
    delta2d replaces the 1-D delta in the symbol chain, and the kernels
    reconstruct it at 8x8 only (:func:`launch_frames` runs it after B2 at
    other sizes)."""
    return cfg.delta and not cfg.delta2d, cfg.delta2d and cfg.block_dim == 8


def launch_staged(words: torch.Tensor, offsets: torch.Tensor,
                  code: decode_cuda.Code, cfg: CodecConfig, images=None, *,
                  emit_end: bool = False, out: torch.Tensor | None = None):
    """One decode launch over staged blocks: B1 into (T, bh*8, bw*8) images
    on ``images`` (:func:`_images`), else B2 into (nb, block_size) blocks in
    the order of ``offsets``; with ``emit_end`` also the end bits. ``out``,
    a contiguous uint8 tensor of the output's size in any shape, takes the
    output."""
    delta, delta2d = _precoder(cfg)
    if images is not None:
        t, bh, bw = images
        return decode_cuda.decode_images(
            words, offsets, code, num_frames=t, bh=bh, bw=bw, delta=delta,
            delta2d=delta2d, emit_end=emit_end,
            out=None if out is None else out.view(t, bh * 8, bw * 8))
    return decode_cuda.decode_blocks(
        words, offsets, code, num_steps=cfg.block_size, delta=delta,
        delta2d=delta2d, emit_end=emit_end,
        out=None if out is None else out.view(-1, cfg.block_size))


def launch_frames(out: torch.Tensor, cfg: CodecConfig, images, size=None,
                  init: torch.Tensor | None = None) -> torch.Tensor:
    """:func:`launch_staged`'s output on ``images`` -> frames: the delta2d
    post-pass after B2 off 8x8, the fold of the zero-init root bytes
    ``init`` (one a block, in the kernel's block order) on B1's (T, bh*8,
    bw*8) images or on B2's blocks (a contiguous tensor of them, in any
    shape), then with ``size`` = (T, H, W) the images cropped or the blocks
    laid out as frames, a view. Without ``size`` the blocks come back in
    ``out``'s shape."""
    if images is not None:
        if init is not None:
            # adding each block's root byte to the whole block (mod 256)
            # equals seeding the decoder's accumulator with it; done in
            # place on the fresh kernel output
            t, bh, bw = images
            out.view(t, bh, 8, bw, 8).add_(init.view(t, bh, 1, bw, 1))
        return out if size is None else out[:, : size[1], : size[2]]
    bd, bs = cfg.block_dim, cfg.block_size
    if cfg.delta2d and bd != 8:
        out = delta_mod.delta2d_decode_blocks(out.view(-1, bs), bd).view(
            out.shape)
    if init is not None:
        out.view(-1, bs).add_(init.reshape(-1, 1))  # the fold, on fresh blocks
    if size is None:
        return out
    t, h, w = size
    return blocks.blocks_to_image_torch(out.view(t, -1, bs), h, w, bd)


def _decode(prep: PreparedShared | PreparedNative, cfg: CodecConfig,
            raw: bool, emit_end: bool):
    """One launch over the staged batch -> (result, end bits or None)."""
    if cfg.block_dim != prep.block_dim:
        raise ValueError(f"batch was staged for block_dim {prep.block_dim}, "
                         f"config has {cfg.block_dim}")
    if isinstance(prep, PreparedNative):
        return torch.from_numpy(_decode_native(prep, cfg)), None
    t = prep.num_frames
    images = _images(cfg, (t, prep.bh, prep.bw))
    if images is not None and raw and prep.init_grid is not None:
        raise ValueError(
            "raw output cannot carry the zero-init root fold; "
            "decode zero-init streams with raw=False")
    if images is None:
        mark("blocks")
    out = launch_staged(prep.words, prep.offsets, prep.code, cfg, images,
                        emit_end=emit_end)
    end = None
    if emit_end:
        out, end = out
    if images is not None and raw:
        return out, end
    return launch_frames(out, cfg, images, (t, prep.height, prep.width),
                         prep.init_grid).contiguous(), end


def decode_shared_step(prep: PreparedShared, config: CodecConfig | None = None,
                       raw: bool = False) -> torch.Tensor:
    """Decode a staged batch on its device.

    Returns a contiguous (T, H, W) uint8 tensor. With ``raw=True`` at 8x8
    blocks it returns the kernel's (T, bh*8, bw*8) output untouched
    (:func:`frames_from_raw` crops it as a view); zero-init streams need the
    image form, which folds the root bytes in after the kernel. Other block
    sizes, and a :class:`PreparedNative` batch (a CPU tensor), have no raw
    form and always return the image form. At other block sizes that form
    is a fresh tensor of each call (the relayout's copy of the kernel's
    fresh blocks), never a view of staged or earlier memory, so a caller may
    keep the answers of many calls.
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
    if not isinstance(prep, PreparedShared) or prep.end_targets is None:
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


# -- segmented shared-table video (MHV2) --------------------------------------
#
# u32 block bit offsets cap one shared stream at 2^32 bits. Longer sequences
# split into segments of whole frames, each a shared-table stream with its own
# table and offset index, decoded with two segments in flight.

#: per-symbol bit bound used to pick segment frame counts: Huffman expected
#: length <= H + 1 <= 9 for 8-bit symbols; 10 adds headroom for the 16-bit
#: length-limit penalty. The encoder's exact u32 check still guards.
_SEG_BITS_PER_SYMBOL = 10


def segment_frame_counts(num_frames: int, frame_symbols: int,
                         max_segment_bits: int = (1 << 32) - 1024) -> list[int]:
    """Frames per segment so each segment's bits provably fit u32 offsets."""
    per = max(1, int(max_segment_bits // (frame_symbols * _SEG_BITS_PER_SYMBOL)))
    counts = []
    left = num_frames
    while left > 0:
        take = min(per, left)
        counts.append(take)
        left -= take
    return counts


def encode_frames_segmented(
    frames: np.ndarray, config: CodecConfig | None = None,
    max_segment_bits: int = (1 << 32) - 1024,
) -> list[tuple[container.EncodedStream, int]]:
    """(T, H, W) frames -> [(EncodedStream, frames_in_segment), ...].

    Splits at whole-frame boundaries so every segment decodes on its own. A
    segment that still overflows the encoder's exact u32 check (the
    ``ValueError`` of ``native.encode_symbols``) is halved and encoded again.
    """
    cfg = config or CodecConfig()
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    t, h, w = frames.shape
    if t == 0 or h == 0 or w == 0:
        raise ValueError("cannot encode an empty frame stack")
    if cfg.zero_init and not cfg.delta:
        # validated here: the halving below must only ever see the
        # encoder's u32-overflow ValueError
        raise ValueError("zero_init requires delta precoding")
    bh, bw = blocks.block_grid(h, w, cfg.block_dim)
    pending = segment_frame_counts(t, bh * bw * cfg.block_size,
                                   max_segment_bits)
    segments: list[tuple[container.EncodedStream, int]] = []
    start = 0
    while pending:
        take = pending.pop(0)
        try:
            stream = encode_frames_shared(frames[start : start + take], cfg)
        except ValueError:
            if take == 1:
                raise  # one frame over 2^32 bits: nothing to split
            pending[0:0] = [take // 2, take - take // 2]
            continue
        segments.append((stream, take))
        start += take
    return segments


def write_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, source_crc32: int = 0,
    frame_crcs=None,
) -> bytes:
    """Serialize segments to the MHV2 container.

    Layout: magic, (T, H, W) u32, block_dim u8, mode u8, the segment count
    u32; per segment its frame count, block count and core blob length
    (u32 each), the core blob, the u32 offsets and (modes 2 and 4) the
    zero-init root bytes; then the source CRC-32 trailer and the optional
    per-frame CRC table. All segments share one mode.
    """
    cfg = config or CodecConfig()
    if not segments:
        raise ValueError("cannot serialize an empty segment list")
    modes = {_stream_mode(s, cfg.delta) for s, _ in segments}
    if len(modes) != 1:
        raise ValueError("MHV2 segments must share one delta/zero-init mode")
    mode = modes.pop()
    total_frames = sum(t for _, t in segments)
    out = [SEGMENTED_MAGIC, struct.pack(
        "<IIIBBI", total_frames, height, width, cfg.block_dim, mode,
        len(segments))]
    for stream, t in segments:
        core = stream.core_blob()
        out.append(struct.pack("<III", t, stream.block_offsets.size, len(core)))
        out.append(core)
        out.append(stream.block_offsets.astype("<u4").tobytes())
        if mode in (2, 4):
            out.append(stream.block_init.astype(np.uint8).tobytes())
    out.append(struct.pack("<I", source_crc32 & 0xFFFFFFFF))
    out.append(_frame_crc_blob(frame_crcs))
    return b"".join(out)


def read_segmented(data: bytes):
    """Parse MHV2 -> (segments [(stream, t)], total_frames, h, w, bd, delta).

    A cut blob raises what the JAX package's reader raises (``struct.error``
    in a segment header, ``ValueError`` in a core blob, an offset index or
    the root bytes).
    """
    if data[:4] != SEGMENTED_MAGIC:
        raise ValueError("not an MHV2 container")
    total, h, w, bd, mode, n_seg = struct.unpack_from("<IIIBBI", data, 4)
    pos = 4 + 18
    segments = []
    for _ in range(n_seg):
        t, n_blocks, core_len = struct.unpack_from("<III", data, pos)
        pos += 12
        num_symbols, widths, code_bytes = container.parse_core_blob(
            data[pos : pos + core_len])
        pos += core_len
        offsets = np.frombuffer(
            data, dtype="<u4", count=n_blocks, offset=pos).astype(np.uint32)
        pos += 4 * n_blocks
        block_init = None
        if mode in (2, 4):
            block_init = np.frombuffer(
                data, dtype=np.uint8, count=n_blocks, offset=pos).copy()
            pos += n_blocks
        segments.append((container.EncodedStream(
            num_symbols, widths, code_bytes, offsets, block_init,
            predictor="2d" if mode in (3, 4) else "left"), t))
    if sum(t for _, t in segments) != total:
        raise ValueError("MHV2 segment frame counts do not sum to the header")
    return segments, total, h, w, bd, bool(mode)


def _empty_frames(height: int, width: int) -> np.ndarray:
    return np.zeros((0, height, width), np.uint8)


def decode_frames_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, check: bool = False, *,
    device="cuda",
) -> np.ndarray:
    """Decode a segment list on ``device`` -> (T, H, W) uint8 numpy frames.

    Without ``check`` the segments go through :func:`iter_frames_segmented`
    (two in flight). With ``check`` each segment runs the end-bit integrity
    check, one at a time (the mask's fetch is a barrier), and a ValueError
    names the first corrupt segment and its blocks.
    """
    cfg = config or CodecConfig()
    if not check:
        outs = list(iter_frames_segmented(segments, height, width, cfg,
                                          device=device))
        return np.concatenate(outs) if outs else _empty_frames(height, width)
    outs = []
    for si, frames, err in iter_frames_segmented_checked(
            segments, height, width, cfg, device=device):
        if err.any():
            idx = np.nonzero(err)[0]
            raise ValueError(
                f"stream integrity check failed in segment {si}: "
                f"{idx.size} corrupt block(s), first at {idx[:8].tolist()}")
        outs.append(frames)
    return np.concatenate(outs) if outs else _empty_frames(height, width)


def iter_frames_segmented_checked(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, *, device="cuda",
):
    """Checked decode, segment by segment: yield ``(segment_index, frames,
    err)``, numpy (t, H, W) uint8 frames and the segment's stream-order
    (nb,) bool mask of :func:`decode_shared_step_checked`. The caller
    decides whether a flagged segment fails or is salvaged
    (:func:`salvage_blocks`). ``device="native"`` is refused: the check is
    an output of the kernels."""
    if native.is_native(device):
        raise ValueError(NATIVE_CHECK_ERROR)
    cfg = config or CodecConfig()
    for si, (stream, t) in enumerate(segments):
        prep = prepare_shared(stream, t, height, width, cfg, device=device,
                              check=True)
        frames, err = decode_shared_step_checked(prep, cfg)
        yield si, frames.cpu().numpy(), err


def iter_frames_segmented(
    segments: list[tuple[container.EncodedStream, int]], height: int,
    width: int, config: CodecConfig | None = None, *, device="cuda",
):
    """Yield each segment's decoded (t, H, W) uint8 numpy frames, in order.

    A consumer that writes each chunk out and drops it holds one segment of
    frames at a time. Segment k+1 is staged and its launch queued before
    segment k's frames are fetched, so at most two segments are in flight.
    """
    dec = StreamingDecoder(config, device=device)
    handles = []
    for stream, t in segments:
        handles.append(dec.submit(stream, t, height, width))
        if len(handles) >= 2:  # keep at most two segments in flight
            yield dec.result(handles.pop(0))
    while handles:
        yield dec.result(handles.pop(0))


class StreamingDecoder:
    """Pipelined batch decode: ``submit`` stages a batch and queues its
    launch, ``result`` blocks on that batch alone.

    The launch is asynchronous; the staging copies are from pageable host
    memory, so ``submit`` returns once they are done. Typical loop::

        dec = StreamingDecoder(cfg)
        handles = [dec.submit(s, T, H, W) for s in first_two_batches]
        for next_stream in rest:
            frames = dec.result(handles.pop(0))
            handles.append(dec.submit(next_stream, T, H, W))
    """

    def __init__(self, config: CodecConfig | None = None, *, device="cuda"):
        self.config = config or CodecConfig()
        self.device = device

    def submit(self, stream: container.EncodedStream, num_frames: int,
               height: int, width: int):
        """Stage a batch and queue its decode; returns an opaque handle."""
        prep = prepare_shared(stream, num_frames, height, width, self.config,
                              device=self.device)
        # the raw 8x8 output skips the crop copy, but cannot carry the
        # zero-init root fold: zero-init batches take the image form (other
        # sizes have only it, which frames_from_raw leaves as it is)
        raw = isinstance(prep, PreparedShared) and prep.init_grid is None
        return prep, decode_shared_step(prep, self.config, raw=raw), raw

    def result(self, handle) -> np.ndarray:
        """Block on one submitted batch -> (T, H, W) uint8 numpy frames."""
        prep, out, raw = handle
        if raw:
            out = frames_from_raw(out, prep.num_frames, prep.height,
                                  prep.width)
        return out.cpu().numpy()


# -- random access ------------------------------------------------------------

def frame_slice(
    stream: container.EncodedStream, t0: int, num: int, height: int,
    width: int, config: CodecConfig | None = None,
) -> container.EncodedStream:
    """View of frames [t0, t0+num) of a shared-table stream, zero copy.

    The view shares ``code_bytes`` and the table and carries only the
    selected frames' u32 block offsets (and root bytes), so any decode
    treats it as an ordinary ``num``-frame stream; ``prepare_shared`` then
    stages only the words those blocks reach.
    """
    cfg = config or CodecConfig()
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    per = bh * bw
    total = stream.block_offsets.size // per
    if not (0 <= t0 and t0 + num <= total):
        raise ValueError(
            f"frames [{t0}, {t0 + num}) out of range (stream has {total})")
    sel = slice(t0 * per, (t0 + num) * per)
    init = None if stream.block_init is None else stream.block_init[sel]
    return container.EncodedStream(
        num * per * cfg.block_size, stream.widths, stream.code_bytes,
        stream.block_offsets[sel], init, predictor=stream.predictor)


def decode_frame(
    stream: container.EncodedStream, t: int, height: int, width: int,
    config: CodecConfig | None = None, *, device="cuda",
) -> np.ndarray:
    """Decode one frame of a shared-table stream on ``device`` -> (H, W)
    uint8 numpy image; only that frame's blocks are staged and decoded."""
    cfg = config or CodecConfig()
    view = frame_slice(stream, t, 1, height, width, cfg)
    return decode_frames_shared(view, 1, height, width, cfg,
                                device=device).cpu().numpy()[0]


def _container_config(config: CodecConfig | None, block_dim: int,
                      delta: bool, predictor: str) -> CodecConfig:
    """The header's block_dim and precoder over the caller's config."""
    return dataclasses.replace(config or CodecConfig(), block_dim=block_dim,
                               delta=delta, delta2d=predictor == "2d")


def read_video(data: bytes, config: CodecConfig | None = None):
    """Parse an MHTV or MHV2 container -> (segments [(stream, t)], frames,
    height, width, config): an MHTV is one segment, and ``config`` is the
    header's block_dim and precoder over the caller's ``config``."""
    if data[:4] == SHARED_MAGIC:
        stream, t, h, w, bd, delta = read_shared(data)
        segs = [(stream, t)]
    elif data[:4] == SEGMENTED_MAGIC:
        segs, t, h, w, bd, delta = read_segmented(data)
    else:
        raise ValueError("not an MHTV/MHV2 container")
    return segs, t, h, w, _container_config(config, bd, delta,
                                            segs[0][0].predictor)


def parse_range_container(data: bytes):
    """Parse an MHTV/MHV2/MHTS/MHVT blob once for repeated range decodes;
    returns an opaque handle for :func:`decode_range_parsed`. An MHVT's
    handle holds its wrapper's fields and its parsed inner
    (``temporal._parse_temporal_range``)."""
    from . import temporal

    if data[:4] == temporal.TEMPORAL_MAGIC:
        return ("temporal", temporal._parse_temporal_range(data), None)
    if data[:4] == STREAM_MAGIC:
        return ("stream", read_stream(data), read_stream_crcs(data))
    if data[:4] not in (SHARED_MAGIC, SEGMENTED_MAGIC):
        raise ValueError("not an MHTV/MHV2/MHTS/MHVT container")
    return ("segments", read_video(data), read_frame_crcs(data))


def decode_range(data: bytes, a: int, b: int,
                 config: CodecConfig | None = None, to_host: bool = True, *,
                 device="cuda"):
    """Decode frames [a, b) of an MHTV/MHV2/MHTS/MHVT container on
    ``device`` -> (frames, h, w).

    Only those frames' blocks are decoded (:func:`frame_slice`), and an MHV2
    range may straddle segments, each with its own table. The header fixes
    block_dim and precoder. ``frames`` is a (b-a, H, W) uint8 numpy array,
    checked against the per-frame CRC table where the container records
    one: on a CUDA device the card computes the CRC-32 of the decoded frames
    before the fetch (one launch of ``crc_cuda.frame_crcs``, one a frame of
    MHTS) and the host compares the integers; CPU tensors and ``native``
    hash the fetched frames with zlib. With ``to_host=False`` it is the
    tensor on ``device`` (segments joined by ``torch.cat``), unchecked, for
    a caller that goes on with device work before one fetch.

    An MHVT decodes its residual frames from the keyframe before ``a`` and
    folds them (``temporal._decode_temporal_range_parsed``): the frames are
    those of its inner, (b-a, H, W[, C]) uint8 or (b-a, H, W) uint16, and
    ``config``, if given, must restate the wrapper's keyframe interval and
    motion flag.
    """
    return decode_range_parsed(parse_range_container(data), a, b, config,
                               to_host, device=device)


def decode_range_parsed(parsed, a: int, b: int,
                        config: CodecConfig | None = None,
                        to_host: bool = True, *, device="cuda"):
    """:func:`decode_range` on a :func:`parse_range_container` handle.

    Under a profiler each decode marks ``range.stage``
    (:func:`prepare_shared`) and ``range.decode`` (the launch and the crop;
    on a CUDA device, with ``to_host`` and a recorded CRC, the launch of
    ``crc_cuda.frame_crcs`` over the very frames fetched), then with
    ``to_host`` ``range.fetch`` (the wait on the device and the copy of the
    frames, and of their CRC-32s where the card computed them, to the host),
    and spans ``range.crc`` (the per-frame CRC-32 check, host work alone:
    a comparison of integers after the card's CRC, zlib's hash of each frame
    after any other decode): once a request, or once a frame in an MHTS
    container. An MHVT request marks ``fold`` between ``range.decode`` and
    ``range.fetch``."""
    kind, payload, fcrcs = parsed
    if kind == "temporal":
        from . import temporal

        frames = temporal._decode_temporal_range_parsed(
            payload, a, b, device, to_host=to_host, config=config)
        return frames, frames.shape[1], frames.shape[2]
    if kind == "stream":
        # one table per frame: a range is a loop of one-frame decodes, each
        # checked against its MHT1 record's CRC where one is recorded
        streams, h, w, bd, delta = payload
        if not 0 <= a < b <= len(streams):
            raise ValueError(
                f"frames [{a}, {b}) out of range ({len(streams)} frames)")
        outs = []
        for i in range(a, b):
            scfg = _container_config(config, bd, delta, streams[i].predictor)
            mark("range.stage")
            prep = prepare_shared(streams[i], 1, h, w, scfg, device=device)
            mark("range.decode")
            one = decode_shared_step(prep, scfg)
            img = one[0]
            if to_host:
                crc = (crc_cuda.frame_crcs(one)
                       if fcrcs[i] and crc_cuda.is_card(one) else None)
                mark("range.fetch")
                img = img.cpu().numpy()
                if crc is not None:
                    crc = int(crc.cpu().numpy()[0])
                with span("range.crc"):
                    if fcrcs[i] and (zlib.crc32(img.tobytes()) if crc is None
                                     else crc) != fcrcs[i]:
                        raise ValueError(
                            f"decoded frame {i} fails its recorded CRC-32 — "
                            "the stream is corrupt")
            outs.append(img)
        return (np.stack(outs) if to_host else torch.stack(outs)), h, w
    segs, t, h, w, cfg = payload
    if not 0 <= a < b <= t:
        raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
    if not native.is_native(device) and torch.device(device).type == "cuda":
        _pin_segments(segs)
    if config is not None:
        cfg = _container_config(config, cfg.block_dim, cfg.delta,
                                segs[0][0].predictor)
    outs, base = [], 0
    for stream, ft in segs:  # a range may straddle segments
        lo, hi = max(a, base), min(b, base + ft)
        if lo < hi:
            view = frame_slice(stream, lo - base, hi - lo, h, w, cfg)
            mark("range.stage")
            prep = prepare_shared(view, hi - lo, h, w, cfg, device=device)
            mark("range.decode")
            outs.append(decode_shared_step(prep, cfg))
        base += ft
    frames = outs[0] if len(outs) == 1 else torch.cat(outs)
    if not to_host:
        return frames, h, w
    return fetch_checked(frames, fcrcs, a), h, w


def _pinned(a: np.ndarray) -> np.ndarray:
    """A copy of ``a`` in page-locked host memory (torch's pinned host
    cache), as numpy: the memory lives as long as the array."""
    a = np.ascontiguousarray(a)
    raw = torch.from_numpy(a.view(np.uint8).reshape(-1)).pin_memory()
    return raw.numpy().view(a.dtype).reshape(a.shape)


def _pin_segments(segs: list) -> None:
    """Move a range handle's code and offsets into page-locked host memory,
    once, at its first decode on a card: each request's words and offsets
    then go up by DMA, not through the driver's copy out of pageable memory
    on the host's CPU."""
    if torch.from_numpy(segs[0][0].code_bytes).is_pinned():
        return
    for i, (stream, ft) in enumerate(segs):
        segs[i] = (dataclasses.replace(
            stream, code_bytes=_pinned(stream.code_bytes),
            block_offsets=_pinned(stream.block_offsets)), ft)


def fetch_checked(frames: torch.Tensor, fcrcs, base: int) -> np.ndarray:
    """Fetch frames [base, base+len) of a stream to the host as numpy and
    check them against its per-frame CRC table ``fcrcs`` (None passes). On
    a CUDA device one launch of ``crc_cuda.frame_crcs`` hashes each frame's
    bytes (a uint16 frame's as zlib reads them) before the fetch and the
    host compares integers; CPU tensors hash the fetched frames with zlib.
    A card's frames and CRCs come down into page-locked memory (torch's
    pinned host cache, which the returned array holds) with one wait.
    Marks ``range.fetch`` and spans ``range.crc``."""
    crcs = (crc_cuda.frame_crcs(frames.view(torch.uint8))
            if fcrcs is not None and crc_cuda.is_card(frames) else None)
    mark("range.fetch")
    if frames.is_cuda:
        # both come down into pinned memory by DMA, then one wait
        stream = torch.cuda.current_stream(frames.device)
        frames = _fetch_pinned(frames)
        if crcs is not None:
            crcs = _fetch_pinned(crcs)
        stream.synchronize()
    frames = frames.numpy()
    if crcs is not None:
        crcs = crcs.numpy()
    with span("range.crc"):
        verify_frame_crcs(frames, fcrcs, base=base, crcs=crcs)
    return frames


def _fetch_pinned(t: torch.Tensor) -> torch.Tensor:
    """Queue the copy of a card's tensor into page-locked host memory;
    the host reads it after the stream's wait."""
    out = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
    return out.copy_(t, non_blocking=True)


def decode_container_device(data: bytes, config: CodecConfig | None = None,
                            *, device="cuda") -> torch.Tensor:
    """MHTV/MHV2 container bytes -> (T, H, W) uint8 tensor on ``device``,
    with no host fetch and no CRC check (for a consumer that goes on with
    device work and verifies after its own fetch). Segments decode one
    after another and are joined by ``torch.cat``. ``device="native"`` is
    refused, as the JAX package refuses its native backend here."""
    if native.is_native(device):
        raise ValueError(
            "decode_container_device needs a torch device, not 'native'")
    segs, _t, h, w, cfg = read_video(data, config)
    outs = [decode_frames_shared(s, ft, h, w, cfg, device=device)
            for s, ft in segs]
    return outs[0] if len(outs) == 1 else torch.cat(outs)


def salvage_blocks(frames: np.ndarray, err: np.ndarray, block_dim: int):
    """Zero-fill corrupt blocks (best-effort serving decode).

    ``err`` is the stream-order per-block mask of
    :func:`decode_shared_step_checked`. Returns ``(frames, n_corrupt)``; the
    array is copied first when it is read-only, else patched in place.
    """
    idx = np.nonzero(np.asarray(err))[0]
    if idx.size == 0:
        return frames, 0
    if not frames.flags.writeable:
        frames = frames.copy()
    _t, h, w = frames.shape
    bd = block_dim
    _bh, bw = blocks.block_grid(h, w, bd)
    per = _bh * bw
    for i in idx:
        f, r = divmod(int(i), per)
        by, bx = divmod(r, bw)
        frames[f, by * bd : (by + 1) * bd, bx * bd : (bx + 1) * bd] = 0
    return frames, int(idx.size)


def decode_video_region(data: bytes, a: int, b: int, y0: int, x0: int,
                        rh: int, rw: int, config: CodecConfig | None = None,
                        check: bool = False, *, device="cuda") -> np.ndarray:
    """The (rh, rw) crop at (y0, x0) of frames [a, b) of an MHTV/MHV2/MHTS
    container, decoded on ``device`` -> (b-a, rh, rw) uint8 numpy array.

    Only the blocks covering the region in those frames are decoded: on
    MHTV/MHV2 one launch of the packed-block kernel per segment touched
    (``image_codec.decode_blocks_selection``; the selection is frame-major,
    so the frames' block grids stack into one taller image), on MHTS an
    ``ImageCodec.decode_region`` per frame. With ``check`` the end-bit check
    verifies exactly the touched blocks and raises ValueError naming the
    corrupt frames (per-frame CRCs cannot cover a crop).
    """
    from .image_codec import ImageCodec, decode_blocks_selection

    if data[:4] == STREAM_MAGIC:
        outs = []
        geom = None
        # the span walk skips records before ``a`` without parsing them
        for i, pos, rec_len in _iter_record_spans(data):
            if i >= b:
                break
            if geom is None:
                geom = struct.unpack_from("<II", data, pos + 4)
                if not (0 <= y0 and y0 + rh <= geom[0]
                        and 0 <= x0 and x0 + rw <= geom[1]):
                    raise ValueError("region out of bounds")
            if i < a:
                continue
            s, h, w, bd, delta, _crc = container.read_frame(
                data[pos : pos + rec_len])
            codec = ImageCodec(_container_config(config, bd, delta,
                                                 s.predictor))
            outs.append(codec.decode_region(s, h, w, y0, x0, rh, rw,
                                            check=check, device=device))
        if len(outs) != b - a or not 0 <= a < b:
            raise ValueError(
                f"frames [{a}, {b}) out of range "
                f"({len(outs) + a} frames reachable)")
        return np.stack(outs)
    segs, t, h, w, cfg = read_video(data, config)
    if not 0 <= a < b <= t:
        raise ValueError(f"frames [{a}, {b}) out of range ({t} frames)")
    if not (0 <= y0 and y0 + rh <= h and 0 <= x0 and x0 + rw <= w):
        raise ValueError("region out of bounds")
    bd = cfg.block_dim
    _bh, bw = blocks.block_grid(h, w, bd)
    per = _bh * bw
    by0, bx0 = y0 // bd, x0 // bd
    by1, bx1 = (y0 + rh - 1) // bd + 1, (x0 + rw - 1) // bd + 1
    frame_sel = (np.arange(by0, by1)[:, None] * bw
                 + np.arange(bx0, bx1)[None, :]).ravel()
    rbh, rbw = by1 - by0, bx1 - bx0
    oy, ox = y0 - by0 * bd, x0 - bx0 * bd
    outs, base = [], 0
    for stream, ft in segs:  # a range may straddle segments
        lo, hi = max(a, base), min(b, base + ft)
        if lo < hi:
            tt = hi - lo
            sel = (frame_sel[None, :]
                   + per * np.arange(lo - base, hi - base)[:, None]).ravel()
            grid = decode_blocks_selection(stream, sel, tt * rbh * bd,
                                           rbw * bd, cfg, check=check,
                                           device=device)
            if check:
                grid, err = grid
                if err.any():
                    bad_frames = lo + np.unique(
                        np.flatnonzero(err) // frame_sel.size)
                    raise ValueError(
                        f"region integrity check failed: {int(err.sum())} "
                        f"of {sel.size} touched blocks corrupt (frames "
                        f"{bad_frames.tolist()})")
            outs.append(grid.reshape(tt, rbh * bd, rbw * bd).cpu().numpy())
        base += ft
    out = outs[0] if len(outs) == 1 else np.concatenate(outs)
    return out[:, oy : oy + rh, ox : ox + rw]


# -- per-frame-table video (MHTS) ---------------------------------------------

def encode_frames(frames: np.ndarray | list[np.ndarray],
                  config: CodecConfig | None = None
                  ) -> list[container.EncodedStream]:
    """Encode a (T, H, W) stack (or list) of same-sized grayscale frames,
    each with its own table."""
    from .image_codec import ImageCodec

    codec = ImageCodec(config)
    frames = np.asarray(frames)
    if frames.ndim != 3:
        raise ValueError("frames must be (T, H, W)")
    return [codec.encode(f) for f in frames]


def write_stream(streams: list[container.EncodedStream], height: int,
                 width: int, config: CodecConfig | None = None,
                 source_crc32s: list[int] | None = None) -> bytes:
    """Serialize a frame sequence to the MHTS container: ``MHTS``, the frame
    count u32, then per frame its MHT1 record's length u32 and the record.

    ``source_crc32s`` records each frame's raw-byte CRC-32 in its MHT1
    record (0 / None = unrecorded); read back with :func:`read_stream_crcs`.
    """
    cfg = config or CodecConfig()
    if source_crc32s is not None and len(source_crc32s) != len(streams):
        raise ValueError("source_crc32s must have one entry per frame")
    out = [STREAM_MAGIC, struct.pack("<I", len(streams))]
    for i, s in enumerate(streams):
        rec = container.write_frame(
            s, height, width, cfg.block_dim, cfg.delta,
            source_crc32=source_crc32s[i] if source_crc32s else 0)
        out.append(struct.pack("<I", len(rec)))
        out.append(rec)
    return b"".join(out)


def _iter_record_spans(data: bytes):
    """The one MHTS record walk: yields ``(i, offset, rec_len)`` per record
    (offset = start of the MHT1 blob, past its u32 length) without parsing
    record bodies; a cut container raises a clean ValueError."""
    if data[:4] != STREAM_MAGIC:
        raise ValueError("not an MHTS container")
    if len(data) < 8:
        raise ValueError("truncated MHTS container (header incomplete)")
    (count,) = struct.unpack_from("<I", data, 4)
    pos = 8
    for i in range(count):
        if len(data) < pos + 4:
            raise ValueError(
                f"truncated MHTS container (record {i} length missing)")
        (rec_len,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if len(data) < pos + rec_len:
            raise ValueError(
                f"truncated MHTS container (record {i} incomplete)")
        yield i, pos, rec_len
        pos += rec_len


def _iter_stream_records(data: bytes):
    for _i, pos, rec_len in _iter_record_spans(data):
        yield container.read_frame(data[pos : pos + rec_len])


def read_stream(data: bytes):
    """Parse MHTS -> (streams, height, width, block_dim, delta)."""
    streams, geom = [], None
    for stream, h, w, bd, delta, _crc in _iter_stream_records(data):
        if geom is None:
            geom = (h, w, bd, delta)
        elif geom != (h, w, bd, delta):
            raise ValueError("MHTS frames must share geometry")
        streams.append(stream)
    if geom is None:
        raise ValueError("empty MHTS stream")
    return streams, *geom


def read_stream_crcs(data: bytes) -> list[int]:
    """Per-frame recorded source CRC-32s of an MHTS container (0 = absent)."""
    return [rec[5] for rec in _iter_stream_records(data)]


def stream_frame_count(data: bytes) -> int:
    """Frame count recorded in an MHTS header (no record parsing)."""
    if data[:4] != STREAM_MAGIC:
        raise ValueError("not an MHTS container")
    if len(data) < 8:
        raise ValueError("truncated MHTS container (header incomplete)")
    (count,) = struct.unpack_from("<I", data, 4)
    return count


def iter_stream_frames(data: bytes, config: CodecConfig | None = None,
                       check: bool = False, *, device="cuda"):
    """Decode an MHTS container one frame at a time on ``device``.

    Yields ``(i, frame, err, recorded_crc)``: the (H, W) uint8 numpy frame,
    its stream-order end-bit error mask with ``check`` (else None), and the
    frame's recorded source CRC-32 (0 = absent; the caller verifies, so a
    salvaging consumer may skip it). Peak memory is one frame; records of
    mixed predictors decode each with its own.
    """
    from .image_codec import ImageCodec

    geom = None
    for i, (s, h, w, bd, delta, crc) in enumerate(_iter_stream_records(data)):
        if geom is None:
            geom = (h, w, bd, delta)
        elif geom != (h, w, bd, delta):
            raise ValueError("MHTS frames must share geometry")
        fcfg = _container_config(config, bd, delta, s.predictor)
        if check:
            if native.is_native(device):
                raise ValueError(
                    "the end-bit integrity check needs a torch device "
                    "(cuda, or cpu for the plain versions)")
            prep = prepare_shared(s, 1, h, w, fcfg, device=device, check=True)
            img, err = decode_shared_step_checked(prep, fcfg)
            yield i, img.cpu().numpy()[0], err, crc
        else:
            codec = ImageCodec(fcfg)
            img = codec.decode_step(codec.prepare(s, h, w, device=device))
            yield i, img.cpu().numpy(), None, crc


@dataclass(frozen=True)
class PreparedBatch:
    """An MHTS batch staged on one device, one table per frame.

    ``frames`` holds a one-frame :class:`PreparedShared` per frame, whose
    tensors are views of batch-wide ones (words, offsets, codes, root
    bytes).
    """

    height: int
    width: int
    block_dim: int
    bh: int  # block rows per frame
    bw: int  # block columns per frame
    frames: tuple  # (T,) PreparedShared
    #: (T, bh*bw) uint8 zero-init root bytes (zeros for a frame without
    #: them); None when no stream of the batch has them
    init_b: torch.Tensor | None = None


def prepare_batch(streams: list[container.EncodedStream], height: int,
                  width: int, config: CodecConfig | None = None, *,
                  device="cuda") -> PreparedBatch:
    """Stage a batch of same-geometry streams (an MHTS clip) on ``device``.

    Each stream keeps its own code (``decode_cuda.stage_codes``, whose
    lookup entries are cached for the last 32 codes), staged beside the
    others.
    """
    cfg = config or CodecConfig()
    if not streams:
        raise ValueError("cannot stage an empty batch")
    if len({s.predictor for s in streams}) > 1:
        raise ValueError(
            "batched decode needs one predictor across the batch (the mode "
            "is a static kernel parameter); decode mixed-predictor frames "
            "individually (ImageCodec) or regroup by predictor")
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    for s in streams:
        if s.block_offsets.size != bh * bw:
            raise ValueError(f"a stream has {s.block_offsets.size} blocks, "
                             f"a {height}x{width} frame {bh * bw}")
    windows = [decode_cuda.stream_window(s, cfg.block_size) for s in streams]
    words, words_at = decode_cuda.stage_words([c for c, _ in windows], device)
    words_at.append(words.numel())
    offsets = torch.from_numpy(np.concatenate(
        [o.view(np.int32) for _, o in windows])).to(device)
    codes = decode_cuda.stage_codes([s.widths for s in streams], device)
    nb = bh * bw
    init = None
    if any(s.block_init is not None for s in streams):
        # a frame without root bytes folds zeros
        init = torch.from_numpy(np.concatenate(
            [np.zeros(nb, np.uint8) if s.block_init is None
             else s.block_init.astype(np.uint8) for s in streams])
        ).to(device).view(len(streams), nb)
    frames = tuple(
        PreparedShared(
            1, height, width, cfg.block_dim, bh, bw,
            words[words_at[i] : words_at[i + 1]], offsets[i * nb : (i + 1) * nb],
            code, None if init is None else init[i : i + 1])
        for i, code in enumerate(codes))
    return PreparedBatch(height, width, cfg.block_dim, bh, bw, frames, init)


def decode_batch(prep: PreparedBatch, config: CodecConfig | None = None
                 ) -> torch.Tensor:
    """Decode a staged batch -> (T, H, W) uint8 tensor on its device.

    One launch per frame, each with its frame's code, all writing into one
    output: B1 into its frame of the (T, bh*8, bw*8) image at 8x8, B2 into
    its frame's rows of one (T*nb, block_size) block array (then one
    relayout) at other sizes.
    """
    cfg = config or CodecConfig()
    if cfg.block_dim != prep.block_dim:
        raise ValueError(f"batch was staged for block_dim {prep.block_dim}, "
                         f"config has {cfg.block_dim}")
    t, bh, bw, bd = len(prep.frames), prep.bh, prep.bw, prep.block_dim
    # a frame's B2 blocks take the bytes of its padded image, B1's output
    out = torch.empty((t, bh * bd, bw * bd), dtype=torch.uint8,
                      device=prep.frames[0].words.device)
    frame = _images(cfg, (1, bh, bw))
    for i, f in enumerate(prep.frames):
        launch_staged(f.words, f.offsets, f.code, cfg, frame, out=out[i])
    return launch_frames(out, cfg, _images(cfg, (t, bh, bw)),
                         (t, prep.height, prep.width),
                         prep.init_b).contiguous()


# -- multi-GPU decode ----------------------------------------------------------
#
# Each rank decodes a contiguous range of a batch and one all-gather puts the
# ranges back in order (``parallel.shard_decode``): a shared-table stream by
# block rows (B1) or blocks (B2), an MHTS batch by frames x blocks (B2).

def _shared_grid(num_frames: int, height: int, width: int, cfg: CodecConfig):
    """(units a rank's range counts, blocks per unit): block rows at 8x8
    (B1 writes whole image rows), blocks at other sizes."""
    bh, bw = blocks.block_grid(height, width, cfg.block_dim)
    if _images(cfg, (num_frames, bh, bw)) is not None:
        return num_frames * bh, bw
    return num_frames * bh * bw, 1


def decode_shared_local(stream: container.EncodedStream, num_frames: int,
                        height: int, width: int,
                        config: CodecConfig | None = None, *, rank: int,
                        world: int, device="cuda"):
    """The local step of :func:`decode_shared_sharded` for ``rank`` of
    ``world``: stage the code words of the rank's range alone and decode it
    -> (its block rows as ((hi - lo) * 8, bw * 8) uint8 image rows at 8x8,
    else its (hi - lo, block_size) blocks; (lo, hi))."""
    cfg = config or CodecConfig()
    if stream.block_init is not None:
        raise ValueError(
            "sharded decode returns raw rows or blocks and cannot fold "
            "zero-init roots; use decode_frames_shared")
    if cfg.delta2d and cfg.block_dim != 8:
        raise ValueError("sharded delta2d decode needs 8x8 blocks "
                         "(the in-kernel reconstruction)")
    units, per_unit = _shared_grid(num_frames, height, width, cfg)
    lo, hi = shard_decode.block_range(rank, world, units)
    staged = shard_decode.shard_stream_inputs(
        stream, lo * per_unit, hi * per_unit, cfg.block_size, device=device)
    local = launch_staged(*staged, cfg, _images(cfg, (1, hi - lo, per_unit)))
    return local.view(-1, local.shape[-1]), (lo, hi)


def decode_shared_sharded(stream: container.EncodedStream, num_frames: int,
                          height: int, width: int, mesh=None,
                          config: CodecConfig | None = None, *,
                          device="cuda"):
    """Multi-GPU shared-table batch decode: this rank's range, decoded on
    ``device``, and the range.

    At 8x8 each rank runs B1 on a contiguous range of the block rows of the
    stacked frames, and holds that horizontal slice of them; at other block
    sizes B2 on a range of blocks (see :func:`decode_shared_local`).
    :func:`gather_shared` gathers every rank's part into the (T, H, W)
    frames; the ranges run over ``mesh``'s ``"seq"`` axis (every rank of
    the process group when None). Streams with zero-init roots, and delta2d off 8x8, raise.
    """
    rank, world, _ = mesh_mod.axis_coords(mesh)
    return decode_shared_local(stream, num_frames, height, width, config,
                               rank=rank, world=world, device=device)


def _frames_from_units(flat: torch.Tensor, num_frames: int, height: int,
                       width: int, cfg: CodecConfig) -> torch.Tensor:
    """The decoded units of a shared-table batch in stream order, one row
    each (zero rows past the last one allowed) -> the (T, H, W) frames."""
    bd = cfg.block_dim
    bh, bw = blocks.block_grid(height, width, bd)
    units, _ = _shared_grid(num_frames, height, width, cfg)
    # B1's image rows and B2's blocks alike fill the frames' padded images
    return launch_frames(flat[:units].view(num_frames, bh * bd, bw * bd),
                         cfg, _images(cfg, (num_frames, bh, bw)),
                         (num_frames, height, width))


def frames_from_shards(parts, num_frames: int, height: int, width: int,
                       config: CodecConfig | None = None) -> torch.Tensor:
    """Every rank's :func:`decode_shared_local` output, in rank order ->
    the (T, H, W) frames."""
    cfg = config or CodecConfig()
    _, per_unit = _shared_grid(num_frames, height, width, cfg)
    return _frames_from_units(
        torch.cat([p.reshape(-1, per_unit * cfg.block_size) for p in parts]),
        num_frames, height, width, cfg)


def gather_shared(local: torch.Tensor, num_frames: int, height: int,
                  width: int, mesh=None,
                  config: CodecConfig | None = None) -> torch.Tensor:
    """All-gather every rank's part of :func:`decode_shared_sharded` ->
    the (T, H, W) uint8 frames on every rank."""
    cfg = config or CodecConfig()
    _, _, group = mesh_mod.axis_coords(mesh)
    units, per_unit = _shared_grid(num_frames, height, width, cfg)
    rows = shard_decode.gather_rows(
        local.reshape(-1, per_unit * cfg.block_size), units, group)
    return _frames_from_units(rows, num_frames, height, width, cfg)


def decode_batch_local(prep: PreparedBatch, config: CodecConfig | None = None,
                       *, data: tuple[int, int] = (0, 1),
                       seq: tuple[int, int] = (0, 1)) -> torch.Tensor:
    """The local step of :func:`decode_batch_sharded` for the rank at
    (index, size) ``data`` on the frame axis and ``seq`` on the block axis:
    B2 on its frames and blocks, each frame with its own code, then the
    delta2d post-pass off 8x8 and the zero-init fold on them -> (ceil(T /
    data size), ceil(nb / seq size), block_size) uint8."""
    cfg = config or CodecConfig()
    if cfg.block_dim != prep.block_dim:
        raise ValueError(f"batch was staged for block_dim {prep.block_dim}, "
                         f"config has {cfg.block_dim}")
    delta, delta2d = _precoder(cfg)
    blk = shard_decode.decode_frames_local(
        prep.frames, data=data, seq=seq, num_steps=cfg.block_size,
        delta=delta, delta2d=delta2d)
    init = None
    if prep.init_b is not None:
        # the rank's roots, zero past its frames and blocks as blk is
        f0, f1 = shard_decode.block_range(*data, len(prep.frames))
        b0, b1 = shard_decode.block_range(*seq, prep.bh * prep.bw)
        init = prep.init_b.new_zeros(blk.shape[:2])
        init[: f1 - f0, : b1 - b0] = prep.init_b[f0:f1, b0:b1]
    return launch_frames(blk, cfg, None, init=init)


def decode_batch_sharded(prep: PreparedBatch, mesh=None,
                         config: CodecConfig | None = None) -> torch.Tensor:
    """Multi-GPU MHTS batch decode on a ``data x seq`` mesh: frames over
    ``data``, block ranges over ``seq`` (:func:`decode_batch_local`), one
    all-gather -> (T, nb padded to a multiple of the seq axis, block_size)
    uint8 blocks on every rank, the zero-init roots folded in; crop to the
    frame's blocks and reassemble with ``blocks.blocks_to_image_torch``.
    ``mesh``: 2-D over every rank (``parallel.mesh.make_mesh_2d``'s default
    when None)."""
    data, seq, layout = mesh_mod.grid_layout(mesh)
    local = decode_batch_local(prep, config, data=data, seq=seq)
    return shard_decode.gather_grid(local, len(prep.frames), layout)
