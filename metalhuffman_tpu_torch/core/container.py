"""Serialized container format for encoded frames (copy of
``metalhuffman_tpu/core/container.py``).

Core blob layout is byte-identical to the reference encoder's in-memory
serialization (``HuffmanEncoder.cpp:310-381``):

    [0:4]    magic 0xFFEEEEDD, little-endian   (``:328-333``)
    [4:8]    original size in bytes, LE uint32 (``:335-340``)
    [8:264]  256-byte canonical bit-width table (``:342-349``)
    [264:]   MSB-first code bytes + 2 zero read-ahead pad bytes (``:364-378``)

The on-disk single-image container ("MHT1") prepends frame geometry and
appends the per-block bit-offset index so a decoder can start without
re-scanning the stream.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass

import numpy as np

from . import canonical

MAGIC = 0xFFEEEEDD
DISK_MAGIC = b"MHT1"


@dataclass(frozen=True)
class EncodedStream:
    """A reference-format encoded stream plus the block-offset index."""

    num_symbols: int  # original input size in bytes/symbols
    widths: np.ndarray  # (256,) uint8 canonical bit-width table
    code_bytes: np.ndarray  # uint8 stream incl. +2 read-ahead pad bytes
    block_offsets: np.ndarray  # (num_blocks,) uint32 bit offset per block root
    #: zero-init-delta side channel (reference's _blockInitData,
    #: AAPLRenderer.m:449-473): one uncoded root byte per block; None unless
    #: the stream was encoded with CodecConfig.zero_init
    block_init: np.ndarray | None = None
    #: which precoder produced the symbols: "left" (the reference's 1-D
    #: raster delta; also the value when delta is off entirely) or "2d"
    #: (row0-left/delta-up predictor)
    predictor: str = "left"

    def core_blob(self) -> bytes:
        """Reference-compatible blob; its length is the compressed size used
        for parity comparison against the reference encoder."""
        header = struct.pack("<II", MAGIC, self.num_symbols)
        return header + self.widths.tobytes() + self.code_bytes.tobytes()

    @property
    def compressed_size(self) -> int:
        """Total bytes of the reference-format blob (header+table+codes+pad)."""
        return 8 + 256 + int(self.code_bytes.size)


def parse_core_blob(blob: bytes) -> tuple[int, np.ndarray, np.ndarray]:
    """Parse a reference-format blob -> (num_symbols, widths, code_bytes).

    The canonical width table is validated on parse (Kraft completeness,
    <=16-bit lengths): a corrupted table would otherwise silently build
    degenerate decode tables and decode bounded garbage that only the
    payload CRC could catch.
    """
    if len(blob) < 264:
        raise ValueError("blob too short for header + canonical table")
    magic, num_symbols = struct.unpack_from("<II", blob, 0)
    if magic != MAGIC:
        raise ValueError(f"bad magic 0x{magic:08X}")
    widths = np.frombuffer(blob, dtype=np.uint8, count=256, offset=8).copy()
    code_bytes = np.frombuffer(blob, dtype=np.uint8, offset=264).copy()
    try:
        canonical.validate_widths(widths)
    except ValueError as e:
        raise ValueError(f"corrupt canonical width table: {e}") from e
    return num_symbols, widths, code_bytes


def write_frame(
    stream: EncodedStream,
    height: int,
    width: int,
    block_dim: int,
    delta: bool,
    source_crc32: int = 0,
) -> bytes:
    """Serialize to the on-disk MHT1 container (geometry + crc + core + offsets).

    ``source_crc32`` is the CRC-32 of the *original* (pre-encode) image
    bytes; 0 means "not recorded".

    The delta byte is a MODE: 0 = none, 1 = delta, 2 = delta + zero-init
    (``stream.block_init`` root bytes appended after the offset index),
    3 = delta2d, 4 = delta2d + zero-init.
    """
    mode = int(delta)
    tail = b""
    if stream.predictor == "2d":
        if not delta:
            raise ValueError("delta2d is a delta precoding mode")
        mode = 3
    if stream.block_init is not None:
        if not delta:
            raise ValueError("zero-init requires delta precoding")
        if stream.block_init.size != stream.block_offsets.size:
            raise ValueError("block_init must have one byte per block")
        mode = 4 if mode == 3 else 2
        tail = stream.block_init.astype(np.uint8).tobytes()
    head = DISK_MAGIC + struct.pack(
        "<IIIBBI",
        height, width, stream.block_offsets.size, block_dim, mode,
        source_crc32 & 0xFFFFFFFF,
    )
    core = stream.core_blob()
    return (
        head
        + struct.pack("<I", len(core))
        + core
        + stream.block_offsets.astype("<u4").tobytes()
        + tail
    )


def read_frame(data: bytes):
    """Parse MHT1 -> (stream, height, width, block_dim, delta, source_crc32).

    Two MHT1 header layouts exist: the current one carries a source CRC-32
    after the delta flag; an early revision did not. Both start with the
    same ``MHT1`` magic, so the layout is disambiguated by where the core
    blob's own magic (0xFFEEEEDD) lands — unambiguous, since the field that
    would alias it in the other layout is a byte count that can never reach
    0xFFEEEEDD.
    """
    if data[:4] != DISK_MAGIC:
        raise ValueError("not an MHT1 container")
    if len(data) >= 30 and struct.unpack_from("<I", data, 26)[0] == MAGIC:
        height, width, n_blocks, block_dim, delta, crc = struct.unpack_from(
            "<IIIBBI", data, 4
        )
        (core_len,) = struct.unpack_from("<I", data, 22)
        core_off = 26
    elif len(data) >= 26 and struct.unpack_from("<I", data, 22)[0] == MAGIC:
        # legacy pre-CRC layout: <IIIBB> geometry header, core_len at 18
        height, width, n_blocks, block_dim, delta = struct.unpack_from(
            "<IIIBB", data, 4
        )
        crc = 0
        (core_len,) = struct.unpack_from("<I", data, 18)
        core_off = 22
    else:
        raise ValueError(
            "unrecognized MHT1 header layout (corrupt, or written by an "
            "incompatible version)"
        )
    core = data[core_off : core_off + core_len]
    num_symbols, widths, code_bytes = parse_core_blob(core)
    offsets = np.frombuffer(
        data, dtype="<u4", count=n_blocks, offset=core_off + core_len
    ).astype(np.uint32)
    if offsets.size != n_blocks:
        raise ValueError("truncated MHT1 container (offset index incomplete)")
    block_init = None
    if delta in (2, 4):  # zero-init modes: uncoded root bytes after the index
        init_off = core_off + core_len + 4 * n_blocks
        block_init = np.frombuffer(
            data, dtype=np.uint8, count=n_blocks, offset=init_off).copy()
        if block_init.size != n_blocks:
            raise ValueError("truncated MHT1 container (block_init missing)")
    stream = EncodedStream(
        num_symbols, widths, code_bytes, offsets, block_init,
        predictor="2d" if delta in (3, 4) else "left")
    return stream, height, width, block_dim, bool(delta), crc
