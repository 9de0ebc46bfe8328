"""Stream inspection / debug dump tools (copy of
``metalhuffman_tpu/utils/debug.py``).

Analogs of the reference's debug machinery: ``codeBitsAsString``
(``AAPLRenderer.m:1102-1122``), the per-block golden data emitted under
``HUFF_EMIT_MULTIPLE_DEBUG_TEXTURES`` (``HuffRenderFrame.m:235-318`` — per
symbol blocki, rootBitOffset, currentBitOffset, bitWidth, bitPattern), and
the frequency/canonical table dumps (``HuffmanEncoder.cpp:38-49``,
``HuffmanUtil.cpp:299-301``).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..core import canonical, decode_ref, tables


def code_bits_as_string(code: int, width: int) -> str:
    """Left-justified 16-bit code -> its ``width`` bits as '0'/'1' text."""
    return format(code >> (16 - width), f"0{width}b") if width else ""


def dump_table(widths: np.ndarray, max_rows: int = 300) -> str:
    """Human-readable canonical table (symbol, width, code bits)."""
    widths = np.asarray(widths, dtype=np.uint8)
    codes = canonical.canonical_codes(widths)
    lines = ["sym  width  code"]
    active = np.nonzero(widths)[0]
    order = np.lexsort((active, widths[active]))
    for s in active[order][:max_rows]:
        w = int(widths[s])
        lines.append(f"{int(s):3d}  {w:5d}  {code_bits_as_string(int(codes[s]), w)}")
    if active.size > max_rows:
        lines.append(f"... {active.size - max_rows} more")
    return "\n".join(lines)


@dataclass(frozen=True)
class SymbolTrace:
    """Per-symbol decode record (the reference's golden-texture fields)."""

    index: int  # symbol index within the block
    bit_offset: int  # absolute bit offset of this symbol's code
    width: int  # code width in bits
    pattern: str  # the code bits as text
    symbol: int  # decoded symbol (pre-delta)
    value: int  # after delta reconstruction (equals symbol if delta off)


def trace_block(stream, block_index: int, block_size: int = 64,
                delta: bool = True) -> list[SymbolTrace]:
    """Decode one block symbol-by-symbol with full bookkeeping.

    ``stream`` is an EncodedStream; returns one SymbolTrace per symbol, the
    debugging view the reference spreads over its golden debug textures.
    The reported ``value`` honors the stream's full precoder state: the
    1-D running sum (``delta``), the 2-D predictor when the stream carries
    ``predictor == "2d"`` (row 0 adds its left neighbor, later rows the
    value 8 positions back), and any zero-init root byte.
    """
    widths = stream.widths
    sym_plane, w_plane = tables.build_single_table(widths)
    codes = canonical.canonical_codes(widths)
    bits = int(stream.block_offsets[block_index])
    out: list[SymbolTrace] = []
    prev = 0
    init = (int(stream.block_init[block_index])
            if getattr(stream, "block_init", None) is not None else 0)
    two_d = getattr(stream, "predictor", "left") == "2d"
    vals: list[int] = []
    buf = stream.code_bytes
    for i in range(block_size):
        window = decode_ref._window16(buf, bits)
        sym = int(sym_plane[window])
        w = int(w_plane[window])
        if w == 0:
            raise ValueError(f"invalid code at bit {bits} (corrupt stream)")
        if two_d:
            base = vals[i - 1] if 0 < i < 8 else vals[i - 8] if i >= 8 else 0
            prev = (sym + base + (init if i == 0 else 0)) & 0xFF
        elif delta:
            prev = (prev + sym + (init if i == 0 else 0)) & 0xFF
        else:
            prev = sym
        vals.append(prev)
        out.append(SymbolTrace(
            index=i, bit_offset=bits, width=w,
            pattern=code_bits_as_string(int(codes[sym]), w),
            symbol=sym, value=prev,
        ))
        bits += w
    return out


def stream_summary(stream) -> str:
    """Compression/statistics report (the reference's printf analog)."""
    widths = stream.widths
    active = widths[widths > 0]
    nb = stream.block_offsets.size
    sizes = np.diff(np.append(
        stream.block_offsets.astype(np.int64),
        8 * (stream.code_bytes.size - 2)))
    return (
        f"symbols={stream.num_symbols} blocks={nb} "
        f"compressed={stream.compressed_size} B "
        f"({stream.compressed_size / max(stream.num_symbols, 1):.1%})\n"
        f"active symbols={active.size} code widths "
        f"{int(active.min())}..{int(active.max())}\n"
        f"block bits: min={int(sizes.min())} avg={float(sizes.mean()):.1f} "
        f"max={int(sizes.max())}"
    )
