"""MSB-first bit packing and the word view of a packed code stream (copy of
the port's share of ``metalhuffman_tpu/core/bitstream.py``).

Wire behavior matches the reference encoder: each symbol's canonical code is
emitted MSB-first into a byte stream (``HuffmanEncoder.cpp:211-276``), the
final partial byte is flushed zero-padded (``:278-306``), and two zero
read-ahead bytes are appended (``:371-378``).
"""

from __future__ import annotations

import numpy as np

READ_AHEAD_PAD_BYTES = 2  # reference: HuffmanEncoder.cpp:371-378


def symbol_bit_offsets(symbols: np.ndarray, widths: np.ndarray) -> np.ndarray:
    """Bit offset of each symbol in the packed stream (uint64, shape (n+1,)).

    The final entry is the total number of code bits.
    """
    symbols = np.asarray(symbols, dtype=np.uint8).ravel()
    per_symbol_bits = widths.astype(np.int64)[symbols]
    offsets = np.zeros(symbols.size + 1, dtype=np.int64)
    np.cumsum(per_symbol_bits, out=offsets[1:])
    return offsets.astype(np.uint64)


def pack_bits(symbols: np.ndarray, codes_lj: np.ndarray, widths: np.ndarray):
    """Pack symbols into an MSB-first byte stream.

    Args:
        symbols: input bytes, shape (n,).
        codes_lj: left-justified 16-bit canonical codes, shape (256,).
        widths: bit widths, shape (256,).

    Returns:
        (packed, bit_offsets): packed uint8 stream including the 2 read-ahead pad
        bytes, and the (n+1,) uint64 per-symbol bit offsets.
    """
    symbols = np.asarray(symbols, dtype=np.uint8).ravel()
    codes_lj = np.asarray(codes_lj, dtype=np.uint16)
    widths = np.asarray(widths, dtype=np.uint8)

    sym_widths = widths.astype(np.int64)[symbols]
    if symbols.size and sym_widths.min(initial=1) == 0:
        raise ValueError("input contains a symbol with zero code width")
    offsets = symbol_bit_offsets(symbols, widths)
    total_bits = int(offsets[-1])
    total_bytes = (total_bits + 7) // 8

    # Vectorized bit expansion: one row per emitted bit.
    sym_idx = np.repeat(np.arange(symbols.size, dtype=np.int64), sym_widths)
    # Position of the bit within its code (0 = MSB of the left-justified code).
    starts = np.repeat(offsets[:-1].astype(np.int64), sym_widths)
    bit_in_code = np.arange(sym_idx.size, dtype=np.int64) - starts
    code_vals = codes_lj.astype(np.uint16)[symbols[sym_idx]].astype(np.int64)
    bits = (code_vals >> (15 - bit_in_code)) & 1

    bit_buf = np.zeros(total_bytes * 8, dtype=np.uint8)
    bit_buf[: bits.size] = bits.astype(np.uint8)
    packed = np.packbits(bit_buf)  # MSB-first within each byte, as the reference
    packed = np.concatenate(
        [packed, np.zeros(READ_AHEAD_PAD_BYTES, dtype=np.uint8)]
    )
    return packed, offsets


def bytes_to_be_words(packed: np.ndarray, pad_words: int = 1) -> np.ndarray:
    """View the byte stream as big-endian uint32 words for the decoder.

    Bit ``i`` of the stream is bit ``31 - (i % 32)`` of word ``i // 32``; a
    left-justified funnel window can then be built from two adjacent words.
    ``pad_words`` extra zero words are appended so the decoder may always read
    word ``(bit >> 5) + 1`` (the generalized +2-byte read-ahead rule of
    ``HuffmanEncoder.cpp:371-378``).
    """
    packed = np.asarray(packed, dtype=np.uint8).ravel()
    n_words = (packed.size + 3) // 4 + pad_words
    buf = np.zeros(n_words * 4, dtype=np.uint8)
    buf[: packed.size] = packed
    return buf.reshape(-1, 4).astype(np.uint32) @ np.array(
        [1 << 24, 1 << 16, 1 << 8, 1], dtype=np.uint32
    )
