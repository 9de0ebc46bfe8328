"""MSB-first word view of a packed code stream (copy of the port's share of
``metalhuffman_tpu/core/bitstream.py``).

Wire behavior matches the reference encoder: each symbol's canonical code is
emitted MSB-first into a byte stream (``HuffmanEncoder.cpp:211-276``), and two
zero read-ahead bytes are appended (``:371-378``).
"""

from __future__ import annotations

import numpy as np

READ_AHEAD_PAD_BYTES = 2  # reference: HuffmanEncoder.cpp:371-378


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
