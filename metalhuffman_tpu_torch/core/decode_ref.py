"""The bit window of the serial reference decoders (the part of
``metalhuffman_tpu/core/decode_ref.py`` that ``utils.debug`` needs to trace
a block symbol by symbol).

Decode step (identical to ``AAPLShaders.metal:127-178``): fetch 3 bytes at
``bits >> 3`` and assemble a left-justified 16-bit window by shifting out
the ``bits & 7`` consumed bits; the window indexes the 64K decode table.
"""

from __future__ import annotations

import numpy as np


def _window16(buf: np.ndarray, bits: int) -> int:
    byte_i = bits >> 3
    rem = bits & 7
    b0 = int(buf[byte_i])
    b1 = int(buf[byte_i + 1])
    b2 = int(buf[byte_i + 2])
    window24 = (b0 << 16) | (b1 << 8) | b2
    return (window24 >> (8 - rem)) & 0xFFFF
