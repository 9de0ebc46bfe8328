"""The yardstick of the roofline metrics: the card's peaks and the bytes and
operations a kernel's work needs, counted from the shapes of its inputs and
outputs whatever implements it (the count of ``chip_smoke.bound``).

Peaks of one NVIDIA H100 SXM (data sheet; Hopper white paper): 3.35 TB/s of
HBM3, and integer operations at 132 SMs x 64 INT32 units (the white paper's
count a Hopper SM holds; its 128 lanes are FP32) at the 1.98 GHz boost
clock. They assume the full 700 W; the run prints the card's
power limit beside every share.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 132 * 64 * 1.98e9
#: integer operations a minimal table-driven canonical decode needs per
#: symbol: peek, lookup, width, consume (refills, stores and the precoder
#: left out, so the bound is a floor)
DECODE_OPS_PER_SYMBOL = 4
#: the canonical symbol order every decode reads once
SYMBOL_TABLE_BYTES = 256


def least_s(nbytes: int, n_ops: int = 0) -> float:
    """The least seconds the card could take: the larger of the bytes over
    the HBM rate and the integer operations over the INT32 rate."""
    return max(nbytes / HBM_BYTES_PER_S, n_ops / INT32_OPS_PER_S)


def decode_least_s(n_words: int, n_offsets: int, n_symbols: int) -> float:
    """A decode of a staged batch: every code word and block offset (4 bytes
    each) and the symbol table read once, every decoded symbol (1 byte)
    written once."""
    nbytes = 4 * n_words + 4 * n_offsets + SYMBOL_TABLE_BYTES + n_symbols
    return least_s(nbytes, DECODE_OPS_PER_SYMBOL * n_symbols)


def fold_least_s(frame_bytes: int) -> float:
    """A temporal fold: the residual frames read once, the true frames
    written once."""
    return least_s(2 * frame_bytes)
