"""Canonical width-table validation and code assignment (copies of
``metalhuffman_tpu/core/canonical.py::validate_widths`` and
``canonical_codes``).

The 256-byte bit-width table is the wire header (reference:
``huff_util.hpp:45-68``); codes are at most 16 bits
(``HuffmanEncoder.hpp:7-9``).
"""

from __future__ import annotations

import numpy as np

MAX_CODE_LENGTH = 16
NUM_SYMBOLS = 256


def validate_widths(widths: np.ndarray) -> None:
    """Check the width table satisfies the Kraft equality (complete code)."""
    widths = np.asarray(widths, dtype=np.int64)
    nz = widths[widths > 0]
    if nz.size == 0:
        raise ValueError("width table has no active symbols")
    if nz.max() > MAX_CODE_LENGTH:
        raise ValueError("code length exceeds 16 bits")
    kraft = np.sum(2.0 ** (MAX_CODE_LENGTH - nz))
    full = float(1 << MAX_CODE_LENGTH)
    if nz.size == 1:
        # Single active symbol: the canonical assignment always gives it a
        # 1-bit code (Kraft sum 1/2; the decoder only ever reads '0' bits).
        # Any other width here is a corrupt or hand-mangled table.
        if nz[0] != 1:
            raise ValueError(
                f"single-symbol table must use width 1, got {int(nz[0])}")
        return
    if kraft != full:
        raise ValueError(
            f"width table is not a complete prefix code (kraft={kraft}/{full})"
        )


def canonical_codes(widths: np.ndarray) -> np.ndarray:
    """Left-justified 16-bit canonical codes from a width table.

    Matches the reference's assignment exactly (``huff_util.hpp:94-193``):
    sort active symbols by ``(width, symbol)``, assign sequential codes,
    left-shift the running code when width increases, left-justify into 16 bits.
    Unused symbols get code 0.
    """
    widths = np.asarray(widths, dtype=np.uint8)
    if widths.shape != (NUM_SYMBOLS,):
        raise ValueError("widths must have shape (256,)")
    codes = np.zeros(NUM_SYMBOLS, dtype=np.uint16)
    active = np.nonzero(widths)[0]
    if active.size == 0:
        return codes
    order = np.lexsort((active, widths[active]))
    syms = active[order]
    ws = widths[active][order].astype(np.int64)

    current = 0
    for i, (s, w) in enumerate(zip(syms, ws)):
        codes[s] = np.uint16((current << (16 - w)) & 0xFFFF)
        current += 1
        if i + 1 < len(syms) and ws[i + 1] > w:
            current <<= int(ws[i + 1] - w)
    return codes
