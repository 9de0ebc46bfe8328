"""Canonical width-table validation (copy of
``metalhuffman_tpu/core/canonical.py::validate_widths``).

The 256-byte bit-width table is the wire header (reference:
``huff_util.hpp:45-68``); codes are at most 16 bits
(``HuffmanEncoder.hpp:7-9``).
"""

from __future__ import annotations

import numpy as np

MAX_CODE_LENGTH = 16


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
