"""CRC-32 combination: the CRC of concatenated payloads from the parts' CRCs
and lengths, with no pass over the data.

Counterpart of ``metalhuffman_tpu/core/crc.py``. Container surgery
(``models.surgery``) derives a spliced container's whole-payload CRC from
the inputs' recorded CRCs or a sliced per-frame table (FCRC), never by
reading the payload again. The algorithm is zlib's ``crc32_combine``: GF(2)
matrix powers of the reflected CRC-32 polynomial applied to the first CRC.
"""

from __future__ import annotations

_POLY = 0xEDB88320  # reflected CRC-32 polynomial


def _gf2_times_vec(mat: list[int], vec: int) -> int:
    s = 0
    i = 0
    while vec:
        if vec & 1:
            s ^= mat[i]
        vec >>= 1
        i += 1
    return s


def _gf2_square(mat: list[int]) -> list[int]:
    return [_gf2_times_vec(mat, mat[n]) for n in range(32)]


def crc32_combine(crc1: int, crc2: int, len2: int) -> int:
    """CRC-32 of ``A + B`` given ``crc32(A)``, ``crc32(B)`` and ``len(B)``."""
    if len2 <= 0:
        return crc1 & 0xFFFFFFFF
    # odd: the matrix that feeds one zero bit through the CRC register
    odd = [_POLY] + [1 << (n - 1) for n in range(1, 32)]
    even = _gf2_square(odd)  # two zero bits
    odd = _gf2_square(even)  # four zero bits
    # feed len2 zero BYTES into crc1, squaring through the bits of len2
    while True:
        even = _gf2_square(odd)
        if len2 & 1:
            crc1 = _gf2_times_vec(even, crc1)
        len2 >>= 1
        if len2 == 0:
            break
        odd = _gf2_square(even)
        if len2 & 1:
            crc1 = _gf2_times_vec(odd, crc1)
        len2 >>= 1
        if len2 == 0:
            break
    return (crc1 ^ crc2) & 0xFFFFFFFF


def zeros_matrices(first_bytes: int, count: int) -> list[list[int]]:
    """The GF(2) matrices that feed ``first_bytes * 2**k`` zero bytes
    through the CRC register, for k < ``count`` (``first_bytes`` a power of
    two): 32 columns each, column i the image of bit i, so that
    ``crc32_combine(c, 0, L)`` is the matrix of L bytes applied to ``c``."""
    if first_bytes < 1 or first_bytes & (first_bytes - 1):
        raise ValueError(f"first_bytes must be a power of two, not "
                         f"{first_bytes}")
    mat = [_POLY] + [1 << (n - 1) for n in range(1, 32)]  # one zero bit
    for _ in range((8 * first_bytes).bit_length() - 1):
        mat = _gf2_square(mat)
    out = []
    for _ in range(count):
        out.append(mat)
        mat = _gf2_square(mat)
    return out


def crc32_concat(parts: list[tuple[int, int]]) -> int:
    """CRC-32 of the concatenation of parts given ``[(crc, length), ...]``."""
    crc, _ = parts[0]
    for c, n in parts[1:]:
        crc = crc32_combine(crc, c, n)
    return crc & 0xFFFFFFFF
