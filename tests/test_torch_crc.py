"""The port's CRC-32 combination (``metalhuffman_tpu_torch.core.crc``)
against the JAX package's copy and against ``zlib.crc32`` of the real
concatenation, on seeded random parts (empty and 1-byte parts included).
Every comparison is exact."""

import zlib

import numpy as np
import pytest
import torch

from metalhuffman_tpu.core import crc as jcrc
from metalhuffman_tpu_torch.core import crc

# xdist runs a worker per core: one torch thread each, or they oversubscribe
torch.set_num_threads(1)

LENGTHS = {
    "empty-empty": [0, 0],
    "one-byte": [1, 1, 1],
    "empty-inside": [5, 0, 9, 0],
    "empty-first": [0, 17],
    "mixed": [1, 300, 4096, 7, 65537],
    "powers": [2, 8, 64, 1024, 1 << 16],
}


def _parts(lengths, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, n, dtype=np.uint8).tobytes()
            for n in lengths]


@pytest.mark.parametrize("case", LENGTHS)
def test_concat_equals_zlib_and_the_jax_copy(case):
    parts = _parts(LENGTHS[case], seed=len(case))
    pairs = [(zlib.crc32(p), len(p)) for p in parts]
    want = zlib.crc32(b"".join(parts))
    assert crc.crc32_concat(pairs) == want
    assert crc.crc32_concat(pairs) == jcrc.crc32_concat(pairs)


@pytest.mark.parametrize("seed", range(6))
def test_combine_of_two_random_parts(seed):
    rng = np.random.default_rng(100 + seed)
    n1, n2 = (int(x) for x in rng.integers(0, 5000, 2))
    a, b = _parts([n1, n2], seed)
    c1, c2 = zlib.crc32(a), zlib.crc32(b)
    got = crc.crc32_combine(c1, c2, len(b))
    assert got == zlib.crc32(a + b) == jcrc.crc32_combine(c1, c2, len(b))


def test_combine_with_an_empty_second_part_keeps_the_first():
    assert crc.crc32_combine(0x1234_5678, 0, 0) == 0x1234_5678
    assert crc.crc32_combine(0x1_0000_0001, 0, -3) == 1  # masked to 32 bits
    assert crc.crc32_combine(0x1_0000_0001, 0, -3) == jcrc.crc32_combine(
        0x1_0000_0001, 0, -3)


def test_combine_of_a_large_length_matches_the_jax_copy():
    # a length past 2^32 (a long video's payload), where no zlib pass is
    # affordable: the two copies agree bit for bit
    for len2 in ((1 << 32) + 3, 471_859_200, (1 << 40) - 1):
        assert crc.crc32_combine(0xDEADBEEF, 0x0BADF00D, len2) == \
            jcrc.crc32_combine(0xDEADBEEF, 0x0BADF00D, len2)
