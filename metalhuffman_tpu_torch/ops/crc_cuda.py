"""The per-frame CRC-32 on the card: the CUDA kernel's wrapper, the GF(2)
matrices the host builds for it, and a NumPy emulation of the kernel.

``csrc/frame_crc.cu`` hashes every frame of a contiguous (T, ...) uint8
stack on its device in one launch and writes the T values ``zlib.crc32``
gives, so a range request checks its frames against the container's table
before the fetch instead of hashing them on the host after it (the source's
note has the design). The plain version is ``zlib.crc32`` itself, which
``frame_stream.verify_frame_crcs`` runs on host arrays; :func:`frame_crcs`
launches the kernel or raises.

The host side is :func:`kernel_params`: the matrices that advance a raw
CRC past ``RUN_BYTES * 2**k`` zero bytes (``core/crc.py``, zlib's
``crc32_combine``), built once per process, and the affine term of a frame
length (the CRC-32 of that many zero bytes), passed to the kernel by value:
no copy to the card, no stream synchronisation. :func:`emulate` computes
the kernel's chunks, runs, slicing tables and combine tree in NumPy, which
the CPU tests hold to ``zlib.crc32``.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..core import crc as crc_core

#: kernel launches made by :func:`frame_crcs` in this process
launches = {"frame_crc": 0}

#: ``csrc/frame_crc.cu``'s constants: threads of a CUDA block, the bytes a
#: thread hashes (a run), the bytes a block hashes (a chunk), the levels of
#: a block's combine tree and the matrices of one launch
THREADS = 256
RUN_BYTES = 128
CHUNK_BYTES = THREADS * RUN_BYTES
TREE_LEVELS = 8
MATRICES = 28
#: the chunks a frame may have: the matrices past the tree count them
MAX_CHUNKS = 1 << (MATRICES - TREE_LEVELS)


def is_card(frames: torch.Tensor) -> bool:
    """True for a tensor the kernel hashes (on a CUDA device)."""
    return frames.device.type == "cuda"


def access_width(n: int, ptr: int) -> int:
    """Bytes a thread loads at once from a stack of ``n``-byte frames at
    address ``ptr``: the widest of 16, 8, 4, 2 and 1 that every frame's
    start allows."""
    return next(v for v in (16, 8, 4, 2, 1) if n % v == 0 and ptr % v == 0)


@functools.cache
def _matrices() -> np.ndarray:
    """(MATRICES, 32) uint32: row k feeds ``RUN_BYTES * 2**k`` zero bytes
    through the register, element i the image of bit i."""
    return np.array(crc_core.zeros_matrices(RUN_BYTES, MATRICES), np.uint32)


@functools.lru_cache(maxsize=64)
def kernel_params(n: int) -> np.ndarray:
    """The kernel's by-value parameter for frames of ``n`` bytes: the
    matrices, then the CRC-32 of ``n`` zero bytes ((MATRICES * 32 + 1,)
    uint32, read-only)."""
    affine = crc_core.crc32_combine(0xFFFFFFFF, 0xFFFFFFFF, n)
    out = np.append(_matrices().ravel(), np.uint32(affine))
    out.setflags(write=False)
    return out


def frame_crcs(frames: torch.Tensor) -> torch.Tensor:
    """The CRC-32 of each frame of ``frames`` (a contiguous (T, ...) uint8
    CUDA tensor, frames of at least one byte) -> (T,) uint32 tensor on its
    device, as ``zlib.crc32`` gives them; one launch on the current stream,
    no synchronisation. Raises on anything the kernel does not take and if
    the launch fails."""
    from .. import _build

    if not is_card(frames):
        raise ValueError(f"the CUDA frame CRC needs a CUDA tensor, not one "
                         f"on {frames.device}")
    if frames.dtype != torch.uint8:
        raise ValueError("the frame CRC hashes uint8 frames")
    if frames.dim() < 2 or not frames.is_contiguous():
        raise ValueError("frames must be a contiguous (T, ...) stack")
    t = frames.shape[0]
    n = math.prod(frames.shape[1:])
    if n < 1:
        raise ValueError("the frame CRC needs frames of at least one byte")
    chunks = -(-n // CHUNK_BYTES)
    if chunks > MAX_CHUNKS:
        raise ValueError(f"frames of {n} bytes exceed the frame CRC's "
                         f"{MAX_CHUNKS * CHUNK_BYTES}")
    if t * chunks >= 2**31:
        raise ValueError(f"{t} frames of {n} bytes exceed the frame CRC's "
                         "grid of 2^31 - 1 CUDA blocks")
    out = torch.empty(t, dtype=torch.uint32, device=frames.device)
    if t == 0:
        return out
    _build.launch("frame_crc", frames.device, frames.data_ptr(), n, t,
                  access_width(n, frames.data_ptr()),
                  kernel_params(n).ctypes.data, out.data_ptr())
    launches["frame_crc"] += 1
    return out


def gf2_apply(mat: np.ndarray, v: np.ndarray) -> np.ndarray:
    """``mat`` (32 columns) applied to each uint32 of ``v`` over GF(2)."""
    s = np.zeros_like(v)
    for i in range(32):
        s ^= np.where((v >> np.uint32(i)) & np.uint32(1), mat[i], np.uint32(0))
    return s


def slicing_tables() -> np.ndarray:
    """(16, 256) uint32: row k the raw CRC of a byte and k zero bytes, as
    each CUDA block builds them in shared memory."""
    tab = np.arange(256, dtype=np.uint32)
    for _ in range(8):
        tab = (tab >> np.uint32(1)) ^ np.where(
            tab & np.uint32(1), np.uint32(0xEDB88320), np.uint32(0))
    rows = [tab]
    for _ in range(15):
        rows.append((rows[-1] >> np.uint32(8)) ^ tab[rows[-1] & np.uint32(0xFF)])
    return np.stack(rows)


def emulate(stack: np.ndarray, n: int, t: int,
            params: np.ndarray) -> np.ndarray:
    """The kernel on ``stack`` (the launch's memory: ``t`` frames of ``n``
    bytes, flat uint8) with ``params`` as :func:`kernel_params` gives them,
    in NumPy -> (t,) uint32.

    As the CUDA blocks do: each frame is padded at its front with zero
    bytes to whole chunks; each thread hashes its run with the slicing
    tables, 16 bytes a step from state 0; the runs of a chunk combine in the
    block's tree (pairs of neighbours, the left advanced past the right's
    bytes by the level's matrix); each chunk is advanced past the chunks
    after it, in binary; the frame's first chunk adds the affine term; the
    chunks' values are xored together (the order of the atomics)."""
    mats = params[: MATRICES * 32].reshape(MATRICES, 32)
    chunks = -(-n // CHUNK_BYTES)
    padded = np.zeros((t, chunks * CHUNK_BYTES), np.uint8)
    padded[:, chunks * CHUNK_BYTES - n :] = stack[: t * n].reshape(t, n)
    words = padded.view("<u4").reshape(t, chunks, THREADS, RUN_BYTES // 4)
    tab = slicing_tables()
    crc = np.zeros((t, chunks, THREADS), np.uint32)
    for g in range(0, RUN_BYTES // 4, 4):
        a = crc ^ words[..., g]
        crc = np.zeros_like(crc)
        for j, w in enumerate((a, words[..., g + 1], words[..., g + 2],
                               words[..., g + 3])):
            for b in range(4):
                crc ^= tab[15 - 4 * j - b][(w >> np.uint32(8 * b)) & np.uint32(0xFF)]
    for level in range(TREE_LEVELS):
        pairs = crc.reshape(t, chunks, -1, 2)
        crc = gf2_apply(mats[level], pairs[..., 0]) ^ pairs[..., 1]
    crc = crc.reshape(t, chunks)
    after = chunks - 1 - np.arange(chunks)
    for b in range(MATRICES - TREE_LEVELS):
        hit = (after >> b) & 1 == 1
        crc[:, hit] = gf2_apply(mats[TREE_LEVELS + b], crc[:, hit])
    crc[:, 0] ^= params[MATRICES * 32]
    return np.bitwise_xor.reduce(crc, axis=1)
