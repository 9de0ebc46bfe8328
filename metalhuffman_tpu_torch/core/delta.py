"""Per-block precoder helpers: the zero-init split and fold (NumPy copies of
``metalhuffman_tpu/core/delta.py``) and the torch inverse of the 2-D
within-block predictor.

Reference semantics (``HuffmanUtil.cpp:21-85`` applied per block at
``AAPLRenderer.m:432-515``): reconstruction is a running sum mod 256 that
restarts at each block root (the GPU shader's ``prevSymbol`` accumulator,
``AAPLShaders.metal:260-265``).
"""

from __future__ import annotations

import numpy as np
import torch


def delta2d_decode_blocks(res: torch.Tensor, block_dim: int) -> torch.Tensor:
    """Inverse of the 2-D predictor on (..., block_dim**2) uint8 residual
    blocks, on the tensor's own device.

    Row 0 is a running sum along the row; every pixel is then a running sum
    down its column (both mod 256). The torch counterpart of
    ``delta2d_decode_blocks_jax`` and its ``_group_prefix_jax``: with the
    block as its own two axes, each group prefix is a plain ``cumsum``.
    """
    sq = res.reshape(*res.shape[:-1], block_dim, block_dim).to(torch.int32)
    sq[..., 0, :] = torch.cumsum(sq[..., 0, :], -1, dtype=torch.int32)
    out = torch.cumsum(sq, -2, dtype=torch.int32) & 0xFF
    return out.to(torch.uint8).reshape(res.shape)


def split_zero_init(deltas: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Zero-init-delta transform: (..., block_len) deltas -> (init, zeroed).

    The reference's ``IMPL_DELTAS_AND_INIT_ZERO_DELTA_BEFORE_HUFF_ENCODING``
    variant (``AAPLShaderTypes.h:110``, ``AAPLRenderer.m:449-473``): each
    block's first delta (its literal root byte) moves to a raw side array
    and the stream slot becomes 0 — boosting the zero-delta count so the
    canonical tree spends fewer bits on it; the root byte ships uncoded.
    """
    d = np.asarray(deltas, dtype=np.uint8).copy()
    init = d[..., 0].copy()
    d[..., 0] = 0
    return init, d


def apply_block_init(blocks: np.ndarray, init: np.ndarray) -> np.ndarray:
    """Fold init bytes back into zero-init-decoded blocks.

    Initializing the decoder's ``prev`` accumulator to the block's init
    byte (the reference seeds the render target's R channel with it,
    ``AAPLRenderer.m:1050-1068``) is equivalent to decoding with prev=0 and
    adding the init byte to every output byte of the block mod 256 — which
    keeps every decode kernel unchanged.
    """
    blocks = np.asarray(blocks, dtype=np.uint8)
    return (blocks + np.asarray(init, dtype=np.uint8)[..., None]).astype(
        np.uint8)
