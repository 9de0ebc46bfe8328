"""Image <-> zero-padded block-order reordering (NumPy copies of
``metalhuffman_tpu/core/blocks.py``, and a torch twin of its JAX inverse).

Reference: ``Util.m:233-323`` (``splitIntoBlocksOfSize:inBytes:``) reorders a
W x H byte image into square blocks in raster block order, zero-padding the
right and bottom edges; ``flattenBlocksOfSize`` (``Util.m:539-611``) is the
inverse.
"""

from __future__ import annotations

import numpy as np
import torch


def block_grid(height: int, width: int, block_dim: int = 8) -> tuple[int, int]:
    """Ceil-div block-grid geometry (reference: ``Util.m:616-632``)."""
    return (-(-height // block_dim), -(-width // block_dim))


def image_to_blocks(img: np.ndarray, block_dim: int = 8) -> np.ndarray:
    """(H, W) image -> (num_blocks, block_dim**2) in raster block order."""
    img = np.asarray(img, dtype=np.uint8)
    h, w = img.shape
    bh, bw = block_grid(h, w, block_dim)
    padded = np.zeros((bh * block_dim, bw * block_dim), dtype=np.uint8)
    padded[:h, :w] = img
    # (bh, block_dim, bw, block_dim) -> (bh, bw, block_dim, block_dim)
    tiles = padded.reshape(bh, block_dim, bw, block_dim).transpose(0, 2, 1, 3)
    return tiles.reshape(bh * bw, block_dim * block_dim)


def blocks_to_image(
    blocks: np.ndarray, height: int, width: int, block_dim: int = 8
) -> np.ndarray:
    """Inverse of :func:`image_to_blocks`, cropping the zero padding."""
    blocks = np.asarray(blocks, dtype=np.uint8)
    bh, bw = block_grid(height, width, block_dim)
    tiles = blocks.reshape(bh, bw, block_dim, block_dim).transpose(0, 2, 1, 3)
    padded = tiles.reshape(bh * block_dim, bw * block_dim)
    return padded[:height, :width]


def blocks_to_image_torch(blocks: torch.Tensor, height: int, width: int,
                          block_dim: int = 8) -> torch.Tensor:
    """Torch :func:`blocks_to_image` on the tensor's own device, batched
    over leading dims: (..., bh*bw, block_dim**2) -> (..., H, W), a cropped
    view of the padded image."""
    bh, bw = block_grid(height, width, block_dim)
    lead = blocks.shape[:-2]
    tiles = blocks.reshape(*lead, bh, bw, block_dim, block_dim).transpose(-3, -2)
    padded = tiles.reshape(*lead, bh * block_dim, bw * block_dim)
    return padded[..., :height, :width]
