"""Sharded decode: each rank runs B2 or B1 on its contiguous block range.

Counterpart of ``metalhuffman_tpu/parallel/shard_decode.py``. Every block
decodes alone from its bit offset, so a rank takes a contiguous range of
blocks (:func:`block_range`), decodes it with the port's kernels (B2,
``decode_cuda.decode_blocks``, or B1, ``decode_cuda.decode_images``, on
image rows), and one all-gather puts the ranges back in stream order. The
code words and the code are replicated, or with
:func:`shard_stream_inputs` each rank stages only the words its range
reaches.

Each public function is a local step, which takes ``(rank, world)`` and runs
no collective, followed by one gather. The JAX package's two block decodes
(jnp and the Pallas B2) are both B2 here, and the TPU's tile staging has no
counterpart: the kernels read the stream at each block's own bit offset.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch
import torch.distributed as dist

from ..ops import decode_cuda
from .mesh import axis_coords, grid_layout


def block_range(rank: int, world: int, n: int) -> tuple[int, int]:
    """The contiguous range [lo, hi) of ``n`` items that ``rank`` of
    ``world`` holds: ``ceil(n / world)`` items each, the last ranks fewer
    or none (the JAX package pads ``n`` to a multiple of the world)."""
    per = -(-n // world)
    lo = min(rank * per, n)
    return lo, min(lo + per, n)


def gather_rows(local: torch.Tensor, n: int, group=None) -> torch.Tensor:
    """All-gather each rank's rows of an ``n``-row array split by
    :func:`block_range` -> (world * ceil(n / world), ...) on every rank, in
    rank order: the rows in stream order, then zero rows that pad the last
    ranges."""
    world = dist.get_world_size(group)
    per = -(-n // world)
    if local.shape[0] < per:
        local = torch.cat([local, local.new_zeros((per - local.shape[0],
                                                   *local.shape[1:]))])
    out = local.new_empty((world * per, *local.shape[1:]))
    # each rank's rows land in their view of the one output: no concatenation
    dist.all_gather(list(out.view(world, *local.shape).unbind()),
                    local.contiguous(), group=group)
    return out


def shard_stream_inputs(stream, lo: int, hi: int, block_size: int = 64, *,
                        device="cuda"):
    """Stage the decode inputs of blocks [lo, hi) of an EncodedStream on
    ``device`` -> (words, offsets, code).

    Only the code words that range reaches are staged
    (``decode_cuda.stream_window``), with its offsets rebased to them; the
    code is the stream's (``decode_cuda.stage_code``)."""
    view = dataclasses.replace(stream, block_offsets=stream.block_offsets[lo:hi],
                               block_init=None)
    window, offsets = decode_cuda.stream_window(view, block_size)
    words, _ = decode_cuda.stage_words([window], device)
    return (words, torch.from_numpy(offsets.view(np.int32)).to(device),
            decode_cuda.stage_code(stream.widths, device))


def decode_blocks_local(words, offsets, code, *, rank: int, world: int,
                        num_steps: int = 64, delta: bool = True,
                        delta2d: bool = False) -> torch.Tensor:
    """B2 on ``rank``'s range of the (n,) offset index -> (hi - lo,
    num_steps) uint8. The inputs are ``decode_cuda.decode_blocks``'s."""
    lo, hi = block_range(rank, world, offsets.numel())
    return decode_cuda.decode_blocks(
        words, offsets[lo:hi], code, num_steps=num_steps, delta=delta,
        delta2d=delta2d)


def decode_blocks_sharded(words, offsets, code, *, mesh=None,
                          num_steps: int = 64, delta: bool = True,
                          delta2d: bool = False) -> torch.Tensor:
    """Decode one stream's blocks with their ranges over the mesh's block
    axis (:func:`.mesh.axis_coords`).

    ``words`` and ``code`` are replicated, ``offsets`` is the whole (n,)
    index on every rank. Returns (n padded to a multiple of the axis,
    num_steps) uint8 in stream order on every rank; the rows past n are zero
    padding — crop them.
    """
    rank, world, group = axis_coords(mesh)
    local = decode_blocks_local(
        words, offsets, code, rank=rank, world=world, num_steps=num_steps,
        delta=delta, delta2d=delta2d)
    return gather_rows(local, offsets.numel(), group)


#: the JAX package's Pallas block decode under ``shard_map``; its jnp twin
#: (``decode_blocks_sharded``) and it are both B2 here
decode_tiles_sharded = decode_blocks_sharded


def decode_images_local(words, offsets, code, *, rank: int, world: int,
                        bw: int, delta: bool = True,
                        delta2d: bool = False) -> torch.Tensor:
    """B1 on ``rank``'s range of the block rows of a (rows, bw) grid of 8x8
    blocks (frames stacked, so a range may cross frames) -> ((hi - lo) * 8,
    bw * 8) uint8 image rows."""
    lo, hi = block_range(rank, world, offsets.numel() // bw)
    return decode_cuda.decode_images(
        words, offsets[lo * bw : hi * bw], code, num_frames=1, bh=hi - lo,
        bw=bw, delta=delta, delta2d=delta2d)[0]


def decode_tiles_images_sharded(words, offsets, code, *, bw: int, mesh=None,
                                delta: bool = True,
                                delta2d: bool = False) -> torch.Tensor:
    """Image-row decode: each rank runs B1 on its contiguous range of block
    rows and holds that horizontal slice of the frames; the gather returns
    (rows padded to a multiple of the axis * 8, bw * 8) uint8 image rows,
    frames stacked, on every rank. 1-D delta and delta2d are block-local, so
    a range needs no state from its neighbours."""
    rank, world, group = axis_coords(mesh)
    local = decode_images_local(
        words, offsets, code, rank=rank, world=world, bw=bw, delta=delta,
        delta2d=delta2d)
    rows = gather_rows(local.view(-1, 64 * bw), offsets.numel() // bw, group)
    return rows.view(-1, 8 * bw)


def decode_frames_local(frames, *, data: tuple[int, int] = (0, 1),
                        seq: tuple[int, int] = (0, 1), num_steps: int = 64,
                        delta: bool = True,
                        delta2d: bool = False) -> torch.Tensor:
    """B2 on a rank's frames and block range, each frame with its own code.

    ``frames``: one-frame stagings with ``words``, ``offsets`` and ``code``
    (``PreparedBatch.frames``), all of one block count; ``data`` and ``seq``
    are the rank's (index, size) on the frame and block axes. Returns
    (ceil(T / data size), ceil(nb / seq size), num_steps) uint8, zero past
    the rank's frames and blocks.
    """
    nb = frames[0].offsets.numel()
    f0, f1 = block_range(*data, len(frames))
    b0, b1 = block_range(*seq, nb)
    out = torch.zeros((-(-len(frames) // data[1]), -(-nb // seq[1]), num_steps),
                      dtype=torch.uint8, device=frames[0].words.device)
    for i, f in enumerate(frames[f0:f1]):
        decode_cuda.decode_blocks(
            f.words, f.offsets[b0:b1], f.code, num_steps=num_steps,
            delta=delta, delta2d=delta2d, out=out[i, : b1 - b0])
    return out


def assemble_grid(parts, layout) -> torch.Tensor:
    """Every rank's :func:`decode_frames_local` output, by rank (a sequence,
    or one (world, ...) tensor), and the (data, seq) grid of ranks ->
    (frames, blocks, steps): block ranges side by side along a grid row,
    frame ranges stacked down the grid."""
    order = [r for row in layout for r in row]
    if isinstance(parts, torch.Tensor) and order == list(range(len(order))):
        stack = parts  # the gather's own rank order is the grid's
    else:
        stack = torch.stack([parts[r] for r in order])
    d, s = len(layout), len(layout[0])
    t, nb, steps = stack.shape[1:]
    return stack.view(d, s, t, nb, steps).transpose(1, 2).reshape(
        d * t, s * nb, steps)


def gather_grid(local: torch.Tensor, n_frames: int, layout) -> torch.Tensor:
    """All-gather every rank's frames x blocks over the default group and
    assemble them -> (n_frames, blocks padded to a multiple of the seq
    axis, steps) on every rank."""
    stack = local.new_empty((dist.get_world_size(), *local.shape))
    dist.all_gather(list(stack.unbind()), local)
    return assemble_grid(stack, layout)[:n_frames]


def decode_frames_sharded(frames, *, mesh=None, num_steps: int = 64,
                          delta: bool = True,
                          delta2d: bool = False) -> torch.Tensor:
    """Decode a batch of frames, a code each, on a ``data x seq`` mesh:
    frames over ``data``, block ranges over ``seq`` (see
    :func:`decode_frames_local`). Returns (T, nb padded to a multiple of
    the seq axis, num_steps) uint8 on every rank."""
    data, seq, layout = grid_layout(mesh)
    local = decode_frames_local(frames, data=data, seq=seq,
                                num_steps=num_steps, delta=delta,
                                delta2d=delta2d)
    return gather_grid(local, len(frames), layout)
