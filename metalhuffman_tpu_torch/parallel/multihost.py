"""Multi-host decode and encode: every process one rank of one process group.

Counterpart of ``metalhuffman_tpu/parallel/multihost.py``. In the port one
process is always one rank, so the sharded forms are already the multi-host
ones; this module keeps the JAX package's names for them:

- decode: every rank holds the stream's offset index and code (the small
  side of the codec) and stages only the code words of its own block range
  (:func:`shard_global_inputs`); B2 decodes them there
  (:data:`decode_blocks_multihost`), and :func:`gather_blocks` fetches
  every rank's blocks in stream order;
- encode: :data:`encode_symbols_multihost` is
  :func:`.shard_encode.encode_symbols_sharded`, where each rank takes the
  histogram of the symbols it packs only and one ``all_reduce`` of the 256
  counts gives every rank the same table.
"""

from __future__ import annotations

import functools

import torch

from ..ops import decode_cuda
from .mesh import axis_coords, initialize_distributed, make_mesh, process_info
from .shard_decode import block_range, gather_rows, shard_stream_inputs
from .shard_encode import encode_symbols_sharded

#: the 1-D mesh over every rank of the process group, in rank order
global_mesh = make_mesh
#: B2 on this rank's staged range (:func:`shard_global_inputs`), with the
#: JAX package's defaults
decode_blocks_multihost = functools.partial(decode_cuda.decode_blocks,
                                            num_steps=64, delta=True)
encode_symbols_multihost = encode_symbols_sharded


def initialize(init_method: str, world_size: int, rank: int,
               device="cuda") -> tuple[int, int]:
    """Join the process group (:func:`.mesh.initialize_distributed`); returns
    (rank, world size)."""
    initialize_distributed(init_method, world_size, rank, device)
    return process_info()


def shard_global_inputs(stream, *, mesh=None, block_size: int = 64,
                        device="cuda"):
    """This rank's decode inputs: the code words and offsets of its block
    range and the stream's code, on ``device`` (see
    :func:`.shard_decode.shard_stream_inputs`)."""
    rank, world, _ = axis_coords(mesh)
    lo, hi = block_range(rank, world, stream.block_offsets.size)
    return shard_stream_inputs(stream, lo, hi, block_size, device=device)


def gather_blocks(local: torch.Tensor, n_blocks: int, group=None) -> torch.Tensor:
    """Every rank's decoded range -> the (n_blocks, steps) array in stream
    order, on every rank of ``group`` (an all-gather, cropped)."""
    return gather_rows(local, n_blocks, group)[:n_blocks]
