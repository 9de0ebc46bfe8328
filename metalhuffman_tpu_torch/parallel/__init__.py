"""Multi-GPU decode and encode over ``torch.distributed``: meshes, sharded
decode and encode, the process group's set-up.

Counterpart of ``metalhuffman_tpu/parallel``. Every block decodes alone
from its bit offset and encodes alone from its symbols, so a rank takes a
contiguous block range and runs the port's kernels on it (B1, B2 or
``encode_stream``); the code words and tables are replicated or staged per
range, and one gather puts the ranges back in stream order. Collectives run
on NCCL for CUDA tensors and on gloo for CPU tensors.
"""

from . import mesh, multihost, shard_decode, shard_encode  # noqa: F401
from .mesh import make_mesh  # noqa: F401
from .shard_decode import decode_blocks_sharded  # noqa: F401
from .shard_encode import encode_symbols_sharded  # noqa: F401
