"""Multi-process sharded decode and encode of the PyTorch / CUDA port, one
rank of a process group (counterpart of ``examples/multihost_decode.py``).

Start one process per rank, every rank with the same ``--init-method`` and
``--world-size``:

    python examples/multihost_decode_torch.py --init-method \\
        tcp://127.0.0.1:29511 --world-size 2 --rank {0,1} --device cpu

On the card every rank takes one GPU (NCCL): ``--device cuda`` pins rank
``r`` to its local GPU (``LOCAL_RANK``, else ``r`` modulo the host's GPUs),
``--device cuda:N`` to GPU N. On the CPU the ranks join a gloo group.

Each rank joins the group, encodes the same synthetic frame (the stand-in
for "the stream was broadcast"), stages only the code words of its own
block range (``multihost.shard_global_inputs``), decodes them with B2
(``decode_blocks_multihost``) and gathers every rank's blocks
(``gather_blocks``), which must equal the source blocks. Then the encode:
``encode_symbols_multihost`` on an uneven payload with a partial tail
block, each rank packing its own symbol range with ``encode_stream``, must
be byte-identical to the host encoder. Exit code 0 on success.
"""

from __future__ import annotations

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import numpy as np  # noqa: E402
import torch  # noqa: E402
import torch.distributed as dist  # noqa: E402

from metalhuffman_tpu_torch import native  # noqa: E402
from metalhuffman_tpu_torch.core import blocks  # noqa: E402
from metalhuffman_tpu_torch.parallel import mesh, multihost  # noqa: E402
from metalhuffman_tpu_torch.utils import examples  # noqa: E402


def rank_device(device: str, rank: int) -> torch.device:
    """The device rank ``rank`` pins: ``cuda`` -> its local GPU, ``cuda:N``
    -> GPU N, ``cpu`` -> the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", mesh.local_rank(rank))
    return dev


def frame() -> np.ndarray:
    """The 256x512 synthetic frame every rank encodes."""
    rng = np.random.default_rng(0)
    img = (np.add.outer(np.arange(256), np.arange(512)) % 241).astype(np.uint8)
    return (img + rng.integers(0, 7, img.shape)).astype(np.uint8)


def main(argv=None) -> dict:
    """Run one rank -> {"blocks": the gathered (n, 64) blocks, "source":
    the source blocks, "encoded": the multi-process EncodedStream, "host":
    the host encoder's}; exits 1 on a mismatch."""
    ap = examples.parser(__doc__.splitlines()[0])
    ap.add_argument("--init-method", default="tcp://127.0.0.1:29511",
                    help="the process group's rendezvous (tcp://HOST:PORT)")
    ap.add_argument("--world-size", type=int, default=1)
    ap.add_argument("--rank", type=int, default=0)
    args = ap.parse_args(argv)

    dev = rank_device(args.device, args.rank)
    pid, pcount = multihost.initialize(args.init_method, args.world_size,
                                       args.rank, device=dev)
    try:
        print(f"[p{pid}] joined: {pcount} processes, "
              f"{dist.get_backend()} on {dev}", flush=True)

        # every rank has the stream (broadcast stand-in: deterministic
        # encode)
        blk = blocks.image_to_blocks(frame())
        data = native.delta_encode(blk.ravel(), 64)
        enc = native.encode_symbols(data, 64)

        m = multihost.global_mesh(device=dev.type)
        inputs = multihost.shard_global_inputs(enc, mesh=m, device=dev)
        decoded = multihost.decode_blocks_multihost(*inputs)
        out = multihost.gather_blocks(decoded, enc.block_offsets.size,
                                      m.get_group()).cpu().numpy()
        if not np.array_equal(out, blk):
            print(f"[p{pid}] MISMATCH", flush=True)
            sys.exit(1)
        print(f"[p{pid}] bit-exact across {pcount} processes "
              f"({tuple(m.shape)}) OK", flush=True)

        # ENCODE: each rank packs its symbol range (the histogram summed
        # over the group gives every rank the table), and the runs splice
        # at their seam bytes; byte-identical to the host encoder, with a
        # partial tail block and ranges that meet at any bit phase
        payload = np.concatenate([data, data[: 64 * 5 + 13]])  # uneven+tail
        enc_mh = multihost.encode_symbols_multihost(payload, mesh=m,
                                                    device=dev)
        enc_host = native.encode_symbols(payload, 64)
        if not (np.array_equal(enc_mh.code_bytes, enc_host.code_bytes)
                and np.array_equal(enc_mh.block_offsets,
                                   enc_host.block_offsets)
                and np.array_equal(enc_mh.widths, enc_host.widths)):
            print(f"[p{pid}] ENCODE MISMATCH", flush=True)
            sys.exit(1)
        print(f"[p{pid}] encode byte-identical across {pcount} processes "
              f"({enc_host.compressed_size} B) OK", flush=True)
    finally:
        dist.destroy_process_group()
    return {"blocks": out, "source": blk, "encoded": enc_mh,
            "host": enc_host}


if __name__ == "__main__":
    main()
